"""Typed wrappers over the XLA collective vocabulary.

For use inside ``shard_map`` bodies.  These exist so the linear-algebra
ops read as communication-explicit algorithms (psum / all-gather /
all-to-all / ring-permute) rather than a scatter of lax calls — the
replacement for the reference's absent NCCL/MPI layer
(SURVEY.md section 2b, "Distributed communication backend").  Every
wrapper here has a production caller; reduce-scatter was removed for
lack of one (all reductions in this engine produce SMALL replicated
factors — r x r Grams, T x T R-factors — where scattering saves
nothing and costs a re-gather).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def psum(x, axis_name: str):
    """Sum across a mesh axis."""
    return lax.psum(x, axis_name)


def pmean(x, axis_name: str):
    return lax.pmean(x, axis_name)


def all_gather(x, axis_name: str, axis: int = 0, tiled: bool = False):
    """Gather shards along a new (or tiled) leading axis."""
    return lax.all_gather(x, axis_name, axis=axis, tiled=tiled)


def axis_index(axis_name: str):
    return lax.axis_index(axis_name)


def axis_size(axis_name: str) -> int:
    return lax.axis_size(axis_name)


def ring_permute(x, axis_name: str, shift: int = 1):
    """Send the local block to the neighbor ``shift`` steps along the ring.

    The building block for halo exchange (delay embedding across time
    shards) and ring-streamed sketch GEMMs.
    """
    n = lax.axis_size(axis_name)
    perm = [(i, (i + shift) % n) for i in range(n)]
    return lax.ppermute(x, axis_name, perm)


def all_to_all(x, axis_name: str, split_axis: int, concat_axis: int):
    """Ulysses-style reshard between sharded layouts."""
    return lax.all_to_all(
        x, axis_name, split_axis=split_axis, concat_axis=concat_axis, tiled=True
    )


def halo_exchange_right(x, axis_name: str, halo: int, axis: int = -1):
    """Fetch the first ``halo`` slices from the right neighbor, appended.

    The dual of :func:`halo_exchange_left`: the time-sharded Hankel
    *projection* sums column-shifted small factors, so a shard's output
    columns need the first d-1 columns of its right neighbor's factor
    block.  The last shard receives zeros (its halo region corresponds
    to past-the-end windows the caller trims).
    """
    axis = axis % x.ndim
    head = lax.slice_in_dim(x, 0, halo, axis=axis)
    received = ring_permute(head, axis_name, shift=-1)
    idx = lax.axis_index(axis_name)
    n = lax.axis_size(axis_name)
    received = jnp.where(idx == n - 1, jnp.zeros_like(received), received)
    return lax.concatenate([x, received], dimension=axis)


def halo_exchange_left(x, axis_name: str, halo: int, axis: int = -1):
    """Fetch the last ``halo`` slices from the left neighbor, prepended.

    Used by the blockwise delay embedding: a time-shard needs the final
    d-1 snapshots of its left neighbor to build its own embedded columns
    without materializing the global matrix.  The first shard receives
    zeros (its halo region is trimmed by the caller).
    """
    axis = axis % x.ndim
    tail = lax.slice_in_dim(x, x.shape[axis] - halo, x.shape[axis], axis=axis)
    received = ring_permute(tail, axis_name, shift=1)
    idx = lax.axis_index(axis_name)
    received = jnp.where(idx == 0, jnp.zeros_like(received), received)
    return lax.concatenate([received, x], dimension=axis)
