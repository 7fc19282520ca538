"""Comm-pattern regression guards (weak-scaling proxy on the CPU mesh).

Wall-clock weak scaling cannot be measured on a virtual mesh (the N
"devices" share the same physical cores, so growing total work N-fold
grows wall time N-fold by construction; see BASELINE.md).  What a
virtual mesh CAN pin down deterministically is the COMMUNICATION
STRUCTURE of the compiled program — the thing that actually decides
host->pod efficiency on hardware.  These tests compile the production
steps over the 8-device mesh and assert every collective moves only
small replicated factors (r x r Grams, r x T projections, T x T
R-factors), never S-sized operands.  A regression that re-gathers rows
(the O(P) patterns review r1 flagged) fails here before it ever costs
pod time.
"""

from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np

from dmd_era5_tpu.parallel import make_mesh, shard_rows
from dmd_era5_tpu.pipeline.train_step import example_batch, make_fit_step

# matches e.g. "f32[128,512]{1,0} all-reduce(" / "all-gather(" /
# "collective-permute(" result shapes in optimized HLO text
_COLLECTIVE_RE = re.compile(
    r"=\s*\w+\[([0-9,]*)\][^=]*?\b"
    r"(all-reduce|all-gather|all-to-all|reduce-scatter|collective-permute)\b"
)


def _collective_shapes(hlo_text: str) -> list[tuple[str, int]]:
    out = []
    for m in _COLLECTIVE_RE.finditer(hlo_text):
        dims = [int(d) for d in m.group(1).split(",") if d]
        size = int(np.prod(dims)) if dims else 1
        out.append((m.group(2), size))
    return out


def test_fit_step_collectives_are_small():
    """The sharded fused fit step must psum only r-sized factors: with
    S_loc rows per shard, any collective whose payload is within an
    order of magnitude of S_loc x r is a resharding bug."""
    mesh = make_mesh("data=2,space=4")
    B, S, T, r, k = 2, 2048, 64, 16, 8
    step = make_fit_step(mesh, n_components=k)
    x, omega = example_batch(B, S, T, r)
    hlo = (
        jax.jit(step)
        .lower(x, omega)
        .compile()
        .as_text()
    )
    shapes = _collective_shapes(hlo)
    assert shapes, "expected collectives in the 8-device fit step"
    # biggest legitimate payload: the (B_loc, r, T) projection psum
    bound = (B // 2) * r * T
    offenders = [(op, n) for op, n in shapes if n > bound]
    assert not offenders, (
        f"S-sized collective payloads found: {offenders} (bound {bound})"
    )


def test_tsqr_collectives_are_small():
    """Tree TSQR at P=8: log P pairwise R exchanges, nothing S-sized."""
    from dmd_era5_tpu.ops.tsqr import tsqr

    mesh = make_mesh()
    S, T = 4096, 32
    x = np.random.default_rng(0).standard_normal((S, T)).astype(np.float32)
    xs, _ = shard_rows(x, mesh)
    hlo = (
        jax.jit(lambda a: tsqr(a, mesh))
        .lower(xs)
        .compile()
        .as_text()
    )
    shapes = _collective_shapes(hlo)
    assert shapes, "expected collectives in distributed TSQR"
    bound = 2 * T * T  # a pairwise (2rk, T) merge stack
    offenders = [(op, n) for op, n in shapes if n > bound]
    assert not offenders, (
        f"TSQR moved more than R-factor payloads: {offenders} (bound {bound})"
    )


def test_hankel_2d_collectives_are_small():
    """The grid-sharded Hankel-operator SVD (the SP production path):
    the only payload allowed to scale with local rows is the intrinsic
    sketch reduce-over-time of the (d*S_loc, r) partial — the SP
    analogue of ring attention's activation movement.  Everything else
    (projection factors, halos, R-merges) must be small; in particular
    nothing may ever move the (d*S_loc, T)-sized embedded block."""
    from dmd_era5_tpu.ops.hankel import hankel_randomized_svd_2d

    mesh = make_mesh("space=2,time=4")
    S, T, d, k = 2048, 64, 3, 8
    x = np.random.default_rng(2).standard_normal((S, T)).astype(np.float32)
    xs = jax.device_put(
        x, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("space", "time"))
    )
    hlo = (
        jax.jit(lambda a: hankel_randomized_svd_2d(a, d, k, mesh))
        .lower(xs)
        .compile()
        .as_text()
    )
    shapes = _collective_shapes(hlo)
    assert shapes
    r = k + 10
    bound = d * (S // 2) * r  # the sketch partial psum, nothing bigger
    offenders = [(op, n) for op, n in shapes if n > bound]
    assert not offenders, (
        f"hankel-2d moved embedded-matrix-sized payloads: {offenders} "
        f"(bound {bound})"
    )


def test_grid2d_randomized_svd_collectives_are_small():
    """randomized_svd_2d over the (space x time) grid: sketch partials
    reduce over time at (S_loc, r); small factors otherwise."""
    from dmd_era5_tpu.ops.svd import randomized_svd_2d

    mesh = make_mesh("space=2,time=4")
    S, T, k = 2048, 64, 8
    x = np.random.default_rng(3).standard_normal((S, T)).astype(np.float32)
    xs = jax.device_put(
        x, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("space", "time"))
    )
    hlo = (
        jax.jit(lambda a: randomized_svd_2d(a, k, mesh))
        .lower(xs)
        .compile()
        .as_text()
    )
    shapes = _collective_shapes(hlo)
    assert shapes
    r = k + 10
    bound = (S // 2) * r
    offenders = [(op, n) for op, n in shapes if n > bound]
    assert not offenders, (
        f"grid2d SVD moved S-sized payloads: {offenders} (bound {bound})"
    )


def test_exact_svd_collectives_are_small():
    """The production exact path (multi-host inmem route compiles this
    same program): TSQR R-merges plus the replicated small SVD; no
    collective may move X-sized operands."""
    from dmd_era5_tpu.ops.svd import truncated_svd

    mesh = make_mesh()
    S, T, k = 4096, 32, 8
    x = np.random.default_rng(4).standard_normal((S, T)).astype(np.float32)
    xs, _ = shard_rows(x, mesh)
    hlo = (
        jax.jit(
            lambda a: truncated_svd(a, k, svd_type="standard", mesh=mesh)
        )
        .lower(xs)
        .compile()
        .as_text()
    )
    shapes = _collective_shapes(hlo)
    assert shapes
    bound = 2 * T * T
    offenders = [(op, n) for op, n in shapes if n > bound]
    assert not offenders, (
        f"exact SVD moved more than R-factor payloads: {offenders} (bound {bound})"
    )


def test_randomized_svd_collectives_are_small():
    """The production randomized SVD: sketch + power iterations +
    projection over 8 space shards, all comm r- or T-sized."""
    from dmd_era5_tpu.ops.svd import randomized_svd

    mesh = make_mesh()
    S, T, k = 4096, 64, 8
    x = np.random.default_rng(1).standard_normal((S, T)).astype(np.float32)
    xs, _ = shard_rows(x, mesh)
    hlo = (
        jax.jit(lambda a: randomized_svd(a, k, mesh=mesh))
        .lower(xs)
        .compile()
        .as_text()
    )
    shapes = _collective_shapes(hlo)
    assert shapes
    r = k + 10
    bound = max(2 * r * T, 4 * r * r)
    offenders = [(op, n) for op, n in shapes if n > bound]
    assert not offenders, (
        f"randomized SVD moved S-sized payloads: {offenders} (bound {bound})"
    )


def test_hybrid_mesh_fit_step_collectives_are_small():
    """Multislice layout (data on DCN, space on ICI): the compiled step
    must still move only small factors — and nothing S-sized may ride
    the (slow) data axis, whose only legitimate traffic is the scalar
    loss psum."""
    from dmd_era5_tpu.parallel import make_hybrid_mesh

    mesh = make_hybrid_mesh(dcn_shape="data=2", n_slices=2)
    B, S, T, r, k = 2, 2048, 64, 16, 8
    step = make_fit_step(mesh, n_components=k)
    x, omega = example_batch(B, S, T, r)
    hlo = jax.jit(step).lower(x, omega).compile().as_text()
    shapes = _collective_shapes(hlo)
    assert shapes, "expected collectives in the hybrid-mesh fit step"
    bound = (B // 2) * r * T
    offenders = [(op, n) for op, n in shapes if n > bound]
    assert not offenders, (
        f"S-sized collective payloads found: {offenders} (bound {bound})"
    )


def test_hankel_sharded_fused_collectives_are_small():
    """Fused space-sharded Hankel SVD: only the (r, r) Gram and the
    (r, t_out) projection may cross shards — never y_wide or U."""
    from dmd_era5_tpu.ops.hankel import hankel_randomized_svd_sharded
    from dmd_era5_tpu.parallel import shard_rows

    mesh = make_mesh()
    d, S, T, k = 3, 1024, 48, 6
    x = np.random.default_rng(0).standard_normal((S, T)).astype(np.float32)
    xs, _ = shard_rows(x, mesh)
    fn = jax.jit(
        lambda xs: hankel_randomized_svd_sharded(
            xs, d, k, mesh, n_oversamples=10, fused=True
        ).s
    )
    hlo = fn.lower(xs).compile().as_text()
    shapes = _collective_shapes(hlo)
    assert shapes, "expected collectives in the sharded fused hankel SVD"
    r = k + 10
    bound = r * (T - d + 1)  # the projection psum
    offenders = [(op, n) for op, n in shapes if n > bound]
    assert not offenders, (
        f"S-sized collective payloads found: {offenders} (bound {bound})"
    )


def test_hankel_exact_sharded_collectives_are_small():
    """Exact Hankel-operator SVD, space-sharded: only the (T, T) raw
    Gram, the (r, r) subspace Gram and the (r, t_out) projection may
    cross shards — never y_wide or U (S-sized)."""
    from dmd_era5_tpu.ops.hankel import hankel_exact_svd
    from dmd_era5_tpu.parallel import shard_rows

    mesh = make_mesh()
    d, S, T, k = 3, 1024, 48, 6
    x = np.random.default_rng(0).standard_normal((S, T)).astype(np.float32)
    xs, _ = shard_rows(x, mesh)
    fn = jax.jit(
        lambda xs: hankel_exact_svd(xs, d, k, mesh=mesh, axis_name="space").s
    )
    hlo = fn.lower(xs).compile().as_text()
    shapes = _collective_shapes(hlo)
    assert shapes, "expected collectives in the sharded exact hankel SVD"
    bound = T * T  # the raw-Gram psum dominates the small factors
    offenders = [(op, n) for op, n in shapes if n > bound]
    assert not offenders, (
        f"S-sized collective payloads found: {offenders} (bound {bound})"
    )
