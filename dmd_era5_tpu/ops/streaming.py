"""Streaming sketch + incremental SVD over snapshot column blocks.

Two capabilities the reference lacks entirely (BASELINE.json north-star
config 5: "streaming/updating rank-k SVD + DMD forecast rollout at pod
scale"):

- :class:`StreamingSketch` — pipeline-parallel ingest: column blocks of
  the snapshot matrix stream host -> device while the sketch
  accumulator Y += X_blk @ Omega_blk updates on device.  JAX's async
  dispatch double-buffers automatically: the ``device_put`` of block
  i+1 overlaps the GEMM of block i, so transfer and compute pipeline
  (the PP analogue of SURVEY.md section 2b).
- :func:`svd_rank_update` — classic incremental SVD (Brand-style):
  append new snapshot columns to an existing truncated factorization
  without refactoring the history.  Cost is O(S k (k + c)) per update
  — S-sized work stays as skinny sharded GEMMs.
"""

from __future__ import annotations

from typing import Iterable

import jax
import jax.numpy as jnp
from jax import lax

from dmd_era5_tpu.ops.svd import SVDResult
from dmd_era5_tpu.ops.tsqr import qr_positive

HIGHEST = lax.Precision.HIGHEST

__all__ = ["StreamingSketch", "svd_rank_update"]


class StreamingSketch:
    """Accumulate Y = X @ Omega from streamed column blocks.

    Omega rows are consumed in step with the streamed columns, so the
    full time dimension never has to be resident: only the (S, r)
    accumulator and two in-flight blocks live on device.
    """

    def __init__(self, s_rows: int, omega: jax.Array, device=None):
        self.omega = jnp.asarray(omega)
        self.device = device
        self._col = 0
        self._y = None
        self._s_rows = s_rows
        self._update = jax.jit(
            lambda y, blk, om: y
            + jnp.matmul(
                blk, om,
                preferred_element_type=jnp.float32,
                precision=lax.Precision.HIGHEST,
            )
        )

    @property
    def columns_seen(self) -> int:
        return self._col

    def update(self, x_block) -> None:
        """Fold in the next (S, c) column block (host or device array)."""
        c = x_block.shape[1]
        om_block = lax.dynamic_slice_in_dim(
            self.omega, self._col, c, axis=0
        )
        blk = jax.device_put(jnp.asarray(x_block), self.device)
        if self._y is None:
            self._y = jnp.zeros(
                (self._s_rows, self.omega.shape[1]), jnp.float32
            )
            if self.device is not None:
                self._y = jax.device_put(self._y, self.device)
        # async dispatch: this returns immediately; the next host-side
        # read/device_put overlaps this GEMM
        self._y = self._update(self._y, blk, om_block)
        self._col += c

    def result(self) -> jax.Array:
        if self._y is None:
            raise ValueError("No blocks streamed")
        return self._y

    def run(self, blocks: Iterable) -> jax.Array:
        for blk in blocks:
            self.update(blk)
        return self.result()


def svd_rank_update(
    svd: SVDResult,
    new_cols: jax.Array,
    n_components: int | None = None,
) -> SVDResult:
    """Append columns to a truncated SVD (incremental / updating SVD).

    Given X ~ U diag(s) V and new snapshots C (S, c), factor
    [X, C] ~ U' diag(s') V' at the same (or given) rank:

        L = U^T C                  (project onto current basis)
        J, K = qr(C - U L)         (new directions)
        M = [[diag(s), L], [0, K]] ((k+c) x (k+c) small)
        svd(M) -> rotations applied to [U, J] and blockdiag(V, I).
    """
    u, s, v = svd.U, svd.s, svd.V
    k = s.shape[0]
    c = new_cols.shape[1]
    n_components = n_components or k

    l_proj = jnp.matmul(u.T, new_cols, precision=HIGHEST)  # (k, c)
    resid = new_cols - jnp.matmul(u, l_proj, precision=HIGHEST)
    j_dirs, k_tri = qr_positive(resid)  # (S, c), (c, c)

    top = jnp.concatenate([jnp.diag(s), l_proj], axis=1)  # (k, k+c)
    bot = jnp.concatenate(
        [jnp.zeros((c, k), s.dtype), k_tri], axis=1
    )  # (c, k+c)
    m = jnp.concatenate([top, bot], axis=0)  # (k+c, k+c)

    um, sm, vmt = jnp.linalg.svd(m, full_matrices=False)
    um = um[:, :n_components]
    sm = sm[:n_components]
    vmt = vmt[:n_components, :]

    u_new = jnp.matmul(
        jnp.concatenate([u, j_dirs], axis=1), um, precision=HIGHEST
    )
    t_old = v.shape[1]
    v_aug_top = jnp.concatenate(
        [v, jnp.zeros((k, c), v.dtype)], axis=1
    )  # (k, T+c)
    v_aug_bot = jnp.concatenate(
        [jnp.zeros((c, t_old), v.dtype), jnp.eye(c, dtype=v.dtype)], axis=1
    )
    v_new = jnp.matmul(
        vmt, jnp.concatenate([v_aug_top, v_aug_bot], axis=0),
        precision=HIGHEST,
    )
    return SVDResult(u_new, sm, v_new)
