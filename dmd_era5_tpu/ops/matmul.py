"""The fused ingest pass of the fit step, in plain XLA.

``sketch_center_gram_project`` returns, for a snapshot block X and a
sketch matrix W, everything the fit step and the Gram-route SVDs read
from X:

    Yc = (X - mu 1^T) W = X W - mu (1^T W)      (centered sketch)
    G  = Yc^T Yc,   C = Yc^T X                  (from the STORED Yc)

plus the row statistics the loss needs (see pipeline/train_step.py for
the algebra).  XLA lowers the products to cuBLAS GEMMs and fuses the
centering epilogue and the row reductions; the one-read bound of this
pass (X read once, Yc written once) is the target for a hand-written
kernel (ROADMAP).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = ["sketch_center_gram_project", "row_contract"]


def _precision(*dtypes):
    """``HIGHEST`` (full f32, no TF32) unless every operand is bf16.

    A bf16 x bf16 product with f32 accumulation is already exact for the
    stored values, so it takes ``DEFAULT``; an f32 operand would
    otherwise run in TF32 (~1e-3), which breaks the whitening algebra.
    """
    if all(jnp.dtype(d) == jnp.bfloat16 for d in dtypes):
        return jax.lax.Precision.DEFAULT
    return jax.lax.Precision.HIGHEST


# rows per partial product of a contraction over the row axis
_ROW_BLOCK = 2048


def _row_block(m: int) -> int:
    """Rows per partial: m itself when small, else a divisor of m in
    [_ROW_BLOCK / 2, _ROW_BLOCK] (no padding copy), else ``_ROW_BLOCK``
    (zero padding)."""
    if m <= 2 * _ROW_BLOCK:
        return m
    for blk in range(_ROW_BLOCK, _ROW_BLOCK // 2 - 1, -1):
        if m % blk == 0:
            return blk
    return _ROW_BLOCK


def row_contract(a: jax.Array, b: jax.Array, precision=None) -> jax.Array:
    """a^T b (contracting the row axis), f32, as a sum of row-block partials.

    The GPU's tensor cores drop low bits as they accumulate, so a bf16
    product's error grows with the number of rows each output sums in
    one chain: a bf16 Gram over 2^20 rows measured 5.9e-5 relative error
    on an H100 (700 W), the same in 16384-row blocks, against ~5e-7 on
    the CPU and 4e-6 for f32 at HIGHEST.  Partial products over blocks
    of at most 2048 rows, summed in f32, bound that error.  Zero padding
    rows are exact no-ops.
    """
    if a.dtype != b.dtype:
        a, b = a.astype(jnp.float32), b.astype(jnp.float32)
    if precision is None:
        precision = _precision(a.dtype, b.dtype)
    m = a.shape[0]
    blk = _row_block(m)
    if blk == m:
        return jax.lax.dot_general(
            a, b, (((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32, precision=precision,
        )
    pad = -m % blk
    if pad:
        a = jnp.pad(a, ((0, pad), (0, 0)))
        b = jnp.pad(b, ((0, pad), (0, 0)))
    nb = (m + pad) // blk
    parts = jax.lax.dot_general(
        a.reshape(nb, blk, a.shape[1]), b.reshape(nb, blk, b.shape[1]),
        (((1,), (1,)), ((0,), (0,))),
        preferred_element_type=jnp.float32, precision=precision,
    )
    # the barrier keeps XLA from folding the sum back into one dot over
    # every row (its algebraic simplifier rewrites reduce(batched dot))
    return jnp.sum(jax.lax.optimization_barrier(parts), axis=0)


@functools.partial(
    jax.jit,
    static_argnames=(
        "out_dtype", "center", "stats_col", "scalar_stats", "t_valid",
        "emit_yc",
    ),
)
def sketch_center_gram_project(
    x: jax.Array,
    w: jax.Array,
    out_dtype=jnp.float32,
    center: bool = True,
    stats_col: bool = False,
    scalar_stats: bool = False,
    t_valid: int | None = None,
    emit_yc: bool = True,
):
    """(Yc, rowsum, rowsumsq, G, C) of X against the sketch W.

    x: (M, K); w: (K, N).  Returns (Yc (M, N) out_dtype, rowsum (M,)
    f32, rowsumsq (M,) f32, G (N, N) f32, C (N, K) f32).

    ``out_dtype`` sets the storage dtype of Yc.  G and C are ALWAYS
    computed from the stored (possibly bf16-quantized) Yc, so chol(G)
    whitens exactly what the projection and lift passes read back.

    ``center=False`` skips the rank-1 mean correction (Y = X W raw) —
    used by the exact Gram-route SVD whose input is pre-centered.

    ``stats_col=True`` REPLACES the last column of w with ones, so the
    row sum is the last column of the pre-centering sketch; the
    centered sketch's last column is then zero to roundoff, which the
    downstream whitening treats as a dead direction (ridge).  Callers
    keep their oversampling margin by budgeting N >= k + 11.

    ``scalar_stats=True`` replaces the two (M,) stats vectors with the
    two SCALARS the fit step consumes: sum(rowsum^2) and sum(rowsumsq).

    ``emit_yc=False`` returns None for Yc (the memory-lean fit path,
    pipeline/train_step.py::fit_step_lean, needs only G, C and stats).

    ``t_valid``: the trailing ``K - t_valid`` columns of x are ZERO
    padding.  Zero columns are exact no-ops for every product here;
    only the centering divisor uses the true column count.
    """
    if stats_col:
        w = w.at[:, -1].set(1.0)
        if t_valid is not None:
            # the padded rows of w pair with zero columns of x, but they
            # enter colw = sum(w): zero them so colw[-1] == t_valid and
            # the stats column of Yc dies exactly
            w = w.at[t_valid:, -1].set(0.0)
    t_true = t_valid if t_valid is not None else x.shape[1]
    y = jnp.matmul(
        x, w, preferred_element_type=jnp.float32,
        precision=_precision(x.dtype, w.dtype),
    )
    x32 = x.astype(jnp.float32)
    rs = y[:, -1] if stats_col else jnp.sum(x32, axis=1)
    ssq = jnp.sum(x32 * x32, axis=1)
    colw = jnp.sum(w.astype(jnp.float32), axis=0)  # (N,)
    if center:
        y = y - (rs / t_true)[:, None] * colw[None, :]
    yc = y.astype(out_dtype)
    g = row_contract(yc, yc)
    c = row_contract(yc, x)
    yc_out = yc if emit_yc else None
    if scalar_stats:
        return yc_out, jnp.sum(rs * rs), jnp.sum(ssq), g, c
    return yc_out, rs, ssq, g, c
