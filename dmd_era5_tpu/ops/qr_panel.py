"""Gram products and Cholesky QR for tall-skinny panels.

**CholeskyQR2** factors a panel through its Gram matrix,

    G = A^T A (one pass over A),  R = chol(G)^T,  Q = A R^-1,

then repeats once to restore orthogonality to machine precision
(CholQR's error scales with cond(A)^2; the second pass squares it away
for cond(A) < ~1e4, which the TSQR combine guarantees for local blocks
after the first level).  The tall work is two GEMMs per pass; the
Cholesky and the triangular inverse are k x k.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from dmd_era5_tpu.ops.matmul import row_contract

__all__ = ["gram", "cholqr2", "cholqr", "cholqr2_split"]


def gram(
    a: jax.Array,
    precision: lax.Precision | str = lax.Precision.HIGHEST,
) -> jax.Array:
    """G = A^T A, (M, K) -> (K, K) f32.

    ``precision`` accepts a :class:`lax.Precision` (HIGHEST default —
    required for CholQR downstream) or the string ``"bf16_split"``: a
    hi/lo split Gram of two bf16 products (~1e-7 relative error) for
    callers whose downstream error is quadratic in the G perturbation,
    e.g. the eigh-subspace pass of the Gram-route exact SVD.
    """
    if precision == "bf16_split":
        # A = H + L (bf16 head + bf16 tail of each f32 entry):
        # A^T A ~ H^T H + H^T L + (H^T L)^T, dropping the ~2^-17 L^T L
        hi = a.astype(jnp.bfloat16)
        lo = (a - hi.astype(jnp.float32)).astype(jnp.bfloat16)
        ghl = row_contract(hi, lo)
        return row_contract(hi, hi) + ghl + ghl.T
    return row_contract(a, a, precision)


def _chol_r(g: jax.Array) -> jax.Array:
    """Upper-triangular R with positive diagonal from the Gram matrix,
    ridge-escalated so f32-singular panels stay finite
    (utils/linalg.py::safe_cholesky)."""
    from dmd_era5_tpu.utils.linalg import safe_cholesky

    return safe_cholesky(g).T


def cholqr(
    a: jax.Array,
    gram_precision: lax.Precision | str = lax.Precision.HIGHEST,
) -> tuple[jax.Array, jax.Array]:
    """Single-pass Cholesky QR: Q = A R^-1, R = chol(A^T A)^T.

    The whitening is one GEMM against the Newton-refined k x k inverse
    (utils/linalg.py::tri_inv) instead of a right-side trsm over the
    tall (M, k) panel.
    """
    from dmd_era5_tpu.utils.linalg import tri_inv

    g = gram(a, precision=gram_precision)
    r = _chol_r(g)
    q = jnp.matmul(
        a.astype(jnp.float32),
        tri_inv(r, lower=False),
        precision=lax.Precision.HIGHEST,
    )
    return q, r


def cholqr2(a: jax.Array) -> tuple[jax.Array, jax.Array]:
    """CholeskyQR2: two CholQR passes -> orthonormal Q, R = R2 R1."""
    q1, r1 = cholqr(a)
    q2, r2 = cholqr(q1)
    return q2, jnp.matmul(r2, r1, precision=lax.Precision.HIGHEST)


def cholqr2_split(a: jax.Array) -> tuple[jax.Array, jax.Array]:
    """CholeskyQR2 whose Gram products are the bf16 hi/lo split.

    The CholQR2 structure absorbs the cheaper Gram: pass-1 errors only
    perturb Q1's conditioning, which pass 2 corrects, so orthogonality
    and factorization residual land at ~1e-6.  The whitening GEMMs stay
    at HIGHEST (a TF32 whitening would leave ~1e-3 in Q).  Prefer plain
    ``cholqr2`` when the panel conditioning approaches 1/sqrt(eps_f32).
    """
    q1, r1 = cholqr(a, "bf16_split")
    q2, r2 = cholqr(q1, "bf16_split")
    return q2, jnp.matmul(r2, r1, precision=lax.Precision.HIGHEST)
