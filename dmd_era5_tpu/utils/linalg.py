"""Linear-algebra helpers for the small replicated factors.

The solvers avoid an on-device nonsymmetric eigendecomposition and
complex LU (the first target had neither; whether the GPU still needs
the detour is ROADMAP A6/C6), so:

- :func:`eig_host` routes the tiny replicated r x r eigenproblem through
  a host callback (numpy LAPACK).  r is the DMD rank — tens to a couple
  hundred — so the host round trip is nanoseconds next to the sharded
  GEMMs around it.
- :func:`complex_solve` / :func:`complex_lstsq` reformulate complex
  linear solves as real block systems ([[Ar, -Ai], [Ai, Ar]]), which XLA
  handles with its native real LU on any backend, and which remain
  differentiable for the variable-projection Jacobians.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "eig_host",
    "complex_solve",
    "complex_lstsq",
    "lstsq_implicit",
    "spd_solve",
    "tri_inv",
    "safe_cholesky",
    "gram_whiten",
]


def safe_cholesky(
    g: jax.Array, base_ridge: float = 1e-7, fallback_ridge: float = 1e-3
) -> jax.Array:
    """Cholesky of a (batched) PSD Gram matrix with ridge escalation.

    An f32-singular Gram (cond > ~1e7 — routine for CholQR on
    ill-conditioned panels, since cond(G) = cond(A)^2) makes
    ``cholesky`` hit a negative pivot and return NaN.  Factor with a
    tiny ridge first; where that NaNs, substitute the factor of a
    strongly-ridged copy — the panel loses orthogonality there, which
    CholQR2-style re-orthonormalization passes restore.  Both factors
    are k x k — negligible next to the S-sized streaming passes.
    """
    k = g.shape[-1]
    scale = jnp.maximum(
        jnp.trace(g, axis1=-2, axis2=-1) / k, 1e-30
    )[..., None, None]
    eye = jnp.eye(k, dtype=g.dtype)
    l_tight = jnp.linalg.cholesky(g + base_ridge * scale * eye)
    l_loose = jnp.linalg.cholesky(g + fallback_ridge * scale * eye)
    bad = jnp.any(
        ~jnp.isfinite(l_tight), axis=(-2, -1), keepdims=True
    )
    return jnp.where(bad, l_loose, l_tight)


def tri_inv(t: jax.Array, lower: bool = True, refine: int = 2) -> jax.Array:
    """Inverse of a (batched) triangular factor, Newton-refined.

    A triangular solve whose products run at reduced matmul precision
    leaves percent-level error on a cond ~1e3 Cholesky factor, which
    silently destroys CholQR whitening on
    ill-conditioned sketches (the reference's np.linalg path at
    /root/reference/src/dmd_era5/era5_svd/era5_svd.py:251 has no such
    failure mode, so we must not either).  Each Newton step
    Z <- Z + Z(I - T Z) squares the residual with two small
    HIGHEST-precision GEMMs; two steps take 1e-2 -> f32 roundoff.
    """
    n = t.shape[-1]
    eye = jnp.eye(n, dtype=t.dtype)

    def solve(rhs):
        return jax.lax.linalg.triangular_solve(
            t, rhs, lower=lower, left_side=True
        )

    z = solve(jnp.broadcast_to(eye, t.shape))
    # Iterative refinement (NOT Newton: Newton needs ||I - T Z|| < 1,
    # which the trsm seed misses whenever cond(T) >~ 1/trsm_error and
    # then diverges to overflow).  Each re-solve of the residual
    # contracts the error by the trsm's own relative error — a fixed
    # factor independent of cond(T).
    for _ in range(refine):
        resid = eye - jnp.matmul(
            t, z, precision=jax.lax.Precision.HIGHEST
        )
        z = z + solve(resid)
    return z


def gram_whiten(g: jax.Array, base_ridge: float = 1e-6) -> jax.Array:
    """Two-pass CholQR whitener from a (batched) Gram matrix G = Y^T Y.

    Returns W (k, k, lower-triangular-ish) such that Q = Y W^T is
    orthonormal to roundoff — including the trailing directions a
    SINGLE Cholesky whitening gets wrong whenever cond(G) exceeds
    1/eps or the stabilizing ridge exceeds sigma_min(G) (both routine
    for randomized sketches of rank-deficient snapshot matrices).

    The second pass is the CholQR2 correction done WHOLLY in the small
    space: M = L1^-1 G L1^-T is the exact Gram of the once-whitened
    basis (computable from G alone — no second pass over Y), so
    W = L2^-1 L1^-1 with L2 = chol(M) whitens Y at the cost of three
    k x k GEMMs and two small factorizations.  cond(M) ~ 1 +
    ridge/sigma_min(G), so the second factorization is benign.
    """
    hi = jax.lax.Precision.HIGHEST
    k = g.shape[-1]
    l1 = safe_cholesky(g, base_ridge=base_ridge)
    w1 = tri_inv(l1)
    m = jnp.matmul(
        jnp.matmul(w1, g, precision=hi),
        jnp.swapaxes(w1, -1, -2),
        precision=hi,
    )
    # Past cond(G) ~ 1/eps the f32 Gram no longer carries the trailing
    # subspace, and the computed M can go INDEFINITE (lambda_min of
    # -0.38 observed at cond 2e10) — its Cholesky then NaNs.  A global
    # PSD-izing shift is no fix: it rescales the well-resolved
    # directions too (chol(M + s I) shrinks every singular value by
    # ~1/sqrt(1+s)).  Instead fall back to W1 alone (pre-correction
    # behavior) exactly where the second factor is not finitely
    # computable; the second pass then only ever refines.
    m = 0.5 * (m + jnp.swapaxes(m, -1, -2))
    eye = jnp.eye(k, dtype=m.dtype)
    l2 = safe_cholesky(m, base_ridge=base_ridge)
    w2 = tri_inv(l2)
    bad = jnp.any(~jnp.isfinite(w2), axis=(-2, -1), keepdims=True)
    w2 = jnp.where(bad, eye, w2)
    return jnp.matmul(w2, w1, precision=hi)


def orth_small(z: jax.Array, base_ridge: float = 1e-6) -> jax.Array:
    """Orthonormalize a tall matrix via Gram whitening — GEMM work.

    The intermediate re-orthonormalization of subspace/power iterations:
    Q = Z W^T with W = :func:`gram_whiten`(Z^T Z) is two small GEMMs +
    k x k factorizations, where a Householder QR is a sequential sweep.  Subspace-exact; orthogonality
    at CholQR2 quality — the conventional trade for *intermediate*
    normalizers (sklearn's randomized_svd uses LU there); keep a true
    QR where an R factor or backward-stable basis is required.
    """
    hi = jax.lax.Precision.HIGHEST
    g = jnp.matmul(
        jnp.swapaxes(z, -1, -2), z, preferred_element_type=jnp.float32,
        precision=hi,
    )
    w = gram_whiten(g, base_ridge=base_ridge)
    return jnp.matmul(
        z, jnp.swapaxes(w, -1, -2), preferred_element_type=jnp.float32,
        precision=hi,
    )


def eig_host(a: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Eigendecomposition of a small replicated matrix via host callback.

    Returns (eigenvalues, eigenvectors) as complex64, ordered by
    descending |eigenvalue| for determinism.
    """
    n = a.shape[-1]

    def _eig(host_a):
        w, v = np.linalg.eig(np.asarray(host_a, dtype=np.complex64))
        order = np.argsort(-np.abs(w), kind="stable")
        w = w[..., order].astype(np.complex64)
        v = v[..., :, order].astype(np.complex64)
        # return real/imag stacked: complex arrays are built on device
        # from real parts, never transferred
        return (
            np.stack([w.real, w.imag], -1).astype(np.float32),
            np.stack([v.real, v.imag], -1).astype(np.float32),
        )

    if not isinstance(a, jax.core.Tracer):
        # Eager path: call LAPACK directly and return HOST complex
        # arrays (no complex device transfer; pure_callback on a
        # mesh-committed array also trips GSPMD->Shardy).
        w2, v2 = _eig(jax.device_get(a))
        return (
            w2[..., 0] + 1j * w2[..., 1],
            v2[..., 0] + 1j * v2[..., 1],
        )

    result_shape = (
        jax.ShapeDtypeStruct(a.shape[:-2] + (n, 2), jnp.float32),
        jax.ShapeDtypeStruct(a.shape + (2,), jnp.float32),
    )
    w2, v2 = jax.pure_callback(_eig, result_shape, a)
    return (
        w2[..., 0] + 1j * w2[..., 1],
        v2[..., 0] + 1j * v2[..., 1],
    )


def _to_real_block(a: jax.Array) -> jax.Array:
    """(n, m) complex -> (2n, 2m) real block matrix."""
    ar, ai = jnp.real(a), jnp.imag(a)
    top = jnp.concatenate([ar, -ai], axis=-1)
    bot = jnp.concatenate([ai, ar], axis=-1)
    return jnp.concatenate([top, bot], axis=-2)


def spd_solve(a: jax.Array, b: jax.Array) -> jax.Array:
    """Solve A X = B for symmetric positive-definite A, GEMM-based.

    For the SPD systems this package solves — normal-equation Grams
    and LM-damped J^T J — Cholesky plus the refinement-corrected
    triangular inverse (:func:`tri_inv`) turns the solve into GEMMs:
    X = W^T (W B) with W = L^-1, instead of LU + triangular sweeps.
    """
    hi = jax.lax.Precision.HIGHEST
    w = tri_inv(jnp.linalg.cholesky(a))
    y = jnp.matmul(w, b, precision=hi)
    return jnp.matmul(jnp.swapaxes(w, -1, -2), y, precision=hi)


def complex_solve(a: jax.Array, b: jax.Array, hpd: bool = False) -> jax.Array:
    """Solve A X = B for complex square A via the real block system.

    ``hpd=True`` asserts A is Hermitian positive-definite (its real
    block form is then symmetric PD) and takes the GEMM-based
    :func:`spd_solve` instead of an LU.
    """
    n = a.shape[-1]
    b2 = jnp.concatenate([jnp.real(b), jnp.imag(b)], axis=-2)
    ab = _to_real_block(a)
    x2 = spd_solve(ab, b2) if hpd else jnp.linalg.solve(ab, b2)
    return x2[..., :n, :] + 1j * x2[..., n:, :]


def complex_lstsq(
    a: jax.Array, b: jax.Array, rcond_ridge: float = 0.0
) -> jax.Array:
    """Least-squares solve min ||A X - B|| for complex tall A.

    Uses the normal equations with an optional tiny ridge — adequate for
    the well-conditioned Vandermonde-ish systems of variable projection
    (the basis is re-conditioned by the caller), and differentiable on
    all backends.
    """
    hi = jax.lax.Precision.HIGHEST
    # HIGHEST: a default-precision f32 matmul may run in TF32 (~1e-3
    # relative error) and this Gram is numerically load-bearing for the
    # varpro amplitude fit (the optDMD residual check).
    ah = jnp.conjugate(jnp.swapaxes(a, -1, -2))
    gram = jnp.matmul(ah, a, precision=hi)
    if rcond_ridge:
        eye = jnp.eye(gram.shape[-1], dtype=gram.dtype)
        gram = gram + rcond_ridge * eye
    rhs = jnp.matmul(ah, b if b.ndim == a.ndim else b[..., None], precision=hi)
    x = complex_solve(gram, rhs, hpd=True)
    return x if b.ndim == a.ndim else x[..., 0]


# ---- custom-derivative least squares for variable projection ----------
#
# The varpro residual differentiates through B(Phi) = argmin ||Phi B - H||
# thousands of times (2r forward passes per LM step).  Instead of letting
# autodiff retrace the Cholesky/solve chain, define the derivative by
# implicit differentiation of the normal equations
#
#     G X = A^H B,  G = A^H A + rho I
#  => G dX = dA^H B + A^H dB - (dA^H A + A^H dA) X,
#
# which reuses the primal Gram matrix G for the tangent solve — one extra
# small solve per tangent instead of re-deriving the factorization.  The
# rule is real-linear in (dA, conj(dA)), which is exactly what JAX's
# non-holomorphic JVP semantics require.


@functools.partial(jax.custom_jvp, nondiff_argnums=(2,))
def lstsq_implicit(a: jax.Array, b: jax.Array, ridge: float = 0.0) -> jax.Array:
    """Least-squares solve with an implicit-differentiation JVP rule."""
    return complex_lstsq(a, b, rcond_ridge=ridge)


@lstsq_implicit.defjvp
def _lstsq_implicit_jvp(ridge, primals, tangents):
    a, b = primals
    da, db = tangents
    hi = jax.lax.Precision.HIGHEST
    ah = jnp.conjugate(jnp.swapaxes(a, -1, -2))
    gram = jnp.matmul(ah, a, precision=hi)
    if ridge:
        gram = gram + ridge * jnp.eye(gram.shape[-1], dtype=gram.dtype)
    squeeze = b.ndim != a.ndim
    b2 = b[..., None] if squeeze else b
    x = complex_solve(gram, jnp.matmul(ah, b2, precision=hi), hpd=True)

    da = jnp.zeros_like(a) if isinstance(da, jax.custom_derivatives.SymbolicZero) else da
    db = jnp.zeros_like(b) if isinstance(db, jax.custom_derivatives.SymbolicZero) else db
    db2 = db[..., None] if squeeze else db
    dah = jnp.conjugate(jnp.swapaxes(da, -1, -2))
    rhs = (
        jnp.matmul(dah, b2, precision=hi)
        + jnp.matmul(ah, db2, precision=hi)
        - jnp.matmul(dah, jnp.matmul(a, x, precision=hi), precision=hi)
        - jnp.matmul(ah, jnp.matmul(da, x, precision=hi), precision=hi)
    )
    dx = complex_solve(gram, rhs, hpd=True)
    if squeeze:
        return x[..., 0], dx[..., 0]
    return x, dx
