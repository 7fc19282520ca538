"""Distributed truncated SVD: exact (TSQR route) and randomized sketch.

The replacement for the reference's two decomposition branches
(/root/reference/src/dmd_era5/era5_svd/era5_svd.py:230-263):

- "standard": ``np.linalg.svd(X, full_matrices=False)`` truncated to k
  becomes TSQR of the row-sharded snapshot matrix followed by a small
  replicated SVD of the T x T R factor — exact up to roundoff, with all
  S-proportional work sharded and only O(P * T^2) communication.
- "randomized": sklearn's ``randomized_svd`` becomes a sharded Gaussian
  sketch Y = X @ Omega, power iterations with TSQR re-orthonormalization,
  and a small replicated SVD of B = Q^T X.  Truncation semantics (k of
  k + n_oversamples columns kept, n_iter='auto' rule, final sign flip)
  follow sklearn; bit-exact RNG equality is impossible by construction
  (different generators), so parity is verified via subspace angles and
  reconstruction error (SURVEY.md section 7, hard part e).

All S-sized GEMMs accept bfloat16 inputs with float32 accumulation;
accuracy-critical small factors stay float32 with HIGHEST precision.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from dmd_era5_tpu.ops.tsqr import (
    _local_factor,
    default_qr_method,
    qr_positive,
    tsqr,
    tsqr_orthonormalize,
)
from dmd_era5_tpu.parallel.mesh import AXIS_SPACE
from dmd_era5_tpu.utils.linalg import orth_small

__all__ = [
    "SVDResult",
    "exact_truncated_svd",
    "exact_truncated_svd_gram",
    "randomized_svd",
    "randomized_svd_2d",
    "truncated_svd",
    "sklearn_n_iter",
]

HIGHEST = lax.Precision.HIGHEST


class SVDResult(NamedTuple):
    """U (S, k) sharded like the input; s (k,) and V (k, T) replicated."""

    U: jax.Array
    s: jax.Array
    V: jax.Array


def _svd_flip_v_based(U: jnp.ndarray, V: jnp.ndarray):
    """Deterministic signs via the max-|.| entry of each right singular
    vector (sklearn's ``svd_flip(u_based_decision=False)``), applied by
    the randomized path like sklearn's ``flip_sign=True`` default."""
    max_idx = jnp.argmax(jnp.abs(V), axis=1)
    signs = jnp.sign(V[jnp.arange(V.shape[0]), max_idx])
    signs = jnp.where(signs == 0, 1.0, signs).astype(V.dtype)
    return U * signs[None, :], V * signs[:, None]


def sklearn_n_iter(n_components: int, shape: tuple[int, int]) -> int:
    """sklearn's n_iter='auto' rule: 7 if k < 0.1 * min(shape) else 4."""
    return 7 if n_components < 0.1 * min(shape) else 4


# ---------------------------------------------------------------- exact


def exact_truncated_svd(
    x: jax.Array,
    n_components: int,
    mesh: Mesh | None = None,
    axis_name: str = AXIS_SPACE,
) -> SVDResult:
    """Exact truncated SVD of a tall row-sharded (S, T) matrix.

    TSQR gives X = Q R with R (T, T) replicated; the SVD of R is computed
    redundantly on every device (T is the snapshot count — small next to
    S), and U = Q @ U_R is one sharded skinny GEMM.
    """
    q, r = tsqr(x, mesh=mesh, axis_name=axis_name)
    u_r, s, vt = jnp.linalg.svd(r, full_matrices=False)
    u_r = u_r[:, :n_components]
    # HIGHEST: the lift of an exact SVD; a TF32 product would cap U at
    # ~1e-3 accuracy
    u = jnp.matmul(q, u_r, precision=HIGHEST)
    return SVDResult(u, s[:n_components], vt[:n_components, :])


def _gram_route_core(
    x_block: jnp.ndarray,
    n_components: int,
    axis_name: str | None,
    gram_precision: lax.Precision | str = HIGHEST,
):
    """Shard-local body of the Gram-route exact SVD (T << S fast path).

    Three streaming passes over the local rows instead of the TSQR
    route's panel QR chain:

    1. G = X^T X (one X read; psum over the space axis gives the T x T
       Gram replicated).
    2. eigh(G) -> exact top-k right subspace V_k; then ONE fused pass
       (ops.matmul.sketch_center_gram_project, centering off) computes
       y = X V_k, its Gram G_y AND the projection C = y^T X from a
       single X read.
    3. CholQR2 whitening of y from G_y (utils.linalg.gram_whiten) makes
       Q = y W^T orthonormal without materializing it; the Rayleigh-Ritz
       factor B = Q^T X = W C is small, its replicated SVD restores the
       singular values to f32 accuracy (sqrt(eigh) alone would floor at
       sqrt(eps) * sigma_1 — the classic squared-conditioning loss), and
       the lift U = y (W^T U_b) is one skinny pass.

    Replaces the reference's ``np.linalg.svd`` branch
    (/root/reference/src/dmd_era5/era5_svd/era5_svd.py:251-254) for the
    tall-skinny shapes ERA5 produces.
    """
    from dmd_era5_tpu.ops.matmul import sketch_center_gram_project
    from dmd_era5_tpu.ops.qr_panel import gram
    from dmd_era5_tpu.utils.linalg import gram_whiten

    t_cols = x_block.shape[1]
    g = _psum_or_id(gram(x_block, precision=gram_precision), axis_name)
    _, vecs = jnp.linalg.eigh(g)  # ascending eigenvalues
    # subspace width: the top-k eigenvectors rounded up to a multiple of
    # 128 (the extra exact eigenvectors only widen the Rayleigh-Ritz
    # space — the final SVD truncates back to k)
    k_pad = min(-(-n_components // 128) * 128, t_cols)
    v_k = vecs[:, ::-1][:, :k_pad]  # (T, >=k) exact top subspace

    y, _, _, g_y, c = sketch_center_gram_project(x_block, v_k, center=False)
    g_y = _psum_or_id(g_y, axis_name)
    c = _psum_or_id(c, axis_name)

    w = gram_whiten(g_y, base_ridge=1e-7)
    b = jnp.matmul(w, c, preferred_element_type=jnp.float32, precision=HIGHEST)
    u_b, s, vt = jnp.linalg.svd(b, full_matrices=False)
    u_b = u_b[:, :n_components]
    s = s[:n_components]
    vt = vt[:n_components, :]
    u = jnp.matmul(
        y,
        jnp.matmul(w.T, u_b, preferred_element_type=jnp.float32, precision=HIGHEST),
        preferred_element_type=jnp.float32,
        precision=HIGHEST,
    )
    return u, s, vt


def exact_truncated_svd_gram(
    x: jax.Array,
    n_components: int,
    mesh: Mesh | None = None,
    axis_name: str = AXIS_SPACE,
    gram_precision: lax.Precision | str = HIGHEST,
) -> SVDResult:
    """Exact truncated SVD via the T x T Gram matrix (T << S fast path).

    Numerically: the top-k subspace comes from eigh of the exact f32
    Gram and the singular triplets from a Rayleigh-Ritz SVD through an
    orthonormalized basis, so accuracy matches the TSQR route down to
    the sqrt(eps)-conditioned tail; throughput is ~3 streaming passes
    over X with no tall QR.  Prefer TSQR (:func:`exact_truncated_svd`)
    when cond(X) is extreme or T is not small against S.
    """
    if mesh is None or mesh.shape.get(axis_name, 1) == 1:
        u, s, vt = _gram_route_core(
            x, n_components, None, gram_precision=gram_precision
        )
        return SVDResult(u, s, vt)
    body = partial(
        _gram_route_core,
        n_components=n_components,
        axis_name=axis_name,
        gram_precision=gram_precision,
    )
    u, s, vt = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis_name, None),),
        out_specs=(P(axis_name, None), P(None), P(None, None)),
        check_vma=False,
    )(x)
    return SVDResult(u, s, vt)


# ------------------------------------------------------------ randomized


def _psum_or_id(x, axis_name: str | None):
    return x if axis_name is None else lax.psum(x, axis_name)


def _rand_svd_core(
    x_block: jnp.ndarray,
    omega: jnp.ndarray,
    n_components: int,
    n_iter: int,
    axis_name: str | None,
    gemm_dtype: jnp.dtype,
    qr_method: str,
):
    """Shard-local body of the randomized SVD; ``axis_name`` is None for
    the single-device path.

    x_block: (S_loc, T) local rows.  omega: (T, r) replicated.
    """

    def big_gemm(a, b):
        # S-proportional GEMM: bf16-in / f32-out when requested.
        return jnp.matmul(
            a.astype(gemm_dtype),
            b.astype(gemm_dtype),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )

    def orthonormalize(y_block):
        # TSQR re-orth: local factor -> tree-reduced R combine (ops.tsqr).
        if axis_name is None:
            q1, _ = _local_factor(y_block, qr_method)
            return q1
        return tsqr_orthonormalize(y_block, axis_name, qr_method)

    # Sketch
    y = big_gemm(x_block, omega)  # (S_loc, r)
    q = orthonormalize(y)

    # Power iterations with re-orthonormalization each half-step
    def body(_, q):
        z = _psum_or_id(big_gemm(x_block.T, q), axis_name)  # (T, r) replicated
        z = orth_small(z)  # intermediate re-orth: Gram whitening, not QR
        return orthonormalize(big_gemm(x_block, z))

    q = lax.fori_loop(0, n_iter, body, q) if n_iter > 0 else q

    # Project: B = Q^T X  (r, T), replicated via psum
    b = _psum_or_id(
        jnp.matmul(q.T, x_block, precision=HIGHEST), axis_name
    )
    u_b, s, vt = jnp.linalg.svd(b, full_matrices=False)
    u = jnp.matmul(q, u_b, precision=HIGHEST)
    u, vt = _svd_flip_v_based(u, vt)
    return u[:, :n_components], s[:n_components], vt[:n_components, :]


def randomized_svd(
    x: jax.Array,
    n_components: int,
    n_oversamples: int = 10,
    n_iter: int | str = "auto",
    seed: int | jax.Array = 0,
    mesh: Mesh | None = None,
    axis_name: str = AXIS_SPACE,
    gemm_dtype: jnp.dtype = jnp.float32,
    qr_method: str | None = None,
) -> SVDResult:
    """Randomized truncated SVD of a row-sharded (S, T) matrix.

    Semantics follow ``sklearn.utils.extmath.randomized_svd`` (the
    reference's randomized branch, era5_svd.py:258): Gaussian test
    matrix of k + n_oversamples columns, n_iter='auto' rule, truncation
    to k, and v-based deterministic sign flip.
    """
    s_rows, t_cols = x.shape
    n_random = n_components + n_oversamples
    if isinstance(n_iter, str):
        n_iter = sklearn_n_iter(n_components, (s_rows, t_cols))

    key = seed if isinstance(seed, jax.Array) else jax.random.key(seed)
    omega = jax.random.normal(key, (t_cols, n_random), dtype=jnp.float32)

    qr_method = qr_method or default_qr_method()
    if mesh is None or mesh.shape.get(axis_name, 1) == 1:
        u, s, vt = _rand_svd_core(
            x, omega, n_components, n_iter, None, gemm_dtype, qr_method
        )
        return SVDResult(u, s, vt)

    body = partial(
        _rand_svd_core,
        n_components=n_components,
        n_iter=n_iter,
        axis_name=axis_name,
        gemm_dtype=gemm_dtype,
        qr_method=qr_method,
    )
    # check_vma=False: s and V are computed redundantly from psum-shared
    # small factors (replicated in fact, unprovable statically).
    u, s, vt = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis_name, None), P(None, None)),
        out_specs=(P(axis_name, None), P(None), P(None, None)),
        check_vma=False,
    )(x, omega)
    return SVDResult(u, s, vt)


# --------------------------------------------------- 2D (space x time)


def _rand_svd_2d_body(
    x_block: jnp.ndarray,
    omega_block: jnp.ndarray,
    n_components: int,
    n_iter: int,
    space_axis: str,
    time_axis: str,
    gemm_dtype: jnp.dtype,
    qr_method: str,
):
    """Grid-sharded randomized SVD body: x (S_loc, T_loc) per device.

    Communication pattern per step: the sketch contracts the sharded
    time dim (psum over time), orthonormalization gathers small R
    factors over space, the transposed products psum over space, and the
    k-sized iterates (T x r and r x T both fit trivially) are gathered
    over time and kept replicated.
    """

    def big_gemm(a, b):
        return jnp.matmul(
            a.astype(gemm_dtype),
            b.astype(gemm_dtype),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )

    def orthonormalize_space(y_block):
        return tsqr_orthonormalize(y_block, space_axis, qr_method)

    t_loc = x_block.shape[1]

    # sketch: contract local time cols against the matching Omega rows
    y = lax.psum(big_gemm(x_block, omega_block), time_axis)  # (S_loc, r)
    q = orthonormalize_space(y)

    def body(_, q):
        # z = X^T q: rows = local time block, psum over space
        z_loc = lax.psum(big_gemm(x_block.T, q), space_axis)  # (T_loc, r)
        z_full = lax.all_gather(z_loc, time_axis, axis=0, tiled=True)
        z_full = orth_small(z_full)  # (T, r) replicated (Gram re-orth)
        idx = lax.axis_index(time_axis)
        z_mine = lax.dynamic_slice_in_dim(z_full, idx * t_loc, t_loc, axis=0)
        y = lax.psum(big_gemm(x_block, z_mine), time_axis)
        return orthonormalize_space(y)

    q = lax.fori_loop(0, n_iter, body, q) if n_iter > 0 else q

    # b = Q^T X: (r, T_loc) per time shard, psum over space, gather time
    b_loc = lax.psum(
        jnp.matmul(q.T, x_block, precision=HIGHEST), space_axis
    )
    b = lax.all_gather(b_loc, time_axis, axis=1, tiled=True)  # (r, T)
    u_b, s, vt = jnp.linalg.svd(b, full_matrices=False)
    u = jnp.matmul(q, u_b, precision=HIGHEST)
    u, vt = _svd_flip_v_based(u, vt)
    return u[:, :n_components], s[:n_components], vt[:n_components, :]


def randomized_svd_2d(
    x: jax.Array,
    n_components: int,
    mesh: Mesh,
    n_oversamples: int = 10,
    n_iter: int | str = "auto",
    seed: int | jax.Array = 0,
    space_axis: str = AXIS_SPACE,
    time_axis: str = "time",
    gemm_dtype: jnp.dtype = jnp.float32,
    qr_method: str | None = None,
) -> SVDResult:
    """Randomized SVD of a (space, time) **grid-sharded** matrix.

    The general production layout: rows sharded over the ``space`` mesh
    axis (TP) *and* columns over ``time`` (SP) simultaneously — long
    time ranges never need to be resident on one device.  Returns U
    space-sharded, s replicated, V replicated.
    """
    s_rows, t_cols = x.shape
    n_random = n_components + n_oversamples
    if isinstance(n_iter, str):
        n_iter = sklearn_n_iter(n_components, (s_rows, t_cols))
    qr_method = qr_method or default_qr_method()

    key = seed if isinstance(seed, jax.Array) else jax.random.key(seed)
    omega = jax.random.normal(key, (t_cols, n_random), dtype=jnp.float32)

    body = partial(
        _rand_svd_2d_body,
        n_components=n_components,
        n_iter=n_iter,
        space_axis=space_axis,
        time_axis=time_axis,
        gemm_dtype=gemm_dtype,
        qr_method=qr_method,
    )
    u, s, vt = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(space_axis, time_axis), P(time_axis, None)),
        out_specs=(P(space_axis, None), P(None), P(None, None)),
        check_vma=False,
    )(x, omega)
    return SVDResult(u, s, vt)


# ------------------------------------------------------------ dispatcher


def truncated_svd(
    x: jax.Array,
    n_components: int,
    svd_type: str = "standard",
    mesh: Mesh | None = None,
    axis_name: str = AXIS_SPACE,
    seed: int = 0,
    gemm_dtype: jnp.dtype = jnp.float32,
    exact_method: str = "auto",
    gram_precision: lax.Precision | str = "bf16_split",
) -> SVDResult:
    """Dispatch matching ``svd_on_era5`` semantics (era5_svd.py:230-263).

    ``exact_method`` picks the standard-path algorithm: ``auto`` takes
    the Gram route when the matrix is decisively tall-skinny (the ERA5
    regime) and TSQR otherwise; ``gram`` / ``tsqr`` force one.

    ``gram_precision`` controls the Gram route's pass-1 product.  The
    default is the two-product bf16 ``"bf16_split"`` Gram: its ~1e-6
    Gram perturbation enters the final triplets quadratically through
    the widened Rayleigh-Ritz space (tests/test_25_linalg.py pins the
    Gram route at f32 accuracy with it).  Pass ``lax.Precision.HIGHEST``
    for the full-f32 Gram.
    """
    if svd_type == "standard":
        s_rows, t_cols = x.shape
        method = exact_method
        if method == "auto":
            method = (
                "gram" if (t_cols <= 4096 and s_rows >= 4 * t_cols) else "tsqr"
            )
        if method == "gram":
            return exact_truncated_svd_gram(
                x,
                n_components,
                mesh=mesh,
                axis_name=axis_name,
                gram_precision=gram_precision,
            )
        return exact_truncated_svd(x, n_components, mesh=mesh, axis_name=axis_name)
    if svd_type == "randomized":
        return randomized_svd(
            x,
            n_components,
            mesh=mesh,
            axis_name=axis_name,
            seed=seed,
            gemm_dtype=gemm_dtype,
        )
    raise ValueError(f"SVD type {svd_type} is not supported.")
