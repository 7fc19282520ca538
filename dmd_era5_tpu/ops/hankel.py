"""Delay-embedding (Hankel) operators without materialization.

The reference materializes the full d-times-larger Hankel matrix on host
(/root/reference/src/dmd_era5/slice_tools/slice_tools.py:207-211 — the
d-fold memory blowup SURVEY.md section 7 flags as hard part c).  Here
the embedded matrix H_d(X) — row block j = X[:, j : j+T-d+1], delay
coordinate d-1-j (snapmat/transform.py layout contract) — exists only as
an operator:

- sketch    Y = H_d(X) @ Omega      : ONE pass over X.  Block j of Y is
  X[:, j:j+Tout] @ Omega = X @ (Omega zero-shifted by j), so stacking
  the d shifted copies of Omega column-wise turns the whole thing into a
  single wide GEMM X @ W, W (T, d*r) — same FLOPs as the d narrow GEMMs
  but one read of X and a wider product.
- project   B = H_d(X)^T-style projection Q^T H_d(X): one pass over X
  computing C = Q'^T X with Q' the d blocks of Q laid side by side,
  then a shifted slice-sum of the small C.
- time-sharded sketch: columns of X sharded over the ``time`` mesh axis;
  each shard contracts its local columns against the matching rows of a
  zero-padded Omega and the partial results psum over the axis — the
  sequence-parallel path (no halo needed for contractions).
- time-sharded embedding: when the embedded matrix itself is required
  blockwise, each shard builds its local block after a halo exchange of
  the d-1 boundary snapshots from its left neighbor.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from dmd_era5_tpu.parallel.collectives import (
    halo_exchange_left,
    halo_exchange_right,
)
from dmd_era5_tpu.parallel.mesh import AXIS_TIME
from dmd_era5_tpu.utils.linalg import orth_small

__all__ = [
    "hankel_sketch",
    "hankel_project",
    "stacked_sketch_matrix",
    "hankel_sketch_time_sharded",
    "delay_embed_time_sharded",
    "hankel_randomized_svd",
    "hankel_randomized_svd_fused",
    "hankel_randomized_svd_sharded",
    "hankel_randomized_svd_2d",
    "hankel_exact_svd",
]


def stacked_sketch_matrix(omega: jax.Array, d: int, t_cols: int) -> jax.Array:
    """W (T, d*r): column block j is Omega with rows shifted down by j.

    X @ W computes every delay block of H_d(X) @ Omega in one GEMM.
    """
    t_out, r = omega.shape
    assert t_out == t_cols - d + 1, (omega.shape, d, t_cols)
    blocks = []
    for j in range(d):
        blocks.append(
            jnp.pad(omega, ((j, d - 1 - j), (0, 0)))
        )  # (T, r)
    return jnp.concatenate(blocks, axis=1)  # (T, d*r)


@partial(jax.jit, static_argnames=("d",))
def _lift_delay_major(y_wide: jax.Array, lift: jax.Array, d: int) -> jax.Array:
    """U = Y lift in the delay-major row layout, f32.

    y_wide (S, d*r) holds delay block j in columns [j*r, (j+1)*r); U row
    j*S + s is y_wide[s, j*r:(j+1)*r] @ lift.  One program, so the
    reorder and the f32 conversion of a bf16 Y fuse into one copy.
    """
    s_rows, dr = y_wide.shape
    y = (
        y_wide.reshape(s_rows, d, dr // d)
        .transpose(1, 0, 2)
        .reshape(s_rows * d, dr // d)
        .astype(jnp.float32)
    )
    return jnp.matmul(
        y, lift, preferred_element_type=jnp.float32,
        precision=lax.Precision.HIGHEST,
    )


def hankel_sketch(x: jax.Array, omega: jax.Array, d: int) -> jax.Array:
    """Y = H_d(X) @ Omega, shape (S*d, r), one pass over X.

    x: (S, T); omega: (T-d+1, r).
    """
    s_rows, t_cols = x.shape
    w = stacked_sketch_matrix(omega, d, t_cols)
    y_wide = jnp.matmul(
        x, w.astype(x.dtype),
        preferred_element_type=jnp.float32,
        precision=lax.Precision.HIGHEST,
    )
    r = omega.shape[1]
    # (S, d*r) -> (d, S, r) -> (d*S, r): block j rows j*S:(j+1)*S
    return y_wide.reshape(s_rows, d, r).transpose(1, 0, 2).reshape(d * s_rows, r)


def hankel_project(q: jax.Array, x: jax.Array, d: int) -> jax.Array:
    """B = Q^T H_d(X), shape (r, T-d+1), one pass over X.

    q: (S*d, r) with delay-block row layout; x: (S, T).
    """
    sd, r = q.shape
    s_rows, t_cols = x.shape
    assert sd == s_rows * d
    t_out = t_cols - d + 1
    # Q' (S, d*r): block j side by side; C = Q'^T X  (d*r, T)
    q_wide = (
        q.reshape(d, s_rows, r).transpose(1, 0, 2).reshape(s_rows, d * r)
    )
    c = jnp.matmul(
        q_wide.T.astype(x.dtype), x,
        preferred_element_type=jnp.float32,
        precision=lax.Precision.HIGHEST,
    )  # (d*r, T)
    c = c.reshape(d, r, t_cols)
    out = jnp.zeros((r, t_out), dtype=c.dtype)
    for j in range(d):
        out = out + lax.dynamic_slice_in_dim(c[j], j, t_out, axis=1)
    return out


def hankel_randomized_svd(
    x: jax.Array,
    d: int,
    n_components: int,
    n_oversamples: int = 10,
    n_iter: int | str = "auto",
    seed: int | jax.Array = 0,
    qr_method: str | None = None,
):
    """Randomized truncated SVD of H_d(X) **without materializing it**.

    Numerically identical to ``ops.svd.randomized_svd`` applied to the
    delay-embedded matrix (same Gaussian sketch for the same seed, same
    truncation semantics and sign flip), but every H-product is computed
    through the shifted-GEMM operators above: device memory holds only
    the raw (S, T) matrix and (S*d, r)-sized factors — the d-fold
    embedded copy the reference materializes on host never exists.

    Returns an ``SVDResult`` whose U has the embedded row layout
    (delay block j at rows [j*S, (j+1)*S), delay coordinate d-1-j).
    """
    from dmd_era5_tpu.ops.svd import SVDResult, _svd_flip_v_based, sklearn_n_iter
    from dmd_era5_tpu.ops.tsqr import _local_factor, default_qr_method, qr_positive

    s_rows, t_cols = x.shape
    t_out = t_cols - d + 1
    n_random = n_components + n_oversamples
    if isinstance(n_iter, str):
        n_iter = sklearn_n_iter(n_components, (s_rows * d, t_out))
    qr_method = qr_method or default_qr_method()

    key = seed if isinstance(seed, jax.Array) else jax.random.key(seed)
    omega = jax.random.normal(key, (t_out, n_random), dtype=jnp.float32)

    y = hankel_sketch(x, omega, d)
    q, _ = _local_factor(y, qr_method)

    def body(_, q):
        z = hankel_project(q, x, d).T  # (t_out, r) == H^T Q
        z = orth_small(z)
        qn, _ = _local_factor(hankel_sketch(x, z, d), qr_method)
        return qn

    q = lax.fori_loop(0, n_iter, body, q) if n_iter > 0 else q

    b = hankel_project(q, x, d)  # (r, t_out)
    u_b, s, vt = jnp.linalg.svd(b, full_matrices=False)
    u = jnp.matmul(q, u_b, precision=lax.Precision.HIGHEST)
    u, vt = _svd_flip_v_based(u, vt)
    return SVDResult(
        u[:, :n_components], s[:n_components], vt[:n_components, :]
    )


def _hankel_rand_svd_space_body(
    x_block: jnp.ndarray,
    omega: jnp.ndarray,
    d: int,
    n_components: int,
    n_iter: int,
    axis_name: str,
    qr_method: str,
):
    """Space-sharded Hankel randomized SVD body.

    Each shard holds a row block of the raw X; its local Hankel operator
    covers those rows across ALL d delay blocks (delay shifts act on
    time, which is fully local), so the embedded matrix is row-sharded
    in an interleaved per-shard-delay-block layout.  The caller
    rearranges U to the global delay-major layout.
    """
    from dmd_era5_tpu.ops.svd import _svd_flip_v_based
    from dmd_era5_tpu.ops.tsqr import qr_positive, tsqr_orthonormalize

    def orthonormalize(y_block):
        return tsqr_orthonormalize(y_block, axis_name, qr_method)

    y = hankel_sketch(x_block, omega, d)  # (S_loc*d, r)
    q = orthonormalize(y)

    def body(_, q):
        z = lax.psum(hankel_project(q, x_block, d).T, axis_name)  # (t_out, r)
        z = orth_small(z)
        return orthonormalize(hankel_sketch(x_block, z, d))

    q = lax.fori_loop(0, n_iter, body, q) if n_iter > 0 else q

    b = lax.psum(hankel_project(q, x_block, d), axis_name)  # (r, t_out)
    u_b, s, vt = jnp.linalg.svd(b, full_matrices=False)
    u = jnp.matmul(q, u_b, precision=lax.Precision.HIGHEST)
    u, vt = _svd_flip_v_based(u, vt)
    return u[:, :n_components], s[:n_components], vt[:n_components, :]


def _hankel_rand_svd_space_fused_body(
    x_block: jnp.ndarray,
    omega: jnp.ndarray,
    d: int,
    t_cols: int,
    n_components: int,
    n_iter: int,
    axis_name: str,
    gemm_dtype,
):
    """Fused space-sharded Hankel SVD body: per shard, each power
    iteration is ONE fused pass over the local rows (wide stacked
    sketch -> y_wide + Gram + projection); only the (r, r) Gram and the
    (r, t_out) projection psum over the axis — the same
    small-factors-only pattern as the sharded fit step."""
    from dmd_era5_tpu.ops.matmul import sketch_center_gram_project
    from dmd_era5_tpu.ops.svd import _svd_flip_v_based
    from dmd_era5_tpu.ops.tsqr import qr_positive
    from dmd_era5_tpu.utils.linalg import gram_whiten

    hi = lax.Precision.HIGHEST
    t_out = t_cols - d + 1
    n_random = omega.shape[1]
    xg = x_block.astype(gemm_dtype)

    def fused_pass(z):
        w = stacked_sketch_matrix(z, d, t_cols).astype(gemm_dtype)
        y_wide, _, _, g_wide, c_wide = sketch_center_gram_project(
            xg, w, out_dtype=gemm_dtype, center=False
        )
        g = lax.psum(
            jnp.einsum(
                "jajb->ab", g_wide.reshape(d, n_random, d, n_random)
            ),
            axis_name,
        )
        c_blocks = c_wide.reshape(d, n_random, t_cols)
        c_h = jnp.zeros((n_random, t_out), jnp.float32)
        for j in range(d):
            c_h = c_h + lax.dynamic_slice_in_dim(
                c_blocks[j], j, t_out, axis=1
            )
        c_h = lax.psum(c_h, axis_name)
        inv_chol = gram_whiten(g, base_ridge=1e-6)
        b = jnp.matmul(
            inv_chol, c_h, preferred_element_type=jnp.float32, precision=hi
        )
        return y_wide, inv_chol, b

    z = omega
    for _ in range(max(int(n_iter), 0)):
        _, _, b = fused_pass(z)
        z = orth_small(b.T)  # (t_out, r) re-orthonormalized
    y_wide, inv_chol, b = fused_pass(z)

    u_b, s, vt = jnp.linalg.svd(b, full_matrices=False)
    lift = jnp.matmul(
        inv_chol.T, u_b, preferred_element_type=jnp.float32, precision=hi
    )
    u = _lift_delay_major(y_wide, lift, d)
    u, vt = _svd_flip_v_based(u, vt)
    return u[:, :n_components], s[:n_components], vt[:n_components, :]


def hankel_randomized_svd_sharded(
    x: jax.Array,
    d: int,
    n_components: int,
    mesh: Mesh,
    n_oversamples: int = 10,
    n_iter: int | str = "auto",
    seed: int | jax.Array = 0,
    axis_name: str = "space",
    qr_method: str | None = None,
    fused: bool = True,
    gemm_dtype=jnp.float32,
):
    """Space-sharded operator-form randomized SVD of H_d(X).

    x: (S, T) row-sharded over ``axis_name`` (S divisible by the axis).
    Returns an SVDResult whose U is gathered to host layout: global
    delay-major rows (block j at rows [j*S, (j+1)*S)) — identical to the
    single-device :func:`hankel_randomized_svd`.

    ``fused``: route each shard through the fused body (one X read per
    power iteration, r-sized psums — see
    :func:`hankel_randomized_svd_fused`); ``False`` takes the TSQR body.
    ``gemm_dtype`` is the fused body's GEMM input dtype (f32
    accumulation either way), set from the stage's ``precision``.
    """
    from functools import partial as _partial

    from dmd_era5_tpu.ops.svd import SVDResult, sklearn_n_iter
    from dmd_era5_tpu.ops.tsqr import default_qr_method

    s_rows, t_cols = x.shape
    t_out = t_cols - d + 1
    n_shards = mesh.shape[axis_name]
    if s_rows % n_shards:
        raise ValueError(
            f"S={s_rows} must divide the {axis_name} axis ({n_shards})"
        )
    n_random = n_components + n_oversamples
    if isinstance(n_iter, str):
        n_iter = sklearn_n_iter(n_components, (s_rows * d, t_out))
    qr_method = qr_method or default_qr_method()

    key = seed if isinstance(seed, jax.Array) else jax.random.key(seed)
    omega = jax.random.normal(key, (t_out, n_random), dtype=jnp.float32)

    if fused:
        body = _partial(
            _hankel_rand_svd_space_fused_body,
            d=d,
            t_cols=t_cols,
            n_components=n_components,
            n_iter=n_iter,
            axis_name=axis_name,
            gemm_dtype=gemm_dtype,
        )
    else:
        body = _partial(
            _hankel_rand_svd_space_body,
            d=d,
            n_components=n_components,
            n_iter=n_iter,
            axis_name=axis_name,
            qr_method=qr_method,
        )
    u_interleaved, s, vt = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis_name, None), P(None, None)),
        out_specs=(P(axis_name, None), P(None), P(None, None)),
        check_vma=False,
    )(x, omega)

    # interleaved (P, d, S_loc, k) -> global delay-major (d, P, S_loc, k)
    s_loc = s_rows // n_shards
    u = jnp.asarray(u_interleaved).reshape(n_shards, d, s_loc, -1)
    u = u.transpose(1, 0, 2, 3).reshape(d * s_rows, -1)
    return SVDResult(u, s, vt)


def hankel_randomized_svd_fused(
    x: jax.Array,
    d: int,
    n_components: int,
    n_oversamples: int = 28,
    n_iter: int | str = "auto",
    seed: int | jax.Array = 0,
    gemm_dtype=jnp.bfloat16,
):
    """Fused-kernel randomized SVD of H_d(X) — the fast single-chip path.

    Same operator-form semantics as :func:`hankel_randomized_svd` (the
    embedded matrix never exists), but each power iteration is ONE
    fused pass over X instead of ~four streaming GEMM/QR passes:
    ``ops.matmul.sketch_center_gram_project`` with the (T, d*r) stacked
    sketch returns, from a single X read,

      y_wide (S, d*r)  = X @ W          (all delay blocks of H @ Omega)
      G_wide (d*r,d*r) = y_wide^T y_wide
      C_wide (d*r, T)  = y_wide^T X

    from which the embedded quantities are pure small algebra:
    Y^T Y = sum_j of G_wide's j-th diagonal r x r block (Y is the
    blocks stacked vertically), and B = Q^T H_d(X) goes through the
    CholQR2 whitening of the fit step (Q = Y W^T never materialized)
    with the column-shifted slice-sum of C_wide.  The basis lift is one
    skinny pass over y_wide.

    Defaults are throughput-oriented: bf16 GEMMs (f32 accumulation) and
    an oversampled sketch (n_components + 28 = 128 for the standard
    k=100 — strictly better accuracy than sklearn's +10).  Set
    ``gemm_dtype=jnp.float32`` for the full-precision measurement.

    Returns an ``SVDResult`` with the same embedded row layout as
    :func:`hankel_randomized_svd`.
    """
    from dmd_era5_tpu.ops.matmul import sketch_center_gram_project
    from dmd_era5_tpu.ops.svd import (
        SVDResult,
        _svd_flip_v_based,
        sklearn_n_iter,
    )
    from dmd_era5_tpu.ops.tsqr import qr_positive
    from dmd_era5_tpu.utils.linalg import gram_whiten

    s_rows, t_cols = x.shape
    t_out = t_cols - d + 1
    n_random = n_components + n_oversamples
    if isinstance(n_iter, str):
        n_iter = sklearn_n_iter(n_components, (s_rows * d, t_out))

    key = seed if isinstance(seed, jax.Array) else jax.random.key(seed)
    omega = jax.random.normal(key, (t_out, n_random), dtype=jnp.float32)
    xg = x.astype(gemm_dtype)
    hi = lax.Precision.HIGHEST

    def fused_pass(z):
        """One X read: y_wide, Y^T Y, and B = L^-1 (Y^T H) from sketch z."""
        w = stacked_sketch_matrix(z, d, t_cols).astype(gemm_dtype)
        y_wide, _, _, g_wide, c_wide = sketch_center_gram_project(
            xg, w, out_dtype=gemm_dtype, center=False
        )
        # Y^T Y = sum of diagonal r x r blocks (Y = vertical block stack)
        g_blocks = g_wide.reshape(d, n_random, d, n_random)
        g = jnp.einsum("jajb->ab", g_blocks)
        # C_h[:, t] = sum_j C_wide[j-th block, t + j] (valid windows)
        c_blocks = c_wide.reshape(d, n_random, t_cols)
        c_h = jnp.zeros((n_random, t_out), jnp.float32)
        for j in range(d):
            c_h = c_h + lax.dynamic_slice_in_dim(
                c_blocks[j], j, t_out, axis=1
            )
        inv_chol = gram_whiten(g, base_ridge=1e-6)
        b = jnp.matmul(
            inv_chol, c_h, preferred_element_type=jnp.float32, precision=hi
        )  # (r, t_out) = Q^T H with Q = Y L^-T implicit
        return y_wide, inv_chol, b

    z = omega
    for _ in range(max(int(n_iter), 0)):
        _, _, b = fused_pass(z)
        z = orth_small(b.T)  # (t_out, r) re-orthonormalized
    y_wide, inv_chol, b = fused_pass(z)

    u_b, s, vt = jnp.linalg.svd(b, full_matrices=False)
    lift = jnp.matmul(
        inv_chol.T, u_b, preferred_element_type=jnp.float32, precision=hi
    )  # (r, r)
    # U = Q U_b = Y (L^-T U_b): one skinny pass over y_wide, in the
    # embedded (d*S, r) row layout
    u = _lift_delay_major(y_wide, lift, d)
    u, vt = _svd_flip_v_based(u, vt)
    return SVDResult(
        u[:, :n_components], s[:n_components], vt[:n_components, :]
    )


# --------------------------------------------- exact (deterministic) SVD


def _hankel_exact_svd_body(
    x_block: jnp.ndarray,
    d: int,
    t_cols: int,
    n_components: int,
    axis_name: str | None,
    gram_precision,
):
    """Shard-local exact Hankel-operator SVD: two passes over X.

    Pass 1 is the raw T x T Gram (psum over the space axis); the
    EMBEDDED Gram follows for free from the banded identity

        (H_d(X)^T H_d(X))[i, j] = sum_{b=0}^{d-1} G[i+b, j+b]

    (row block b of H is X[:, b : b+t_out], so its Gram contribution is
    the b-shifted principal submatrix of G = X^T X).  eigh of that
    t_out x t_out matrix gives the exact top right-singular subspace;
    pass 2 is ONE fused Rayleigh-Ritz pass (the stacked-shift sketch of
    :func:`hankel_randomized_svd_fused`) that restores the singular
    triplets to f32 accuracy exactly as in the d = 1 Gram route
    (ops/svd.py::_gram_route_core).
    """
    from dmd_era5_tpu.ops.matmul import sketch_center_gram_project
    from dmd_era5_tpu.ops.qr_panel import gram
    from dmd_era5_tpu.utils.linalg import gram_whiten

    hi = lax.Precision.HIGHEST
    t_out = t_cols - d + 1

    g_raw = gram(x_block, precision=gram_precision)
    if axis_name is not None:
        g_raw = lax.psum(g_raw, axis_name)

    g_h = g_raw[:t_out, :t_out]
    for b in range(1, d):  # d is static: unrolled static slices
        g_h = g_h + g_raw[b : b + t_out, b : b + t_out]

    _, vecs = jnp.linalg.eigh(g_h)  # ascending
    # subspace width rounded up to 128 (see _gram_route_core)
    k_pad = min(-(-n_components // 128) * 128, t_out)
    v_k = vecs[:, ::-1][:, :k_pad]  # (t_out, >=k) exact top subspace

    w = stacked_sketch_matrix(v_k, d, t_cols)
    _, _, _, g_wide, c_wide = sketch_center_gram_project(
        x_block, w, center=False, emit_yc=False
    )
    g_y = jnp.einsum("jajb->ab", g_wide.reshape(d, k_pad, d, k_pad))
    c_blocks = c_wide.reshape(d, k_pad, t_cols)
    c_h = jnp.zeros((k_pad, t_out), jnp.float32)
    for j in range(d):
        c_h = c_h + lax.dynamic_slice_in_dim(c_blocks[j], j, t_out, axis=1)
    if axis_name is not None:
        g_y = lax.psum(g_y, axis_name)
        c_h = lax.psum(c_h, axis_name)

    w_wh = gram_whiten(g_y, base_ridge=1e-7)
    b_rr = jnp.matmul(
        w_wh, c_h, preferred_element_type=jnp.float32, precision=hi
    )
    u_b, s, vt = jnp.linalg.svd(b_rr, full_matrices=False)
    lift = jnp.matmul(
        w_wh.T, u_b[:, :n_components],
        preferred_element_type=jnp.float32, precision=hi,
    )
    # U block j = Y_j lift = X (W_j lift): recomputed from X instead of
    # storing the (S, d*k) sketch, the largest array of the pass
    u = jnp.concatenate(
        [
            jnp.matmul(
                x_block,
                jnp.matmul(
                    w[:, j * k_pad : (j + 1) * k_pad], lift, precision=hi
                ),
                preferred_element_type=jnp.float32, precision=hi,
            )
            for j in range(d)
        ],
        axis=0,
    )
    return u, s[:n_components], vt[:n_components, :]


def hankel_exact_svd(
    x: jax.Array,
    d: int,
    n_components: int,
    mesh: Mesh | None = None,
    axis_name: str = "space",
    gram_precision="bf16_split",
):
    """Exact truncated SVD of H_d(X) — no materialization, no sketch.

    The deterministic (``svd_type="standard"``) counterpart of
    :func:`hankel_randomized_svd_fused`: replaces the reference's
    host-materialized delay embedding + ``np.linalg.svd``
    (/root/reference/src/dmd_era5/slice_tools/slice_tools.py:182-211 ->
    /root/reference/src/dmd_era5/era5_svd/era5_svd.py:251-254) with two
    streaming passes over the RAW (S, T) matrix: the embedded Gram is a
    banded shift-sum of the raw Gram, its eigh gives the exact right
    subspace, and one fused Rayleigh-Ritz pass recovers the triplets.

    U rows use the global delay-major layout (delay block j at rows
    [j*S, (j+1)*S)) matching ``apply_delay_embedding``'s contract.

    ``gram_precision`` as in :func:`ops.svd.truncated_svd` — the
    default bf16-split Gram's perturbation enters the final triplets
    quadratically.
    """
    from dmd_era5_tpu.ops.svd import SVDResult

    s_rows, t_cols = x.shape
    if mesh is None or mesh.shape.get(axis_name, 1) == 1:
        u, s, vt = _hankel_exact_svd_body(
            x, d, t_cols, n_components, None, gram_precision
        )
        return SVDResult(u, s, vt)
    n_shards = mesh.shape[axis_name]
    if s_rows % n_shards:
        raise ValueError(
            f"S={s_rows} must divide the {axis_name} axis ({n_shards})"
        )
    body = partial(
        _hankel_exact_svd_body,
        d=d,
        t_cols=t_cols,
        n_components=n_components,
        axis_name=axis_name,
        gram_precision=gram_precision,
    )
    u_il, s, vt = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(axis_name, None),),
        out_specs=(P(axis_name, None), P(None), P(None, None)),
        check_vma=False,
    )(x)
    # interleaved (P, d, S_loc, k) -> global delay-major (d, P, S_loc, k)
    s_loc = s_rows // n_shards
    u = jnp.asarray(u_il).reshape(n_shards, d, s_loc, -1)
    u = u.transpose(1, 0, 2, 3).reshape(d * s_rows, -1)
    return SVDResult(u, s, vt)


# ------------------------------------- grid-sharded (space x time) SVD


def _hankel_project_grid(
    q, x_loc, d: int, space_axis: str, time_axis: str
):
    """Local time-block of B = Q^T H_d(X) on the (space, time) grid.

    q: (d*S_loc, r) space-sharded, replicated over time.  x_loc:
    (S_loc, L) the local grid block.  The small factor C = Q'^T X is
    psum'd over space per local time block, then the column-shifted
    slice-sum Sum_j C_j[:, t+j] crosses the time-shard boundary only
    through a d-1-column right halo of the SMALL (d*r, L) factor —
    never through anything S-sized.  Returns (r, L) local columns of B
    (globally, column t is window t; trailing columns past T-d are
    invalid and trimmed by the caller).
    """
    sd, r = q.shape
    s_loc, l_cols = x_loc.shape
    assert sd == s_loc * d
    q_wide = q.reshape(d, s_loc, r).transpose(1, 0, 2).reshape(s_loc, d * r)
    c = lax.psum(
        jnp.matmul(
            q_wide.T.astype(jnp.float32), x_loc.astype(jnp.float32),
            preferred_element_type=jnp.float32,
            precision=lax.Precision.HIGHEST,
        ),
        space_axis,
    )  # (d*r, L)
    ch = halo_exchange_right(c, time_axis, halo=d - 1, axis=1) if d > 1 else c
    ch = ch.reshape(d, r, l_cols + d - 1)
    out = jnp.zeros((r, l_cols), dtype=ch.dtype)
    for j in range(d):
        out = out + lax.dynamic_slice_in_dim(ch[j], j, l_cols, axis=1)
    return out


def _hankel_rand_svd_2d_body(
    x_loc: jnp.ndarray,
    omega_pad: jnp.ndarray,
    d: int,
    t_out: int,
    n_components: int,
    n_iter: int,
    space_axis: str,
    time_axis: str,
    qr_method: str,
):
    """Grid-sharded operator-form randomized SVD body.

    x_loc: (S_loc, L) — rows sharded over ``space``, columns over
    ``time``.  omega_pad: (T_pad + d - 1, r) replicated, the sketch
    zero-padded so every shard can slice its own shifted segment (rows
    past the valid t_out windows are zero).  The embedded matrix H_d(X)
    never exists anywhere: sketches contract local columns against
    shifted Omega segments (psum over time), orthonormalization is TSQR
    over space on the (d*S_loc, r) sketch, and projections move only
    (d*r)-row small factors plus a d-1-column halo.
    """
    from dmd_era5_tpu.ops.svd import _svd_flip_v_based
    from dmd_era5_tpu.ops.tsqr import qr_positive, tsqr_orthonormalize

    t_pad = omega_pad.shape[0] - (d - 1)

    def sketch(om_pad):
        y = _sketch_time_body(x_loc, om_pad, d=d, axis_name=time_axis)
        return y  # (d*S_loc, r), psum'd over time inside

    def project(q):
        b_loc = _hankel_project_grid(q, x_loc, d, space_axis, time_axis)
        b = lax.all_gather(b_loc, time_axis, axis=1, tiled=True)  # (r, T_pad)
        return b[:, :t_out]  # windows past T-d are invalid/padding

    def pad_z(z):
        # (t_out, r) -> (T_pad + d - 1, r) with the sketch's row layout
        return jnp.pad(z, ((d - 1, t_pad - t_out), (0, 0)))

    q = tsqr_orthonormalize(sketch(omega_pad), space_axis, qr_method)

    def body(_, q):
        z = orth_small(project(q).T)  # (t_out, r)
        y = sketch(pad_z(z))
        return tsqr_orthonormalize(y, space_axis, qr_method)

    q = lax.fori_loop(0, n_iter, body, q) if n_iter > 0 else q

    b = project(q)  # (r, t_out) replicated
    u_b, s, vt = jnp.linalg.svd(b, full_matrices=False)
    u = jnp.matmul(q, u_b, precision=lax.Precision.HIGHEST)
    u, vt = _svd_flip_v_based(u, vt)
    return u[:, :n_components], s[:n_components], vt[:n_components, :]


def hankel_randomized_svd_2d(
    x: jax.Array,
    d: int,
    n_components: int,
    mesh: Mesh,
    t_valid: int | None = None,
    n_oversamples: int = 10,
    n_iter: int | str = "auto",
    seed: int | jax.Array = 0,
    space_axis: str = "space",
    time_axis: str = AXIS_TIME,
    qr_method: str | None = None,
):
    """Grid-sharded randomized SVD of H_d(X) — the SP production path.

    x: (S, T_pad) sharded (space, time) — long time ranges never
    resident on one device, and the d-fold embedded matrix never exists
    on host OR device (vs the reference's host materialization at
    /root/reference/src/dmd_era5/slice_tools/slice_tools.py:207-211).
    ``t_valid``: the true number of snapshot columns when the time axis
    was zero-padded up to the mesh (default: all of them).  Zero-padded
    rows are neutral (zero rows of every delay block); padded columns
    are excluded by zero rows in the padded sketch and by trimming the
    projection to the valid t_out windows.

    Returns an SVDResult with U in global delay-major layout
    (block j at rows [j*S, (j+1)*S)), s and V replicated;
    V has t_valid - d + 1 columns.
    """
    from dmd_era5_tpu.ops.svd import SVDResult, sklearn_n_iter
    from dmd_era5_tpu.ops.tsqr import default_qr_method

    s_rows, t_pad = x.shape
    t_valid = t_pad if t_valid is None else t_valid
    t_out = t_valid - d + 1
    n_space = mesh.shape[space_axis]
    n_time = mesh.shape[time_axis]
    if s_rows % n_space or t_pad % n_time:
        raise ValueError(
            f"x {x.shape} must divide the ({space_axis},{time_axis}) "
            f"axes ({n_space},{n_time}); pad first"
        )
    n_random = n_components + n_oversamples
    if isinstance(n_iter, str):
        n_iter = sklearn_n_iter(n_components, (s_rows * d, t_out))
    qr_method = qr_method or default_qr_method()

    key = seed if isinstance(seed, jax.Array) else jax.random.key(seed)
    omega = jax.random.normal(key, (t_out, n_random), dtype=jnp.float32)
    # sketch rows for invalid/padded windows are zero; d-1 leading zeros
    # give every shard a sliceable segment (see _sketch_time_body)
    omega_pad = jnp.pad(omega, ((d - 1, t_pad - t_out), (0, 0)))

    body = partial(
        _hankel_rand_svd_2d_body,
        d=d,
        t_out=t_out,
        n_components=n_components,
        n_iter=n_iter,
        space_axis=space_axis,
        time_axis=time_axis,
        qr_method=qr_method,
    )
    u_interleaved, s, vt = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(space_axis, time_axis), P(None, None)),
        out_specs=(P(space_axis, None), P(None), P(None, None)),
        check_vma=False,
    )(x, omega_pad)

    # interleaved (P, d, S_loc, k) -> global delay-major (d, P, S_loc, k)
    s_loc = s_rows // n_space
    u = jnp.asarray(u_interleaved).reshape(n_space, d, s_loc, -1)
    u = u.transpose(1, 0, 2, 3).reshape(d * s_rows, -1)
    return SVDResult(u, s, vt)


# ------------------------------------------------ time-sharded variants


def _sketch_time_body(x_loc, omega_pad, d: int, axis_name: str):
    """Shard-local contribution to H_d(X) @ Omega over local columns."""
    s_rows, l_cols = x_loc.shape
    r = omega_pad.shape[1]
    idx = lax.axis_index(axis_name)
    c0 = idx * l_cols
    # rows of the padded Omega this shard can touch: [c0, c0 + L + d - 1)
    seg = lax.dynamic_slice_in_dim(omega_pad, c0, l_cols + d - 1, axis=0)
    ys = []
    for j in range(d):
        wj = lax.dynamic_slice_in_dim(seg, d - 1 - j, l_cols, axis=0)
        ys.append(
            jnp.matmul(x_loc, wj.astype(x_loc.dtype),
                       precision=lax.Precision.HIGHEST,
                       preferred_element_type=jnp.float32)
        )
    y = jnp.concatenate(ys, axis=0)  # (d*S, r)
    return lax.psum(y, axis_name)


def hankel_sketch_time_sharded(
    x: jax.Array,
    omega: jax.Array,
    d: int,
    mesh: Mesh,
    axis_name: str = AXIS_TIME,
) -> jax.Array:
    """Y = H_d(X) @ Omega with X column-sharded over the time axis.

    The sequence-parallel sketch: each shard multiplies its local column
    block against the matching rows of Omega (zero-padded at both ends
    by d-1), partials all-reduce over the axis.  Replicated (S*d, r) output.
    """
    t_out, _ = omega.shape
    omega_pad = jnp.pad(omega.astype(jnp.float32), ((d - 1, d - 1), (0, 0)))
    body = partial(_sketch_time_body, d=d, axis_name=axis_name)
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(None, axis_name), P(None, None)),
        out_specs=P(None, None),
        check_vma=False,
    )(x, omega_pad)


def _embed_time_body(x_loc, d: int, axis_name: str):
    """Local embedded block after halo exchange.

    Local output column t (labeled by the shard's own time t) stacks
    X[:, t-d+1 .. t] — block j holds the snapshot delayed by d-1-j,
    matching the global layout (snapmat/transform.py).
    """
    xh = halo_exchange_left(x_loc, axis_name, halo=d - 1, axis=1)
    l_cols = x_loc.shape[1]
    blocks = [
        lax.dynamic_slice_in_dim(xh, j, l_cols, axis=1) for j in range(d)
    ]
    return jnp.concatenate(blocks, axis=0)  # (d*S, L)


def delay_embed_time_sharded(
    x: jax.Array, d: int, mesh: Mesh, axis_name: str = AXIS_TIME
) -> jax.Array:
    """Blockwise delay embedding over time shards with halo exchange.

    Returns (S*d, T): column t holds the window ending at time t.  The
    first d-1 global columns are boundary-invalid (the reference trims
    them; callers slice ``[:, d-1:]`` after gathering or keep the
    sharded layout and mask).
    """
    if d == 1:
        return x
    body = partial(_embed_time_body, d=d, axis_name=axis_name)
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=P(None, axis_name),
        out_specs=P(None, axis_name),
    )(x)
