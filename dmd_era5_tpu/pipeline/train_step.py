"""The flagship fused fit step: preprocess -> sketch SVD -> reduced DMD.

This is the engine's "training step" — one end-to-end decomposition
update over a batch of snapshot matrices, written as a single jittable
function over a (data, space, time) mesh:

- ``data``  axis: independent decompositions (per-variable / per-window
  fits) — the DP/EP analogue (SURVEY.md section 2b).
- ``space`` axis: row-sharding of each snapshot matrix — the TP
  workhorse; sketch GEMMs contract locally, Gram products psum here.
- ``time``  axis: column-sharding for long time ranges — the SP/CP
  analogue; time reductions (means, sketch contractions) psum here.

HBM-bandwidth design (the throughput is memory-bound, not FLOP-bound):
the mean-centered matrix Xc = X - mu 1^T is **never materialized**.
Centering commutes with every product as a rank-1 correction —

    Xc Omega = X Omega - mu (1^T Omega)
    Q^T Xc   = Q^T X   - (Q^T mu) 1^T

— so the big GEMMs read raw X exactly twice and everything else is
k-sized.  The reconstruction loss also needs no S-sized GEMM: with
Z = S_k V_k^T = Ub_k^T B and U orthonormal,

    ||Xc - U Z||^2 = ||Xc||^2 - ||Z||^2,
    ||Xc||^2 = ||X||^2 - T ||mu||^2.

Everything is expressed with sharding constraints and jnp ops so GSPMD
places the collectives (all-reduce for the contracted axes); the small
k-sized factors are explicitly replicated.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dmd_era5_tpu.parallel.mesh import AXIS_DATA, AXIS_SPACE, AXIS_TIME
from dmd_era5_tpu.utils.linalg import gram_whiten, spd_solve

HIGHEST = lax.Precision.HIGHEST

__all__ = [
    "FitState",
    "fit_step",
    "fit_step_fused",
    "fit_step_lean",
    "fit_ingest_pass",
    "fit_reduce_lift",
    "make_fit_step",
    "example_batch",
]


class FitState(NamedTuple):
    """Result of one decomposition step (per batch entry).

    u:      (B, S, k) POD basis
    s:      (B, k) singular values
    v:      (B, k, T) right factors
    a_red:  (B, k, k) reduced one-step operator (DMD generator)
    loss:   () mean relative reconstruction error across the batch
    """

    u: jax.Array
    s: jax.Array
    v: jax.Array
    a_red: jax.Array
    loss: jax.Array


def _f32(x):
    return x.astype(jnp.float32)


def fit_step(
    x: jax.Array,
    omega: jax.Array,
    mesh: Mesh,
    n_components: int,
    gemm_dtype=jnp.float32,
) -> FitState:
    """One fused decomposition step on a (B, S, T) snapshot batch.

    x is laid out (data, space, time) on the mesh; omega is the (T, r)
    Gaussian sketch, replicated.  x may be float32 or bfloat16 — the
    GEMMs run in ``gemm_dtype`` with float32 accumulation either way.

    Dispatch depends on the mesh's ``time`` axis alone: when it is
    unsharded, each shard's rows are complete, so the fused ingest pass
    (ops.matmul.sketch_center_gram_project) runs per shard inside
    ``shard_map`` with a psum of the small G/C factors — the same X
    reads as the single-device :func:`fit_step_fused`.  A sharded time
    axis breaks the in-pass centering (row means need a cross-shard
    reduction before Yc exists), so that case takes the portable GSPMD
    path where XLA places the time-axis collectives.
    """
    if mesh.shape.get(AXIS_TIME, 1) == 1:
        return _fit_step_fused_sharded(
            x, omega, mesh, n_components, gemm_dtype
        )
    return _fit_step_portable(x, omega, mesh, n_components, gemm_dtype)


def _fit_step_fused_sharded(
    x: jax.Array,
    omega: jax.Array,
    mesh: Mesh,
    n_components: int,
    gemm_dtype=jnp.float32,
) -> FitState:
    """shard_map fit step over (data, space): per-shard fused ingest.

    Per (data, space) shard: one fully-fused sketch+center+Gram+project
    pass over the local X rows (ops.matmul.sketch_center_gram_project),
    then a psum of the r x r Gram over ``space``, a psum of the r x T
    projection over ``space``, and replicated small algebra — identical
    math to :func:`fit_step_fused`, with only O(r^2 + rT) bytes on the
    wire and ONE local X read per step.
    """
    from dmd_era5_tpu.ops.matmul import sketch_center_gram_project

    t_cols = x.shape[-1]

    def body(x_loc: jax.Array, omega_rep: jax.Array) -> FitState:
        om = omega_rep.astype(gemm_dtype)

        def pass1(xb):
            return sketch_center_gram_project(
                xb.astype(gemm_dtype), om, out_dtype=gemm_dtype
            )

        # vmap over the local batch entries (the ingest pass is 2D)
        y, row_sum, row_sumsq, gram, c = jax.vmap(pass1)(x_loc)
        gram = lax.psum(gram, AXIS_SPACE)  # (B_loc, r, r) replicated
        c = lax.psum(c, AXIS_SPACE)  # (B_loc, r, T) replicated

        mu = row_sum / t_cols  # (B_loc, S_loc) — rows are shard-local
        sq_norm_xc = lax.psum(
            jnp.sum(row_sumsq, axis=-1)
            - t_cols * jnp.sum(jnp.square(mu), axis=-1),
            AXIS_SPACE,
        )  # (B_loc,)

        # two-pass whitener (utils.linalg.gram_whiten): orthonormal Q
        # even past cond(G) ~ 1/eps, at r x r cost only
        inv_chol = gram_whiten(gram, base_ridge=1e-6)  # (B_loc, r, r)

        c_mu = jnp.sum(c, axis=-1) / t_cols  # (B_loc, r)
        b_small = jnp.einsum(
            "bqr,brt->bqt",
            inv_chol,
            c - c_mu[..., None],
            preferred_element_type=jnp.float32,
            precision=HIGHEST,
        )

        ub, s, vt = jnp.linalg.svd(b_small, full_matrices=False)
        ub = ub[..., :n_components]
        s = s[..., :n_components]
        vt = vt[..., :n_components, :]
        lift = jnp.einsum(
            "brq,brk->bqk",
            inv_chol,
            ub,
            preferred_element_type=jnp.float32,
            precision=HIGHEST,
        )  # (B_loc, r, k) == L^-T Ub
        u = jnp.einsum(
            "bsr,brk->bsk",
            y.astype(jnp.float32),
            lift,
            preferred_element_type=jnp.float32,
            precision=HIGHEST,
        )

        z = s[..., :, None] * vt
        z1, z2 = z[..., :-1], z[..., 1:]
        g1 = jnp.einsum("bkt,bjt->bkj", z1, z1, preferred_element_type=jnp.float32, precision=HIGHEST)
        g12 = jnp.einsum("bkt,bjt->bkj", z2, z1, preferred_element_type=jnp.float32, precision=HIGHEST)
        eye = jnp.eye(g1.shape[-1], dtype=g1.dtype)
        # g1 symmetric: GEMM-based SPD solve (utils.linalg.spd_solve)
        a_red = spd_solve(
            g1 + 1e-6 * eye, g12.transpose(0, 2, 1)
        ).transpose(0, 2, 1)

        sq_norm_z = jnp.sum(jnp.square(s), axis=-1)
        num = jnp.maximum(sq_norm_xc - sq_norm_z, 0.0)
        loss = jnp.sqrt(
            lax.psum(jnp.sum(num), AXIS_DATA)
            / (lax.psum(jnp.sum(sq_norm_xc), AXIS_DATA) + 1e-12)
        )
        return FitState(u, s, vt, a_red, loss)

    # check_vma=False: G/C/loss are replicated by psum construction but
    # the static varying-axes analysis cannot always prove it
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(AXIS_DATA, AXIS_SPACE, None), P(None, None)),
        out_specs=FitState(
            u=P(AXIS_DATA, AXIS_SPACE, None),
            s=P(AXIS_DATA, None),
            v=P(AXIS_DATA, None, None),
            a_red=P(AXIS_DATA, None, None),
            loss=P(),
        ),
        check_vma=False,
    )(x, omega)


def _fit_step_portable(
    x: jax.Array,
    omega: jax.Array,
    mesh: Mesh,
    n_components: int,
    gemm_dtype=jnp.float32,
) -> FitState:
    """Portable GSPMD fit step (sharding constraints + jnp ops only).

    The fallback for meshes with a sharded ``time`` axis; XLA places
    the time- and space-axis collectives from the constraints.
    """
    b_spec = P(AXIS_DATA, AXIS_SPACE, AXIS_TIME)
    small_spec = P(AXIS_DATA, None, None)

    def repl(v, spec):
        return lax.with_sharding_constraint(v, NamedSharding(mesh, spec))

    def gemm(expr, a, b):
        # precision=HIGHEST: a default-precision f32 matmul may run in
        # TF32 (~1e-3), which destroys the whitening / projection
        # algebra on ill-conditioned data
        return jnp.einsum(
            expr,
            a.astype(gemm_dtype),
            b.astype(gemm_dtype),
            preferred_element_type=jnp.float32,
            precision=HIGHEST,
        )

    x = repl(x, b_spec)
    t_cols = x.shape[-1]

    # --- time statistics (time-axis psum via GSPMD); Xc never built ---
    mu = jnp.mean(_f32(x), axis=-1)  # (B, S)
    sq_norm_x = jnp.sum(jnp.square(_f32(x)), axis=(-2, -1))  # (B,)
    sq_norm_xc = sq_norm_x - t_cols * jnp.sum(jnp.square(mu), axis=-1)

    # --- sketch: Y = Xc @ Omega = X @ Omega - mu (1^T Omega) ---
    col_omega = jnp.sum(_f32(omega), axis=0)  # (r,)
    y = gemm("bst,tr->bsr", x, omega) - mu[..., None] * col_omega[None, None, :]
    y = repl(y, P(AXIS_DATA, AXIS_SPACE, None))

    # --- orthonormalize via the Cholesky-QR route: G = Y^T Y (space
    # psum), Q = Y chol(G)^-T ---
    gram = jnp.einsum("bsr,bsq->brq", y, y, preferred_element_type=jnp.float32, precision=HIGHEST)
    gram = repl(gram, small_spec)
    # two-pass small-space whitener (utils.linalg.gram_whiten, Newton-
    # refined tri_inv); whitening applies with ONE GEMM over (S, r)
    # instead of a right-side trsm
    inv_chol = gram_whiten(gram, base_ridge=1e-6)
    q = jnp.einsum(
        "bsr,bpr->bsp", y, inv_chol, preferred_element_type=jnp.float32
    , precision=HIGHEST)

    # --- project: B = Q^T Xc = Q^T X - (Q^T mu) 1^T (space psum) ---
    q_mu = jnp.einsum("bsr,bs->br", q, mu, preferred_element_type=jnp.float32, precision=HIGHEST)
    b_small = gemm("bsr,bst->brt", q, x) - q_mu[..., None]
    b_small = repl(b_small, small_spec)

    # --- small SVD (replicated) + truncation ---
    ub, s, vt = jnp.linalg.svd(b_small, full_matrices=False)
    ub = ub[..., :n_components]
    s = s[..., :n_components]
    vt = vt[..., :n_components, :]
    u = jnp.einsum("bsr,brk->bsk", q, ub, preferred_element_type=jnp.float32, precision=HIGHEST)

    # --- reduced one-step operator: A = Z2 Z1^+ in the k-dim space ---
    z = s[..., :, None] * vt  # (B, k, T)
    z1 = z[..., :-1]
    z2 = z[..., 1:]
    g1 = jnp.einsum("bkt,bjt->bkj", z1, z1, preferred_element_type=jnp.float32, precision=HIGHEST)
    g12 = jnp.einsum("bkt,bjt->bkj", z2, z1, preferred_element_type=jnp.float32, precision=HIGHEST)
    eye = jnp.eye(g1.shape[-1], dtype=g1.dtype)
    a_red = spd_solve(
        g1 + 1e-6 * eye, g12.transpose(0, 2, 1)
    ).transpose(0, 2, 1)

    # --- loss from the small factors: ||Xc - UZ||^2 = ||Xc||^2 - ||Z||^2
    sq_norm_z = jnp.sum(jnp.square(s), axis=-1)
    num = jnp.maximum(sq_norm_xc - sq_norm_z, 0.0)
    loss = jnp.sqrt(jnp.sum(num) / (jnp.sum(sq_norm_xc) + 1e-12))

    return FitState(u, s, vt, a_red, loss)


def fit_step_fused(
    x: jax.Array,
    omega: jax.Array,
    n_components: int,
    gemm_dtype=jnp.float32,
    u_dtype=None,
    stats_from_sketch: bool = False,
    t_valid: int | None = None,
    small_algebra: str = "hybrid",
) -> FitState:
    """Single-device fused fit step on a 2D (S, T) snapshot matrix.

    Returns an UNBATCHED FitState: u (S, k), s (k,), v (k, T),
    a_red (k, k), loss ().

    Same math as :func:`fit_step`, but ONE fused ingest pass
    (ops.matmul.sketch_center_gram_project) produces the *centered*
    sketch Yc, the centering statistics, the Gram matrix Yc^T Yc AND
    the projection C = Yc^T X — the mean term is free (c_mu = Yc^T mu =
    C @ 1/T since mu is the row mean of X).  Then the small algebra and
    one skinny U lift over Yc.  Used on the single-device hot path.

    ``u_dtype`` sets the storage dtype of the returned POD basis U
    (default float32).  On the bf16-resident path U in bf16 halves the
    lift-pass write traffic; the bf16 quantization of X itself already
    bounds the achievable mode accuracy at the same level.

    ``stats_from_sketch=True`` spends omega's LAST column on an
    all-ones probe so the centering row sums come out of the sketch
    product (ops.matmul.sketch_center_gram_project ``stats_col``) —
    needs omega with >= k + 11 columns of margin; the effective
    Gaussian sketch width drops by 1.
    """
    y, sq_norm_xc, gram, c = fit_ingest_pass(
        x, omega, gemm_dtype=gemm_dtype,
        stats_from_sketch=stats_from_sketch, t_valid=t_valid,
    )
    return fit_reduce_lift(
        y, sq_norm_xc, gram, c, n_components=n_components,
        u_dtype=u_dtype, t_valid=t_valid, small_algebra=small_algebra,
    )


def fit_step_lean(
    x: jax.Array,
    omega: jax.Array,
    n_components: int,
    gemm_dtype=jnp.float32,
    u_dtype=None,
    t_valid: int | None = None,
    small_algebra: str = "hybrid",
) -> FitState:
    """Memory-lean fused fit: HBM holds exactly ONE extra S-sized array.

    Same math as :func:`fit_step_fused`, different residency: the
    centered sketch Yc is never written to HBM (the fused pass emits
    only G, C and the loss scalars), and the POD basis comes from a
    second plain GEMM against X with the centering FOLDED INTO the
    small lift matrix:

        U = Xc (Omega W Ub)
          = X M - (X 1/T)(1^T M)           with M = Omega W Ub
          = X (M - (1/T) 1_valid (1_valid^T M))  =: X M''

    — exact, and no per-row statistics are needed.  Per step: two X
    reads + one U write (vs one X read + one Yc write + one Yc read +
    one U write for :func:`fit_step_fused`), but peak residency drops
    from X + Yc + U to X + U.
    """
    from dmd_era5_tpu.ops.matmul import sketch_center_gram_project

    s_rows = x.shape[0]
    t_pad = x.shape[1]
    t_cols = t_valid if t_valid is not None else t_pad
    xg = x.astype(gemm_dtype)
    om = omega.astype(gemm_dtype)

    _, rs_sq_sum, sumsq_sum, gram, c = sketch_center_gram_project(
        xg, om, out_dtype=gemm_dtype, scalar_stats=True,
        t_valid=t_valid, emit_yc=False,
    )
    sq_norm_xc = sumsq_sum - rs_sq_sum / t_cols

    c_mu = jnp.sum(c, axis=1) / t_cols
    c_centered = c - c_mu[:, None]
    if t_valid is not None and t_valid != t_pad:
        col_ok = jnp.arange(t_pad) < t_valid
        c_centered = jnp.where(col_ok[None, :], c_centered, 0.0)
    w_lift, s, vt = _reduced_factors(
        gram, c_centered, n_components, method=small_algebra
    )
    vt = vt[:n_components, :t_cols]

    # M = Omega (W^T Ub), then fold the centering: M'' = M - (1/T) 1 (1^T M)
    m_small = jnp.matmul(
        omega.astype(jnp.float32), w_lift,
        preferred_element_type=jnp.float32, precision=HIGHEST,
    )  # (T_pad, k)
    valid = (
        jnp.ones((t_pad, 1), jnp.float32)
        if t_valid is None or t_valid == t_pad
        else (jnp.arange(t_pad) < t_valid).astype(jnp.float32)[:, None]
    )
    col_m = jnp.sum(m_small * valid, axis=0, keepdims=True)  # (1, k)
    m_fold = m_small - (valid / t_cols) * col_m

    out_t = jnp.float32 if u_dtype is None else u_dtype
    u = jnp.matmul(
        xg,
        m_fold.astype(gemm_dtype) if out_t != jnp.float32 else m_fold,
        preferred_element_type=out_t,
        precision=HIGHEST,
    )

    z = s[:, None] * vt
    z1, z2 = z[:, :-1], z[:, 1:]
    g1 = jnp.matmul(z1, z1.T, preferred_element_type=jnp.float32, precision=HIGHEST)
    g12 = jnp.matmul(z2, z1.T, preferred_element_type=jnp.float32, precision=HIGHEST)
    eye = jnp.eye(g1.shape[-1], dtype=g1.dtype)
    a_red = spd_solve(g1 + 1e-6 * eye, g12.T).T

    sq_norm_z = jnp.sum(jnp.square(s))
    loss = jnp.sqrt(
        jnp.maximum(sq_norm_xc - sq_norm_z, 0.0) / (sq_norm_xc + 1e-12)
    )
    del s_rows
    return FitState(u, s, vt, a_red, loss)


def fit_ingest_pass(
    x: jax.Array,
    omega: jax.Array,
    gemm_dtype=jnp.float32,
    stats_from_sketch: bool = False,
    t_valid: int | None = None,
):
    """Stage 1 of the fused fit: ONE fused ingest pass over X.

    Returns (Yc, ||Xc||^2, G, C).  Split from :func:`fit_reduce_lift`
    so callers at the edge of device memory can run the two halves as
    separate programs: within one program a non-donated X stays
    resident for the whole execution.
    """
    from dmd_era5_tpu.ops.matmul import sketch_center_gram_project

    t_cols = t_valid if t_valid is not None else x.shape[1]
    xg = x.astype(gemm_dtype)

    # bf16-resident path: Yc is stored bf16 too (halves the Yc traffic
    # of the lift pass); G and C come from the stored quantized Yc so
    # the whitening stays exactly consistent.  Only two scalars of the
    # row statistics survive into the loss (scalar_stats).
    y, rs_sq_sum, sumsq_sum, gram, c = sketch_center_gram_project(
        xg,
        omega.astype(gemm_dtype),
        out_dtype=gemm_dtype,
        stats_col=stats_from_sketch,
        scalar_stats=True,
        t_valid=t_valid,
    )
    sq_norm_xc = sumsq_sum - rs_sq_sum / t_cols
    return y, sq_norm_xc, gram, c


def _reduced_factors(
    gram: jax.Array,
    c_centered: jax.Array,
    n_components: int,
    method: str = "cholqr",
):
    """(w_lift, s, vt_full) of the sketch-subspace SVD, small algebra.

    With G = Yc^T Yc and C = Yc^T Xc (centered), computes the SVD of
    B = W C for a whitener W with (Yc W^T) orthonormal; returns
    ``w_lift = W^T Ub`` (so U = Yc @ w_lift), the singular values and
    the FULL-width right vectors (caller slices columns).

    method="hybrid" (DEFAULT): CholQR whitener (Cholesky + Newton
    tri-inv — GEMMs past one r x r Cholesky) + ONE r x r ``eigh`` of
    K = B B^T with B = W C.  One spectral decomposition where cholqr
    has the (r, T) SVD and eigh2 has two eighs.  Which is fastest on
    the GPU is not measured yet (ROADMAP A3).  Tail semantics: forming
    K squares B's conditioning, so components below ~sqrt(eps_f32) of
    s[0] are noise-floor and ``sqrt(max(., 0))`` damps them (shrunk
    tail, never spurious growth); parity pinned by
    tests/test_07_train_step.py.

    method="cholqr" keeps the original gram_whiten + wide-SVD route
    (the backward-stable option for pathological sketch conditioning:
    its B tail is exact rather than squared).

    method="eigh2": two r x r eighs (W = G^{-1/2} from eigh(G), then
    eigh of W (C C^T) W).
    """
    if method == "cholqr":
        inv_chol = gram_whiten(gram, base_ridge=1e-6)
        b_small = jnp.matmul(
            inv_chol, c_centered,
            preferred_element_type=jnp.float32, precision=HIGHEST,
        )
        ub, s, vt = jnp.linalg.svd(b_small, full_matrices=False)
        w_lift = jnp.matmul(
            inv_chol.T, ub[:, :n_components],
            preferred_element_type=jnp.float32, precision=HIGHEST,
        )
        return w_lift, s[:n_components], vt

    if method == "hybrid":
        inv_chol = gram_whiten(gram, base_ridge=1e-6)
        b_small = jnp.matmul(
            inv_chol, c_centered,
            preferred_element_type=jnp.float32, precision=HIGHEST,
        )
        k_gram = jnp.matmul(
            b_small, b_small.T,
            preferred_element_type=jnp.float32, precision=HIGHEST,
        )  # (r, r) PSD
        eh, uh = jnp.linalg.eigh(k_gram)  # ascending
        s_all = jnp.sqrt(jnp.maximum(eh[::-1], 0.0))
        ub = uh[:, ::-1][:, :n_components]
        s = s_all[:n_components]
        w_lift = jnp.matmul(
            inv_chol.T, ub,
            preferred_element_type=jnp.float32, precision=HIGHEST,
        )
        vt = jnp.matmul(
            ub.T, b_small,
            preferred_element_type=jnp.float32, precision=HIGHEST,
        ) / jnp.maximum(s, 1e-30)[:, None]
        return w_lift, s, vt

    if method != "eigh2":
        raise ValueError(
            f"small_algebra must be cholqr/eigh2/hybrid, got {method!r}"
        )

    # eigh2: W = G^{-1/2} via eigh, spectrum via eigh(W K W), K = C C^T.
    # FLOOR the eigenvalues at the f32 eigh noise level (~5 eps * e0):
    # below it the computed e are rounding noise (possibly negative)
    # and an unguarded 1/sqrt(e) amplifies junk directions into
    # SPURIOUS LARGE singular values (observed 31304 vs true max 28722
    # at cond(G) ~ 7e9).  Flooring damps those directions instead —
    # the same shrunk-tail semantics as the CholQR ridge.
    e, vg = jnp.linalg.eigh(gram)  # ascending
    e0 = jnp.maximum(e[-1], 1e-30)
    inv_sqrt = 1.0 / jnp.sqrt(jnp.maximum(e, 6e-7 * e0))
    w = jnp.matmul(
        vg * inv_sqrt[None, :], vg.T,
        preferred_element_type=jnp.float32, precision=HIGHEST,
    )  # (r, r) symmetric G^{-1/2}
    k_gram = jnp.matmul(
        c_centered, c_centered.T,
        preferred_element_type=jnp.float32, precision=HIGHEST,
    )  # (r, r)
    h = jnp.matmul(
        jnp.matmul(w, k_gram, precision=HIGHEST), w,
        preferred_element_type=jnp.float32, precision=HIGHEST,
    )
    eh, uh = jnp.linalg.eigh(h)  # ascending
    s_all = jnp.sqrt(jnp.maximum(eh[::-1], 0.0))
    ub = uh[:, ::-1][:, :n_components]
    s = s_all[:n_components]
    w_lift = jnp.matmul(
        w, ub, preferred_element_type=jnp.float32, precision=HIGHEST
    )  # W^T Ub == W Ub (symmetric W)
    vt = jnp.matmul(
        w_lift.T, c_centered,
        preferred_element_type=jnp.float32, precision=HIGHEST,
    ) / jnp.maximum(s, 1e-30)[:, None]
    return w_lift, s, vt


def fit_reduce_lift(
    y: jax.Array,
    sq_norm_xc: jax.Array,
    gram: jax.Array,
    c: jax.Array,
    n_components: int,
    u_dtype=None,
    t_valid: int | None = None,
    small_algebra: str = "hybrid",
) -> FitState:
    """Stage 2 of the fused fit: small algebra + the skinny U lift.

    ``t_valid``: trailing zero-padded time columns (see
    :func:`fit_ingest_pass`) — the centering subtraction and the
    transition operator only touch the true columns.
    """
    t_cols = t_valid if t_valid is not None else c.shape[1]

    c_mu = jnp.sum(c, axis=1) / t_cols
    # B = Q^T Xc = W (C - c_mu 1^T): subtract the mean only on the
    # TRUE columns — zero-pad columns must stay exactly zero
    c_centered = c - c_mu[:, None]
    if t_valid is not None and t_valid != c.shape[1]:
        col_ok = jnp.arange(c.shape[1]) < t_valid
        c_centered = jnp.where(col_ok[None, :], c_centered, 0.0)

    w_lift, s, vt = _reduced_factors(
        gram, c_centered, n_components, method=small_algebra
    )
    vt = vt[:n_components, :t_cols]
    # U = Q Ub = Y (W^T Ub): one skinny pass over Y.  The dot emits
    # u_dtype DIRECTLY (accumulation is f32 regardless; only the output
    # rounds): a separate astype would materialize BOTH the f32 and the
    # converted U — an extra 6.2 GB buffer at 15.6M rows.
    out_t = jnp.float32 if u_dtype is None else u_dtype
    u = jnp.matmul(
        y,
        w_lift.astype(y.dtype) if out_t != jnp.float32 else w_lift,
        preferred_element_type=out_t,
        precision=HIGHEST,
    )

    z = s[:, None] * vt
    z1, z2 = z[:, :-1], z[:, 1:]
    g1 = jnp.matmul(z1, z1.T, preferred_element_type=jnp.float32, precision=HIGHEST)
    g12 = jnp.matmul(z2, z1.T, preferred_element_type=jnp.float32, precision=HIGHEST)
    eye = jnp.eye(g1.shape[-1], dtype=g1.dtype)
    a_red = spd_solve(g1 + 1e-6 * eye, g12.T).T

    sq_norm_z = jnp.sum(jnp.square(s))
    loss = jnp.sqrt(
        jnp.maximum(sq_norm_xc - sq_norm_z, 0.0) / (sq_norm_xc + 1e-12)
    )
    # unbatched (S, k)/(k,)/(k, T) leaves: a leading [None] batch dim
    # here can make XLA materialize a full copy of U
    return FitState(u, s, vt, a_red, loss)


def make_fit_step(mesh: Mesh, n_components: int, gemm_dtype=jnp.float32):
    """jit-compiled fit step bound to a mesh, with batch I/O shardings."""
    in_shardings = (
        NamedSharding(mesh, P(AXIS_DATA, AXIS_SPACE, AXIS_TIME)),
        NamedSharding(mesh, P(None, None)),
    )
    return jax.jit(
        partial(fit_step, mesh=mesh, n_components=n_components, gemm_dtype=gemm_dtype),
        in_shardings=in_shardings,
    )


def example_batch(
    batch: int, s_rows: int, t_cols: int, sketch: int, seed: int = 0
):
    """Deterministic example inputs for compile checks and dry runs."""
    key = jax.random.key(seed)
    k1, k2 = jax.random.split(key)
    x = jax.random.normal(k1, (batch, s_rows, t_cols), dtype=jnp.float32)
    omega = jax.random.normal(k2, (t_cols, sketch), dtype=jnp.float32)
    return x, omega
