"""Multiresolution DMD (mrDMD) — hierarchical slow/fast mode separation.

Kutz, Fu & Brunton, "Multiresolution dynamic mode decomposition" (SIAM
J. Appl. Dyn. Syst., 2016): recursively split the time axis, fit DMD on
each window, keep only the SLOW modes (those completing at most
``max_cycles`` oscillations over the window), subtract their
reconstruction, and recurse on the residual.  The result is a
scale-separated spectral decomposition — for ERA5 this separates
quasi-stationary climate structure from synoptic-scale weather, the
multiscale extension of the single decomposition the reference pipeline
feeds (/root/reference/README.md:85,139; the reference itself stops at
one truncated SVD, SURVEY.md fact 2).

Shape: at level ``l`` the ``2**l`` windows are identical-shape
independent problems, so each level is ONE batched fit — a batched
Gram-route truncated SVD (batched T_l x T_l ``eigh`` + Rayleigh-Ritz,
the same route as ops.svd.exact_truncated_svd_gram) and a handful of
batched skinny GEMMs over the space axis; the only host work is the
batched r x r nonsymmetric eigendecomposition (utils.linalg.eig_host)
and r x r complex amplitude solves.  The slow/fast split is a BOOLEAN
MASK folded into the amplitudes, so every shape stays static: no
data-dependent mode counts anywhere.  The subtraction of the slow part
is one batched real GEMM — the complex dynamics are folded into a real
(r, T_l) coefficient matrix on host (X_slow = Re(Phi diag(b) e^{omega t})
= M Re(W diag(b) e^{omega t}) with M = X2 V S^-1 real).

Unlike the classic host implementation, no level subsamples the data:
the coarse-level GEMMs are ordinary skinny products, so the
accuracy-losing stride-``2**(L-l)`` thinning of the original algorithm
is unnecessary.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from dmd_era5_tpu.utils.linalg import gram_whiten

HIGHEST = lax.Precision.HIGHEST

__all__ = [
    "MrDMDLevel",
    "MrDMDResult",
    "fit_mrdmd",
    "fit_mrdmd_gram",
    "fit_mrdmd_streamed",
    "mrdmd_from_svd",
    "mrdmd_reconstruct",
]


class MrDMDLevel(NamedTuple):
    """Per-level mrDMD fit: ``n_windows = 2**level`` windows of
    ``t_window`` snapshots each, batched along the leading axis.

    omega:       (n_windows, r) complex continuous-time eigenvalues.
    amplitudes:  (n_windows, r) complex amplitudes fit to each window's
                 first residual snapshot (zeroed where ``slow_mask`` is
                 False — only slow modes contribute at this level).
    slow_mask:   (n_windows, r) bool — |omega| within this level's
                 slow-frequency budget (the true ``rho`` criterion at
                 EVERY level, including the finest).
    modes:       (n_windows, S, r) complex spatial modes with unit
                 columns, or None when ``return_modes=False``.
    t_window:    snapshots per window at this level.
    kept_mask:   (n_windows, r) bool — modes whose amplitudes were
                 actually kept.  Equals ``slow_mask`` except at the
                 finest level, where the recursion terminates by keeping
                 EVERY mode so fast remainder content lands in the
                 decomposition instead of the residual.
    """

    level: int
    omega: np.ndarray
    amplitudes: np.ndarray
    slow_mask: np.ndarray
    modes: np.ndarray | None
    t_window: int
    kept_mask: np.ndarray | None = None
    # (n_windows, T_used, r) complex time-side mode maps (Gram route
    # only): Phi_w = X @ mode_map[w] / column norms — lets callers
    # materialize modes blockwise from streamed X rows without the fit
    # ever holding an S-sized array
    mode_map: np.ndarray | None = None


class MrDMDResult(NamedTuple):
    """Hierarchical mrDMD decomposition.

    levels:    one MrDMDLevel per level, coarse (level 0, one window
               spanning all of T) to fine.
    residual:  (S, T_used) what no level's slow modes captured.
    dt:        sampling interval.
    t_used:    leading time steps actually decomposed (T truncated to a
               multiple of 2**(max_levels-1)).
    """

    levels: list
    residual: np.ndarray | None
    dt: float
    t_used: int
    # Frobenius norm of the residual — always available, even on the
    # Gram route where the (S, T_used) residual itself never exists
    residual_fro: float | None = None
    # ||X[:, :t_used]||_F (Gram route: sqrt of the Gram trace) — the
    # normalizer for residual fractions without any X access
    x_fro: float | None = None


def _level_core(xw: jax.Array, rank: int):
    """Batched window DMD factors from one pass of skinny GEMMs.

    xw: (B, S, T_l) float32.  Returns (m, atilde, mtm, mtx0) where
    m = X2 V S^-1 is the (B, S, r) REAL mode pre-factor (exact modes are
    Phi = m W with W the host eigenvectors), atilde (B, r, r) the reduced
    operators, and mtm / mtx0 the normal-equation pieces for the
    amplitude fit (all S-contractions happen here, on device).
    """
    x1 = xw[..., :-1]
    x2 = xw[..., 1:]

    # batched Gram-route truncated SVD of X1 (same algebra as
    # ops.svd.exact_truncated_svd_gram, batched and at tiny T_l)
    g = jnp.einsum(
        "bst,bsq->btq", x1, x1,
        preferred_element_type=jnp.float32, precision=HIGHEST,
    )
    _, vecs = jnp.linalg.eigh(g)  # ascending
    v_r = vecs[..., ::-1][..., :rank]  # (B, T_l-1, r) top subspace
    y = jnp.einsum(
        "bst,btr->bsr", x1, v_r,
        preferred_element_type=jnp.float32, precision=HIGHEST,
    )
    g_y = jnp.einsum(
        "bsr,bsq->brq", y, y,
        preferred_element_type=jnp.float32, precision=HIGHEST,
    )
    w = gram_whiten(g_y, base_ridge=1e-7)  # (B, r, r), Q = y w^T implicit
    c = jnp.einsum(
        "bsr,bst->brt", y, x1,
        preferred_element_type=jnp.float32, precision=HIGHEST,
    )
    b_small = jnp.einsum(
        "bqr,brt->bqt", w, c,
        preferred_element_type=jnp.float32, precision=HIGHEST,
    )
    u_b, s, vt = jnp.linalg.svd(b_small, full_matrices=False)

    # a residual window that an earlier level captured (or a window of
    # lower spatial rank than the requested fit rank) has trailing
    # s ~ 0; dead directions get a zero inverse.  The cutoff sits at
    # the Gram route's conditioning floor sqrt(eps_f32) ~ 3e-4: the
    # squared-conditioning of the T_l x T_l eigh makes directions below
    # it numerical junk, and 1/s would amplify them into the
    # subtraction (a 1e-6 cutoff passes garbage directions and the
    # residual diverges).
    s0 = jnp.maximum(s[..., :1], 1e-30)
    s_inv = jnp.where(s > 1e-3 * s0, 1.0 / jnp.maximum(s, 1e-30), 0.0)

    # atilde = U^T X2 V S^-1 with U = y (w^T u_b), never materialized
    y_t_x2 = jnp.einsum(
        "bsr,bst->brt", y, x2,
        preferred_element_type=jnp.float32, precision=HIGHEST,
    )
    # U = Q u_b = y (w^T u_b)  =>  U^T X2 = u_b^T w (y^T X2)
    proj2 = jnp.einsum(
        "bqk,bqr,brt->bkt", u_b, w, y_t_x2,
        preferred_element_type=jnp.float32, precision=HIGHEST,
    )  # (B, r, T_l-1) = U^T X2
    vs = vt * s_inv[..., None]  # rows k scaled: (V S^-1)^T
    atilde = jnp.einsum(
        "bkt,bjt->bkj", proj2, vs,
        preferred_element_type=jnp.float32, precision=HIGHEST,
    )

    # exact-mode pre-factor M = X2 V S^-1 (real) and the amplitude
    # normal-equation pieces (Phi^H Phi = W^H M^T M W on host)
    m = jnp.einsum(
        "bst,bkt->bsk", x2, vs,
        preferred_element_type=jnp.float32, precision=HIGHEST,
    )
    mtm = jnp.einsum(
        "bsk,bsj->bkj", m, m,
        preferred_element_type=jnp.float32, precision=HIGHEST,
    )
    mtx0 = jnp.einsum(
        "bsk,bs->bk", m, xw[..., 0],
        preferred_element_type=jnp.float32, precision=HIGHEST,
    )
    return m, atilde, mtm, mtx0


_level_core_jit = jax.jit(_level_core, static_argnames=("rank",))


@jax.jit
def _subtract_slow(xw: jax.Array, m: jax.Array, k_re: jax.Array):
    """residual = xw - M @ Re(K): the level's only full-size write."""
    return xw - jnp.einsum(
        "bsk,bkt->bst", m, k_re,
        preferred_element_type=jnp.float32, precision=HIGHEST,
    )


def fit_mrdmd(
    x: jax.Array,
    dt: float = 1.0,
    rank: int = 8,
    max_levels: int = 4,
    max_cycles: float = 1.0,
    return_modes: bool = True,
) -> MrDMDResult:
    """Multiresolution DMD of a (S, T) snapshot matrix.

    Args:
        x: (S, T) snapshot matrix (any float dtype; promoted to f32).
        dt: sampling interval.
        rank: DMD rank per window (static across levels).
        max_levels: levels in the binary time hierarchy; level ``l`` has
            ``2**l`` windows.  T is truncated to a multiple of
            ``2**(max_levels-1)``; the finest window must keep at least
            ``rank + 2`` snapshots.
        max_cycles: slow-mode budget — a mode is SLOW for its level when
            it completes at most this many oscillations over the window
            (|omega| <= 2*pi*max_cycles / (T_l*dt), the classic mrDMD
            ``rho`` criterion).
        return_modes: keep (n_windows, S, r) complex modes per level
            (needed by :func:`mrdmd_reconstruct`; skip for very large S
            where only spectra are wanted).

    Returns a :class:`MrDMDResult`; the sum of all levels' slow-part
    reconstructions equals ``x[:, :t_used] - residual`` exactly.
    """
    x = jnp.asarray(x, jnp.float32)
    s_rows, t_total = x.shape
    n_fine = 2 ** (max_levels - 1)
    t_used = (t_total // n_fine) * n_fine
    if t_used // n_fine < rank + 2:
        raise ValueError(
            f"finest window has {t_used // n_fine} snapshots; "
            f"need >= rank + 2 = {rank + 2} (reduce max_levels or rank)"
        )
    xw = x[:, :t_used][None]  # (1, S, T_used): level-0 batch

    levels: list[MrDMDLevel] = []
    for level in range(max_levels):
        n_win = xw.shape[0]
        t_l = xw.shape[-1]
        m, atilde, mtm, mtx0 = _level_core_jit(xw, rank=rank)

        # --- host small algebra: batched r x r eig + amplitude solves ---
        at_h = np.asarray(jax.device_get(atilde), dtype=np.float64)
        lam, wvec = np.linalg.eig(at_h)  # (B, r), (B, r, r)
        # eig returns REAL arrays when the spectrum happens to be real;
        # the log below needs the complex branch cut either way
        lam = np.where(np.abs(lam) < 1e-12, 1e-12, lam).astype(np.complex128)
        wvec = wvec.astype(np.complex128)
        omega = (np.log(lam) / dt).astype(np.complex64)  # (B, r)

        rho = 2.0 * np.pi * max_cycles / (t_l * dt)
        slow = np.abs(omega) <= rho  # (B, r): the true rho criterion
        kept = slow
        if level == max_levels - 1:
            # the FINEST level keeps every mode (up to rank): the
            # recursion terminates by capturing the remainder, so
            # content faster than the finest slow budget still lands
            # in the decomposition instead of the residual.  slow_mask
            # still records the criterion so consumers can tell
            # genuinely slow modes from remainder modes kept only to
            # terminate.
            kept = np.ones_like(slow)

        # amplitudes: (Phi^H Phi) b = Phi^H x0 with Phi = M W, so
        # Phi^H Phi = W^H (M^T M) W and Phi^H x0 = W^H (M^T x0) — r x r
        # complex solves on host, no S-sized work
        mtm_h = np.asarray(jax.device_get(mtm), dtype=np.float64)
        mtx0_h = np.asarray(jax.device_get(mtx0), dtype=np.float64)
        wh = np.conj(np.swapaxes(wvec, -1, -2))
        php = wh @ mtm_h @ wvec  # (B, r, r) complex
        rhs = np.einsum("bkj,bj->bk", wh, mtx0_h)
        ridge = 1e-9 * np.maximum(
            np.abs(np.einsum("bkk->b", php)), 1.0
        )  # scaled Tikhonov for captured-window degeneracy
        eye = np.eye(rank)
        amps = np.stack(
            [
                np.linalg.solve(php[i] + ridge[i] * eye, rhs[i])
                for i in range(n_win)
            ]
        )  # (B, r) complex
        amps_slow = np.where(kept, amps, 0.0)

        # slow dynamics folded to a REAL coefficient matrix:
        # K = Re(W diag(b_slow) exp(omega t_local)), (B, r, T_l).
        # exp only over the kept modes — a masked fast mode with a large
        # growth rate would overflow and 0 * inf poisons the product
        omega_kept = np.where(kept, omega, 0.0)
        t_local = np.arange(t_l) * dt
        dyn = amps_slow[..., None] * np.exp(
            omega_kept[..., None] * t_local[None, None, :]
        )  # (B, r, T_l)
        k_re = np.real(wvec @ dyn).astype(np.float32)

        modes = None
        norms = None
        if return_modes:
            # Phi = M W as two batched real GEMMs, unit-normalized with
            # norms from the (already-host) Gram: ||Phi_j||^2 = (W^H M^T M W)_jj
            w_re = jnp.asarray(wvec.real.astype(np.float32))
            w_im = jnp.asarray(wvec.imag.astype(np.float32))
            gemm = lambda a, b: jnp.einsum(  # noqa: E731
                "bsk,bkj->bsj", a, b,
                preferred_element_type=jnp.float32, precision=HIGHEST,
            )
            phi = (
                np.asarray(jax.device_get(gemm(m, w_re)))
                + 1j * np.asarray(jax.device_get(gemm(m, w_im)))
            ).astype(np.complex64)
            norms = np.sqrt(np.maximum(np.real(np.einsum("bkk->bk", php)), 0.0))
            safe = np.where(norms < 1e-30, 1.0, norms)
            phi = phi / safe[:, None, :].astype(np.float32)
            modes = phi

        # amplitudes reported against unit modes (b_unit = b * ||Phi_j||)
        if norms is None:
            norms = np.sqrt(np.maximum(np.real(np.einsum("bkk->bk", php)), 0.0))
        levels.append(
            MrDMDLevel(
                level=level,
                omega=omega,
                amplitudes=(amps_slow * norms).astype(np.complex64),
                slow_mask=slow,
                modes=modes,
                t_window=t_l,
                kept_mask=kept,
            )
        )

        xw = _subtract_slow(xw, m, jnp.asarray(k_re))
        if level + 1 < max_levels:
            # split each window in two: (B, S, T_l) -> (2B, S, T_l/2)
            half = t_l // 2
            xw = jnp.concatenate([xw[..., :half], xw[..., half:]], axis=0)
            # interleave so window order stays chronological per parent
            order = np.arange(2 * n_win).reshape(2, n_win).T.ravel()
            xw = xw[jnp.asarray(order)]

    residual = np.asarray(jax.device_get(xw))  # (n_fine, S, t_fine)
    residual = np.concatenate(list(residual), axis=-1)  # (S, T_used)
    return MrDMDResult(
        levels=levels, residual=residual, dt=dt, t_used=t_used,
        residual_fro=float(np.linalg.norm(residual)),
    )


def mrdmd_from_svd(
    u: jax.Array,
    s: jax.Array,
    v: jax.Array,
    dt: float = 1.0,
    rank: int | None = None,
    max_levels: int = 3,
    max_cycles: float = 1.0,
) -> MrDMDResult:
    """Multiresolution DMD in the POD subspace of a truncated SVD.

    The pipeline entry (pipeline/era5_dmd.py): with X ~ U S V^T from
    the sharded SVD stage, the hierarchy is fit on the PROJECTED
    snapshots Z = S V^T (k, T) — every per-window solve is k-sized —
    and each level's modes are lifted to full space with ONE batched
    skinny GEMM against U, the same space-vs-POD split as
    models/optdmd.py::optdmd_from_svd.  The returned residual is in the
    projected space (k, T_used); its norm relative to ||Z|| equals the
    in-subspace unexplained energy fraction.

    **Approximation — this is NOT classic mrDMD.** Classic mrDMD
    (Kutz/Fu/Brunton 2016) refits every window's SVD on that window's
    raw residual data, so short-lived structure gets its own basis.
    Here every level shares the single GLOBAL rank-k basis U: any
    per-window dynamics orthogonal to it is INVISIBLE — it never
    appears in the level fits, the lifted modes, or the projected
    residual (which only sees in-subspace energy).  The approximation
    is safe when the global truncation captures the transients of
    interest (energy in top-k >> energy outside, e.g. k generous
    relative to the number of coherent structures); it biases low —
    silently — when a weak, brief transient's spatial pattern falls
    outside the top-k modes.  tests/test_26_mrdmd.py::
    test_from_svd_subspace_bias_vs_raw_oracle constructs exactly that
    failure and measures the bias; the pipeline escape hatch is
    ``mr_refit_rank`` (era5-dmd config), which switches the stage to
    :func:`fit_mrdmd` on the raw embedded matrix — per-window bases,
    classic behavior — at the cost of S-sized window GEMMs.

    u: (S, k); s: (k,); v: (k, T); rank: per-window DMD rank
    (default k).
    """
    k = int(s.shape[0])
    rank = rank or k
    z = np.asarray(jax.device_get(s))[:, None] * np.asarray(
        jax.device_get(v)
    )  # (k, T)
    res = fit_mrdmd(
        z,
        dt=dt,
        rank=rank,
        max_levels=max_levels,
        max_cycles=max_cycles,
        return_modes=True,
    )
    lifted_levels = []
    for lv in res.levels:
        # (S, k) @ (B, k, r) -> (B, S, r), complex via two real GEMMs
        m_re = jnp.einsum(
            "sk,bkr->bsr", u, jnp.asarray(lv.modes.real.astype(np.float32)),
            preferred_element_type=jnp.float32, precision=HIGHEST,
        )
        m_im = jnp.einsum(
            "sk,bkr->bsr", u, jnp.asarray(lv.modes.imag.astype(np.float32)),
            preferred_element_type=jnp.float32, precision=HIGHEST,
        )
        modes = (
            np.asarray(jax.device_get(m_re))
            + 1j * np.asarray(jax.device_get(m_im))
        ).astype(np.complex64)
        # U orthonormal => the projected unit norms survive the lift;
        # re-normalize anyway to absorb truncated-U roundoff
        norms = np.linalg.norm(modes, axis=1)  # (B, r)
        safe = np.where(norms < 1e-30, 1.0, norms)
        modes = modes / safe[:, None, :]
        lifted_levels.append(
            lv._replace(
                modes=modes,
                amplitudes=(lv.amplitudes * safe).astype(np.complex64),
            )
        )
    return res._replace(levels=lifted_levels)


def mrdmd_reconstruct(result: MrDMDResult) -> np.ndarray:
    """Sum of every level's slow-part reconstruction, (S, T_used).

    Equals ``x[:, :t_used] - result.residual`` to float32 roundoff —
    the identity tests/test_26_mrdmd.py checks.  Requires the fit to
    have kept modes (``return_modes=True``).
    """
    first = result.levels[0]
    if first.modes is None:
        raise ValueError("fit_mrdmd(return_modes=True) is required")
    s_rows = first.modes.shape[1]
    out = np.zeros((s_rows, result.t_used), dtype=np.float32)
    for lv in result.levels:
        t_l = lv.t_window
        t_local = np.arange(t_l) * result.dt
        kept = lv.kept_mask if lv.kept_mask is not None else lv.slow_mask
        omega_kept = np.where(kept, lv.omega, 0.0)  # 0*inf guard
        for win in range(lv.omega.shape[0]):
            dyn = lv.amplitudes[win][:, None] * np.exp(
                omega_kept[win][:, None] * t_local[None, :]
            )  # (r, T_l)
            out[:, win * t_l : (win + 1) * t_l] += np.real(
                lv.modes[win] @ dyn
            ).astype(np.float32)
    return out


def fit_mrdmd_gram(
    gx: np.ndarray,
    dt: float = 1.0,
    rank: int = 8,
    max_levels: int = 4,
    max_cycles: float = 1.0,
) -> MrDMDResult:
    """Multiresolution DMD from the T x T Gram of the snapshot matrix.

    The out-of-core raw-data refit (review r4 item 7).  Key identity:
    the level-``l`` residual is always ``X @ C`` for a small per-window
    time-side map C — level 0 starts at C = I, and each subtraction
    ``R - M K`` with ``M = R[:, 1:] (V S^-1)`` only composes more
    time-side maps: ``C_child = C[:, half] - C[:, 1:] (V S^-1) K[:, half]``.
    So EVERY window's Gram is ``C^T Gx C`` and the whole hierarchy —
    spectra, amplitudes, masks, residual norm — follows from one
    (T, T) matrix that a single streamed pass over the packed artifact
    accumulates.  No S-sized array exists anywhere in this function;
    modes come back as time-side ``mode_map`` factors (``Phi_w = X @
    mode_map[w]``, unit columns) that :func:`fit_mrdmd_streamed`
    materializes blockwise on request.

    Numerics: all algebra is f64 on host (T is small), with the same
    relative dead-direction cutoff (1e-3) as the on-device
    :func:`fit_mrdmd` so the two routes keep the same effective ranks.

    gx: (T, T) float64 Gram X^T X (f64 accumulation recommended).
    Other args as :func:`fit_mrdmd`.
    """
    gx = np.asarray(gx, np.float64)
    t_total = gx.shape[0]
    n_fine = 2 ** (max_levels - 1)
    t_used = (t_total // n_fine) * n_fine
    if t_used // n_fine < rank + 2:
        raise ValueError(
            f"finest window has {t_used // n_fine} snapshots; "
            f"need >= rank + 2 = {rank + 2} (reduce max_levels or rank)"
        )
    gx = gx[:t_used, :t_used]

    # per-window residual maps: R_w = X[:, :t_used] @ cmaps[w]
    cmaps: list[np.ndarray] = [np.eye(t_used)]
    levels: list[MrDMDLevel] = []

    for level in range(max_levels):
        t_l = t_used // (2**level)
        n_win = len(cmaps)
        omega_l = np.zeros((n_win, rank), np.complex64)
        amps_l = np.zeros((n_win, rank), np.complex64)
        slow_l = np.zeros((n_win, rank), bool)
        kept_l = np.zeros((n_win, rank), bool)
        maps_l = np.zeros((n_win, t_used, rank), np.complex64)
        next_maps: list[np.ndarray] = []
        rho = 2.0 * np.pi * max_cycles / (t_l * dt)

        for w, c in enumerate(cmaps):
            gw = c.T @ gx @ c  # (T_l, T_l) window Gram
            g11 = gw[:-1, :-1]
            evals, vecs = np.linalg.eigh(g11)
            idx = np.argsort(evals)[::-1][:rank]
            s = np.sqrt(np.maximum(evals[idx], 0.0))
            v_r = vecs[:, idx]  # (T_l-1, r)
            # same relative dead-direction cutoff as the device route
            s0 = max(s[0], 1e-300)
            s_inv = np.where(s > 1e-3 * s0, 1.0 / np.maximum(s, 1e-300), 0.0)
            vs = v_r * s_inv[None, :]  # V S^-1, (T_l-1, r)

            # atilde = U1^T X2 V S^-1 = S^-1 V^T (X1^T X2) V S^-1
            g12 = gw[:-1, 1:]
            atilde = vs.T @ g12 @ vs  # (r, r)
            lam, wvec = np.linalg.eig(atilde)
            lam = np.where(np.abs(lam) < 1e-12, 1e-12, lam).astype(
                np.complex128
            )
            omega = (np.log(lam) / dt).astype(np.complex64)

            slow = np.abs(omega) <= rho
            kept = (
                np.ones_like(slow) if level == max_levels - 1 else slow
            )

            # M = X2 (V S^-1): mtm = vs^T G22 vs, mtx0 = vs^T (X2^T x0)
            g22 = gw[1:, 1:]
            mtm = vs.T @ g22 @ vs
            mtx0 = vs.T @ gw[1:, 0]
            wh = np.conj(wvec.T)
            php = wh @ mtm @ wvec
            rhs = wh @ mtx0
            ridge = 1e-9 * max(abs(np.trace(php)), 1.0)
            amps = np.linalg.solve(php + ridge * np.eye(rank), rhs)
            amps_slow = np.where(kept, amps, 0.0)

            # slow-part coefficient matrix K (real), exp only over kept
            omega_kept = np.where(kept, omega.astype(np.complex128), 0.0)
            t_local = np.arange(t_l) * dt
            dyn = amps_slow[:, None] * np.exp(
                omega_kept[:, None] * t_local[None, :]
            )
            k_re = np.real(wvec @ dyn)  # (r, T_l)

            # mode map (complex): Phi_w = X @ (C[:, 1:] vs wvec), unit
            # columns via norms^2 = diag(W^H M^T M W)
            norms = np.sqrt(np.maximum(np.real(np.diag(php)), 0.0))
            safe = np.where(norms < 1e-30, 1.0, norms)
            maps_l[w] = ((c[:, 1:] @ vs) @ wvec / safe[None, :]).astype(
                np.complex64
            )
            omega_l[w] = omega
            amps_l[w] = (amps_slow * norms).astype(np.complex64)
            slow_l[w] = slow
            kept_l[w] = kept

            # children: subtract the slow part IN THE MAP, then split
            c_res = c - (c[:, 1:] @ vs) @ k_re
            if level + 1 < max_levels:
                half = t_l // 2
                next_maps.extend([c_res[:, :half], c_res[:, half:]])
            else:
                next_maps.append(c_res)

        levels.append(
            MrDMDLevel(
                level=level,
                omega=omega_l,
                amplitudes=amps_l,
                slow_mask=slow_l,
                modes=None,
                t_window=t_l,
                kept_mask=kept_l,
                mode_map=maps_l,
            )
        )
        cmaps = next_maps

    # residual Frobenius norm from the final maps: ||X C||^2 = tr(C^T Gx C)
    res_sq = sum(float(np.trace(c.T @ gx @ c)) for c in cmaps)
    return MrDMDResult(
        levels=levels,
        residual=None,
        dt=dt,
        t_used=t_used,
        residual_fro=float(np.sqrt(max(res_sq, 0.0))),
        x_fro=float(np.sqrt(max(np.trace(gx), 0.0))),
    )


def fit_mrdmd_streamed(
    path,
    dt: float = 1.0,
    rank: int = 8,
    max_levels: int = 4,
    max_cycles: float = 1.0,
    block_rows: int = 1 << 16,
    return_modes: bool = False,
) -> MrDMDResult:
    """Multiresolution DMD of a packed snapshot artifact, out-of-core.

    ONE streamed pass accumulates the f64 (T, T) Gram (per-block f32
    GEMM on host, f64 accumulation across blocks — the same oracle-
    grade scheme as scripts/era5_scale_bench.py), then the whole
    hierarchy comes from :func:`fit_mrdmd_gram`'s small algebra.  With
    ``return_modes=True`` a second streamed pass materializes the
    (n_windows, S, r) complex modes per level from the time-side maps
    (host memory: the caller opted into S-sized modes).

    This replaces the ``save_data_matrix=True`` requirement of the raw
    refit: the d-fold embedded matrix never exists in host RAM.
    """
    import ml_dtypes

    from dmd_era5_tpu.pipeline.streamed_fit import prefetched_row_blocks
    from dmd_era5_tpu.snapmat.loader import packed_info

    (n_rows, t_cols), _, _ = packed_info(path)
    gx = np.zeros((t_cols, t_cols), np.float64)
    for _r0, blk in prefetched_row_blocks(path, n_rows, block_rows):
        if blk.dtype == np.uint16:
            blk = blk.view(ml_dtypes.bfloat16)
        xb = np.asarray(blk, np.float32)
        gx += (xb.T @ xb).astype(np.float64)
    res = fit_mrdmd_gram(
        gx, dt=dt, rank=rank, max_levels=max_levels, max_cycles=max_cycles
    )
    if not return_modes:
        return res

    # second pass: modes per level from the time-side maps, blockwise
    t_used = res.t_used
    mode_buf = [
        np.zeros(
            (lv.mode_map.shape[0], n_rows, rank), np.complex64
        )
        for lv in res.levels
    ]
    for r0, blk in prefetched_row_blocks(path, n_rows, block_rows):
        if blk.dtype == np.uint16:
            blk = blk.view(ml_dtypes.bfloat16)
        xb = np.asarray(blk, np.float32)[:, :t_used]
        r1 = r0 + xb.shape[0]
        for li, lv in enumerate(res.levels):
            for w in range(lv.mode_map.shape[0]):
                mode_buf[li][w, r0:r1] = xb @ lv.mode_map[w]
    levels = [
        lv._replace(modes=mode_buf[li]) for li, lv in enumerate(res.levels)
    ]
    return res._replace(levels=levels)
