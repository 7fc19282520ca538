"""BOP-DMD: bagging, optimized dynamic mode decomposition.

Sashidhar & Kutz, "Bagging, optimized dynamic mode decomposition for
robust, stable forecasting with spatial and temporal uncertainty
quantification" (Phil. Trans. R. Soc. A, 2022): fit optimized DMD
(Askham-Kutz variable projection — the algorithm the reference cites at
/root/reference/README.md:85,139 but does not implement) on many random
snapshot subsets, then report the trial statistics — mean eigenvalues /
modes / amplitudes plus their standard deviations, which quantify the
uncertainty of every spectral quantity.

Shape: ALL trials run lock-step in ONE jit — the bag of
variable-projection solves is a vmapped LM (``varpro_lm_batched`` with
per-member sample times) over the ``data`` axis, and the mode lifts are
two batched skinny GEMMs.  The per-trial work never touches the S-sized
snapshot matrix: trials live in the k-dimensional POD space, so bagging
costs O(n_trials * T * k^2) on top of one full-data fit.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from dmd_era5_tpu.models.optdmd import (
    OptDMDResult,
    optdmd_from_svd,
    varpro_lm_batched,
)

HIGHEST = jax.lax.Precision.HIGHEST

__all__ = ["BOPDMDResult", "bopdmd_from_svd", "fit_bopdmd"]


class BOPDMDResult(NamedTuple):
    """Trial statistics of a bagged optimized-DMD fit.

    eigenvalues / modes / amplitudes are the TRIAL MEANS (the BOP-DMD
    point estimate — generally lower-variance than any single fit); the
    ``*_std`` fields are elementwise standard deviations across trials
    (complex quantities: std of real and imaginary parts combined as
    sqrt(var_re + var_im)).  ``full`` is the single full-data fit used
    to initialize and align the trials.
    """

    eigenvalues: np.ndarray  # (r,) complex mean
    eigenvalues_std: np.ndarray  # (r,) real
    modes: np.ndarray  # (S, r) complex mean, unit columns
    modes_std: np.ndarray  # (S, r) real
    amplitudes: np.ndarray  # (r,) real mean
    amplitudes_std: np.ndarray  # (r,) real
    full: OptDMDResult
    trial_eigenvalues: np.ndarray  # (n_trials, r) complex, aligned
    n_iters: np.ndarray  # (n_trials,)


def _align_to_anchor(
    alpha_trials: np.ndarray, anchor: np.ndarray
) -> np.ndarray:
    """Per-trial permutation matching each trial's eigenvalues to the
    anchor's (optimal assignment on complex distance).

    Bagged trials converge to the same spectrum in arbitrary order;
    averaging without alignment would mix distinct eigenvalues.
    Returns (n_trials, r) integer indices: trial row -> anchor slot.
    """
    from scipy.optimize import linear_sum_assignment

    n_trials, r = alpha_trials.shape
    perms = np.empty((n_trials, r), dtype=np.int64)
    for i in range(n_trials):
        cost = np.abs(anchor[:, None] - alpha_trials[i][None, :])
        rows, cols = linear_sum_assignment(cost)
        perms[i, rows] = cols
    return perms


def bopdmd_from_svd(
    u: jax.Array,
    s: jax.Array,
    v: jax.Array,
    t: jax.Array,
    rank: int | None = None,
    n_trials: int = 20,
    trial_fraction: float = 0.8,
    seed: int = 0,
    max_iter: int = 50,
    tol: float = 1e-7,
    mesh=None,
) -> BOPDMDResult:
    """Bagged optimized DMD from the truncated SVD of the snapshots.

    Args:
        u: (S, k) left singular vectors (may be space-sharded).
        s: (k,) singular values.
        v: (k, T) right singular vectors.
        t: (T,) sample times.
        rank: eigenvalues per fit, r <= k (default k).
        n_trials: bag size (the paper uses tens to hundreds).
        trial_fraction: fraction of snapshots per trial, in (0, 1].
        seed: trial-subset RNG seed (subsets are host-sampled so the
            batched solve stays statically shaped).
        mesh: optional (data, space, time) mesh — a sharded ``data``
            axis EP-shards the bag (each device group solves its own
            trials; zero collectives, embarrassingly parallel).

    Every trial keeps its snapshot subset in time order and is
    initialized from the full-data fit's eigenvalues, so the bag
    explores the data resampling — not the optimizer's basins.
    """
    k = s.shape[-1]
    rank = rank or int(k)
    if not (0.0 < trial_fraction <= 1.0):
        raise ValueError(f"trial_fraction must be in (0, 1]: {trial_fraction}")
    t_host = np.asarray(jax.device_get(t), dtype=np.float32)
    n_time = t_host.shape[0]
    p = max(rank + 1, int(round(trial_fraction * n_time)))
    if p > n_time:
        raise ValueError(
            f"trial size {p} exceeds {n_time} snapshots (rank {rank} "
            f"needs at least rank+1 samples per trial)"
        )

    # full-data fit: the anchor (trial init + eigenvalue alignment)
    full = optdmd_from_svd(u, s, v, t, rank=rank, max_iter=max_iter, tol=tol)

    z_proj = s[..., None] * v  # (k, T) projected snapshots
    h_full = np.asarray(jax.device_get(z_proj)).T  # (T, k) host

    rng = np.random.default_rng(seed)
    idx = np.stack(
        [
            np.sort(rng.choice(n_time, size=p, replace=False))
            for _ in range(n_trials)
        ]
    )  # (n_trials, p), time-ordered
    h_b = h_full[idx]  # (n_trials, p, k)
    t_b = t_host[idx]  # (n_trials, p)
    alpha0 = np.tile(full.alpha[None, :], (n_trials, 1))

    alpha_t, b_t, _rel, n_iters = varpro_lm_batched(
        h_b, t_b, alpha0, max_iter=max_iter, tol=tol, mesh=mesh
    )

    # drop diverged trials (BOP-DMD standard practice): an LM fit on a
    # hard subset can run a growth rate to +inf, poisoning the means
    valid = np.isfinite(alpha_t).all(axis=1) & np.isfinite(b_t).all(
        axis=(1, 2)
    )
    if not valid.any():
        raise RuntimeError(
            f"all {n_trials} bagging trials diverged; the full-data fit "
            f"residual is {float(full.residual):.3e} — lower rank or "
            "raise trial_fraction"
        )
    alpha_t = alpha_t[valid]
    b_t = b_t[valid]
    n_iters = np.asarray(n_iters)[valid]
    n_trials = int(valid.sum())

    # align trials to the anchor spectrum, then aggregate
    perms = _align_to_anchor(alpha_t, full.alpha)
    rows = np.arange(n_trials)[:, None]
    alpha_t = alpha_t[rows, perms]  # (n_trials, r)
    b_t = b_t[rows, perms]  # (n_trials, r, k)

    amps_t = np.linalg.norm(b_t, axis=2)  # (n_trials, r)
    safe = np.where(amps_t == 0, 1.0, amps_t)
    coef = (b_t / safe[..., None]).transpose(0, 2, 1)  # (n_trials, k, r)
    # batched mode lift: two real GEMMs against the shared POD basis
    m_re = jnp.einsum(
        "sk,bkr->bsr",
        u.astype(jnp.float32),
        jnp.asarray(coef.real.astype(np.float32)),
        precision=HIGHEST,
    )
    m_im = jnp.einsum(
        "sk,bkr->bsr",
        u.astype(jnp.float32),
        jnp.asarray(coef.imag.astype(np.float32)),
        precision=HIGHEST,
    )
    modes_t = (
        np.asarray(jax.device_get(m_re))
        + 1j * np.asarray(jax.device_get(m_im))
    ).astype(np.complex64)  # (n_trials, S, r)

    # phase-align each trial mode to the anchor mode before averaging
    # (eigenvector phase is a gauge freedom; without this the mean
    # cancels): rotate by -arg(<anchor, trial>)
    inner = np.einsum("sr,bsr->br", np.conj(full.modes), modes_t)
    absin = np.abs(inner)
    phase = np.where(
        absin == 0, 1.0 + 0.0j, inner / np.where(absin == 0, 1.0, absin)
    )
    modes_t = modes_t * np.conj(phase)[:, None, :]

    def _cstd(x: np.ndarray, axis: int = 0) -> np.ndarray:
        return np.sqrt(
            np.var(x.real, axis=axis) + np.var(x.imag, axis=axis)
        ).astype(np.float32)

    mean_modes = modes_t.mean(axis=0)
    norms = np.linalg.norm(mean_modes, axis=0)
    mean_modes = mean_modes / np.where(norms == 0, 1.0, norms)[None, :]

    return BOPDMDResult(
        eigenvalues=alpha_t.mean(axis=0).astype(np.complex64),
        eigenvalues_std=_cstd(alpha_t),
        modes=mean_modes.astype(np.complex64),
        modes_std=_cstd(modes_t),
        amplitudes=amps_t.mean(axis=0).astype(np.float32),
        amplitudes_std=amps_t.std(axis=0).astype(np.float32),
        full=full,
        trial_eigenvalues=alpha_t.astype(np.complex64),
        n_iters=np.asarray(n_iters, dtype=np.int32),
    )


def fit_bopdmd(
    x: jax.Array,
    t: jax.Array,
    rank: int,
    n_trials: int = 20,
    trial_fraction: float = 0.8,
    seed: int = 0,
    max_iter: int = 50,
    tol: float = 1e-7,
    mesh=None,
) -> BOPDMDResult:
    """Bagged optimized DMD of a (S, T) snapshot matrix (single entry).

    The sharded pipeline composes ``ops.truncated_svd`` (distributed)
    with :func:`bopdmd_from_svd` instead.
    """
    u, sv, vt = jnp.linalg.svd(x.astype(jnp.float32), full_matrices=False)
    u, sv, vt = u[:, :rank], sv[:rank], vt[:rank, :]
    return bopdmd_from_svd(
        u,
        sv,
        vt,
        t,
        rank=rank,
        n_trials=n_trials,
        trial_fraction=trial_fraction,
        seed=seed,
        max_iter=max_iter,
        tol=tol,
        mesh=mesh,
    )
