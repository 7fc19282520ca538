"""DMD with control (DMDc) — dynamics with exogenous forcing.

Proctor, Brunton & Kutz, "Dynamic mode decomposition with control"
(SIAM J. Appl. Dyn. Syst., 2016): disambiguate the unforced dynamics A
from the effect of a measured input, fitting

    x_{k+1} ~ A x_k + B u_k

from snapshots X (S, T) and inputs U (q, T-1).  For ERA5 this separates
internal atmospheric dynamics from known forcings (e.g. solar cycle,
prescribed boundary conditions) — an extension of the plain
decomposition the reference pipeline feeds
(/root/reference/README.md:85,139).

Shape: both truncated SVDs (the stacked [X1; U] input basis
and the X2 output basis) go through the Gram-route exact SVD
(ops.svd.exact_truncated_svd_gram,
mesh/psum-aware for space-sharded snapshots); every S-sized contraction
is a skinny GEMM, the reduced operators live in the (r, r)/(r, q) space,
and the only host work is the r x r nonsymmetric eigendecomposition.
Prediction rolls the REDUCED state with ``lax.scan`` (static shapes,
one trace) and lifts once at the end with a single (S, r) GEMM.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from dmd_era5_tpu.utils.linalg import eig_host

HIGHEST = lax.Precision.HIGHEST

__all__ = ["DMDcResult", "fit_dmdc", "dmdc_from_svd", "dmdc_rollout"]


def _gemm(a, b):
    return jnp.matmul(
        a, b, preferred_element_type=jnp.float32, precision=HIGHEST
    )


class DMDcResult(NamedTuple):
    """DMD-with-control fit.

    eigenvalues: (r,) complex discrete-time eigenvalues of the UNFORCED
                 reduced operator A_red.
    omega:       (r,) complex continuous-time log(eigenvalues)/dt.
    modes:       (S, r) complex DMD modes of A, unit columns.
    a_red:       (r, r) reduced dynamics U_hat^T A U_hat.
    b_red:       (r, q) reduced input map U_hat^T B.
    u_hat:       (S, r) output POD basis (real) — the lift/restrict map
                 for :func:`dmdc_rollout`.
    dt:          sampling interval.
    """

    eigenvalues: np.ndarray
    omega: np.ndarray
    modes: np.ndarray
    a_red: jax.Array
    b_red: jax.Array
    u_hat: jax.Array
    dt: float
    residual: float = float("nan")


def fit_dmdc(
    x: jax.Array,
    u_ctrl: jax.Array,
    rank: int,
    rank_omega: int | None = None,
    dt: float = 1.0,
    mesh=None,
) -> DMDcResult:
    """Fit x_{k+1} ~ A x_k + B u_k from snapshots and measured inputs.

    Args:
        x: (S, T) snapshot matrix.
        u_ctrl: (q, T-1) control inputs aligned with transitions
            x_k -> x_{k+1} (input u_k acts on step k).
        rank: truncation r of the output basis (and of A_red).
        rank_omega: truncation p of the stacked input SVD
            (default rank + q — the input space must at least span the
            output space plus the controls).
        dt: sampling interval.
        mesh: optional device mesh forwarded to the Gram-route SVDs
            (space-sharded snapshots psum their T x T Grams over it).

    Algebra (Proctor et al. section 3.3): with Omega = [X1; U] ~
    Ut St Vt^T (rank p) split into Ut = [Ut1; Ut2] and X2 ~ Uh Sh Vh^T
    (rank r),

        A_red = Uh^T X2 Vt St^-1 Ut1^T Uh,
        B_red = Uh^T X2 Vt St^-1 Ut2^T,

    and the exact modes of A are Phi = X2 Vt St^-1 Ut1^T Uh W.
    """
    from dmd_era5_tpu.ops.svd import exact_truncated_svd_gram

    x = jnp.asarray(x, jnp.float32)
    u_ctrl = jnp.asarray(u_ctrl, jnp.float32)
    s_rows, t_total = x.shape
    q = u_ctrl.shape[0]
    if u_ctrl.shape[1] != t_total - 1:
        raise ValueError(
            f"u_ctrl must be (q, T-1) = (q, {t_total - 1}); "
            f"got {tuple(u_ctrl.shape)}"
        )
    p = rank + q if rank_omega is None else rank_omega
    if p < 1:
        raise ValueError(f"rank_omega must be >= 1; got {rank_omega}")

    x1 = x[:, :-1]
    x2 = x[:, 1:]
    # Row-balance the control block before stacking (review r4): the
    # conditioning cutoff below works on the stacked SVD's spectrum, so
    # when state magnitudes dwarf control magnitudes (unstandardized
    # physical units, large leading POD values) the control-subspace
    # directions fall under the cutoff and B_red silently degenerates
    # to zero — plain DMD with no warning.  Scaling U to the state
    # block's RMS makes the stack isotropic; the fit then estimates
    # G_gamma = [A, B/gamma] and the undo on B_red below recovers B
    # exactly (X2 = [A B][X1; U] = [A, B/gamma][X1; gamma U]).
    x1_rms = jnp.sqrt(jnp.mean(jnp.square(x1)))
    u_rms = jnp.sqrt(jnp.mean(jnp.square(u_ctrl)))
    gamma = jnp.where(
        (u_rms > 0.0) & (x1_rms > 0.0), x1_rms / jnp.maximum(u_rms, 1e-30), 1.0
    )
    omega_mat = jnp.concatenate([x1, gamma * u_ctrl], axis=0)  # (S+q, T-1)

    ut, st, vtt = exact_truncated_svd_gram(omega_mat, p, mesh=mesh)
    uh, _sh, _vh = exact_truncated_svd_gram(x2, rank, mesh=mesh)

    ut1 = ut[:s_rows]  # (S, p)
    ut2 = ut[s_rows:]  # (q, p)

    # core factor K = X2 Vt St^-1, (S, p): ONE skinny S-GEMM, reused by
    # A_red, B_red and the mode lift.  Directions below the Gram route's
    # ~sqrt(eps_f32) conditioning floor are DEAD — when p exceeds the
    # numerical rank of [X1; U], 1/s would amplify garbage into
    # A_red/B_red/modes, so zero them instead (same relative cutoff as
    # mrdmd._level_core, and for the same reason).
    st_inv = jnp.where(st > 1e-3 * st[0], 1.0 / jnp.maximum(st, 1e-30), 0.0)
    k_fac = _gemm(x2, vtt.T * st_inv[None, :])  # (S, p)

    uh_t_k = _gemm(uh.T, k_fac)  # (r, p)
    ut1_t_uh = _gemm(ut1.T, uh)  # (p, r)
    a_red = _gemm(uh_t_k, ut1_t_uh)  # (r, r)
    # the fitted input map acts on the SCALED controls (gamma u); undo
    # the balancing so b_red applies to the caller's raw units
    b_red = gamma * _gemm(uh_t_k, ut2.T)  # (r, q)

    # eig of the reduced unforced operator; host callback
    # (utils.linalg.eig_host), exact modes via the K factor
    eigvals, w = eig_host(a_red)
    eigvals = np.asarray(eigvals)
    w = np.asarray(w)

    m = _gemm(k_fac, ut1_t_uh)  # (S, r) real mode pre-factor
    phi = (
        np.asarray(jax.device_get(_gemm(m, jnp.asarray(w.real))))
        + 1j * np.asarray(jax.device_get(_gemm(m, jnp.asarray(w.imag))))
    ).astype(np.complex64)
    norms = np.linalg.norm(phi, axis=0)
    norms = np.where(norms == 0, 1.0, norms)
    phi = phi / norms[None, :]

    # one-step-ahead relative residual in the reduced space: how much
    # of each transition the forced model A z + B u explains
    zr1 = _gemm(uh.T, x1)  # (r, T-1)
    zr2 = _gemm(uh.T, x2)
    pred = _gemm(a_red, zr1) + _gemm(b_red, u_ctrl)
    residual = float(
        jnp.linalg.norm(zr2 - pred)
        / jnp.maximum(jnp.linalg.norm(zr2), 1e-30)
    )

    with np.errstate(divide="ignore", invalid="ignore"):
        omega = (np.log(eigvals.astype(np.complex128)) / dt).astype(
            np.complex64
        )
    return DMDcResult(
        eigenvalues=eigvals.astype(np.complex64),
        omega=omega,
        modes=phi,
        a_red=a_red,
        b_red=b_red,
        u_hat=uh,
        dt=dt,
        residual=residual,
    )


def dmdc_from_svd(
    u: jax.Array,
    s: jax.Array,
    v: jax.Array,
    u_ctrl: jax.Array,
    rank: int,
    rank_omega: int | None = None,
    dt: float = 1.0,
    mesh=None,
) -> DMDcResult:
    """DMDc from the truncated SVD factors of the snapshot matrix.

    The pipeline entry (pipeline/era5_dmd.py): with X ~ U S V^T from
    the sharded SVD stage, the forced dynamics are fit on the PROJECTED
    snapshots Z = S V^T (k, T) — every Omega/X2 factorization is
    k-sized — and the modes and lift basis come back to full space with
    ONE skinny GEMM against U, the same space-vs-POD split as
    optdmd_from_svd / mrdmd_from_svd.  Control inputs act in their own
    q-space and are untouched by the projection.

    u: (S, k); s: (k,); v: (k, T); u_ctrl: (q, T-1); rank <= k.
    """
    u = jnp.asarray(u, jnp.float32)
    z = jnp.asarray(s, jnp.float32)[:, None] * jnp.asarray(v, jnp.float32)
    res = fit_dmdc(
        z, u_ctrl, rank=rank, rank_omega=rank_omega, dt=dt, mesh=mesh
    )
    # lift: modes (k, r) complex and u_hat (k, r) real -> (S, r)
    modes_re = _gemm(u, jnp.asarray(res.modes.real.astype(np.float32)))
    modes_im = _gemm(u, jnp.asarray(res.modes.imag.astype(np.float32)))
    modes = (
        np.asarray(jax.device_get(modes_re))
        + 1j * np.asarray(jax.device_get(modes_im))
    ).astype(np.complex64)
    norms = np.linalg.norm(modes, axis=0)
    norms = np.where(norms == 0, 1.0, norms)
    modes = modes / norms[None, :]
    u_hat = _gemm(u, res.u_hat)  # (S, r), orthonormal since U is
    return res._replace(modes=modes, u_hat=u_hat)


def dmdc_rollout(
    result: DMDcResult, x0: jax.Array, u_ctrl: jax.Array
) -> jax.Array:
    """Forced prediction x_{k+1} = A x_k + B u_k from an initial state.

    x0: (S,) initial snapshot; u_ctrl: (q, n_steps) inputs.  Returns
    (S, n_steps + 1) including x0.  The recursion runs entirely in the
    reduced space under ``lax.scan``; the lift back to S rows is one
    GEMM at the end (sharded over space when u_hat is).
    """
    x0 = jnp.asarray(x0, jnp.float32)
    u_ctrl = jnp.asarray(u_ctrl, jnp.float32)
    z0 = _gemm(result.u_hat.T, x0[:, None])[:, 0]  # (r,)

    def step(z, u_k):
        z_next = (
            _gemm(result.a_red, z[:, None])[:, 0]
            + _gemm(result.b_red, u_k[:, None])[:, 0]
        )
        return z_next, z_next

    _, zs = lax.scan(step, z0, u_ctrl.T)  # (n_steps, r)
    z_all = jnp.concatenate([z0[None], zs], axis=0)  # (n_steps+1, r)
    return _gemm(result.u_hat, z_all.T)  # (S, n_steps+1)
