"""Optimized DMD via variable projection (Askham & Kutz).

The algorithm the reference pipeline feeds but never implements
(/root/reference/README.md:85,139; SURVEY.md fact 2): fit

    X^T ~ Phi(alpha) B,   Phi(alpha)_{i,j} = exp(alpha_j * t_i)

over continuous-time eigenvalues alpha (complex, r of them) with the
linear coefficients B eliminated by least squares (variable projection),
minimized by Levenberg-Marquardt.

Design decisions:

- The fit runs in the POD-projected space: with X ~ U S V^T from the
  sharded SVD, the projected data H = (S V)^T is (T, k) — tiny and
  replicated — so the LM loop is pure small-matrix work that XLA keeps
  on-chip, while every S-proportional contraction (projection, final
  mode lift U @ B^T) is a skinny sharded GEMM.
- No hand-derived variable-projection Jacobian: the residual (including
  the eliminated B(alpha) through the normal-equations solve) is
  differentiated with ``jax.jacfwd`` over the stacked real/imag
  parameters.  2r forward passes over a (T, k) residual is negligible,
  and it is exactly the kind of structured autodiff JAX exists for.
- Complex solves are reformulated as real block systems
  (utils.linalg.complex_solve), with no complex LU; the
  nonsymmetric eigen-init goes through a host callback (eig_host).
- The LM loop is a ``lax.while_loop`` with accept/reject damping —
  compiler-friendly control flow, one trace, static shapes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from dmd_era5_tpu.parallel.mesh import AXIS_DATA
from dmd_era5_tpu.utils.linalg import eig_host, lstsq_implicit, spd_solve

HIGHEST = lax.Precision.HIGHEST

__all__ = [
    "OptDMDResult",
    "BatchedOptDMDResult",
    "fit_optdmd",
    "optdmd_from_svd",
    "optdmd_from_svd_batched",
    "varpro_lm",
    "varpro_lm_batched",
    "varpro_lm_checkpointed",
]


class OptDMDResult(NamedTuple):
    """Optimized-DMD fit.

    alpha:       (r,) complex continuous-time eigenvalues.
    modes:       (S, r) complex spatial modes, unit-normalized columns.
    amplitudes:  (r,) real nonnegative mode amplitudes.
    b_proj:      (r, k) complex coefficients in the POD basis.
    residual:    final relative residual ||H - Phi B|| / ||H||.
    n_iters:     LM iterations taken.
    """

    alpha: jax.Array
    modes: jax.Array
    amplitudes: jax.Array
    b_proj: jax.Array
    residual: jax.Array
    n_iters: jax.Array


def _phi_matrix(alpha: jax.Array, t: jax.Array) -> jax.Array:
    """Phi(alpha) = exp(t outer alpha), shape (T, r)."""
    return jnp.exp(jnp.outer(t.astype(alpha.dtype), alpha))


def _solve_b(phi: jax.Array, h: jax.Array, ridge: float) -> jax.Array:
    """B = argmin ||Phi B - H||, (r, k).

    Uses the implicit-differentiation solve (utils.linalg.lstsq_implicit)
    so the LM Jacobian's 2r forward passes reuse the primal normal
    equations instead of retracing the factorization — the custom
    derivative rule for the variable-projection residual.

    The basis is COLUMN-EQUILIBRATED first (the reconditioning
    complex_lstsq's contract expects of its caller): with
    D = diag(1/||phi_j||), solve (Phi D) Y = H and return B = D Y —
    algebraically the same B, but the equilibrated normal matrix has a
    unit diagonal, so strongly damped eigenvalues (exp(alpha t) columns
    spanning many decades — routine after an exact-DMD init on noisy
    data, where every |lambda| < 1) no longer drive the f32 Gram
    singular (observed: nan amplitudes on a 48 h hourly window).  B is
    invariant to D, so the scaling sits outside the implicit-diff rule
    (stop_gradient).  A floor of 1e-7 relative ridge on the unit
    diagonal keeps fully underflowed columns solvable (their B rows
    come back ~0 instead of nan).
    """
    scale = lax.stop_gradient(
        1.0 / jnp.maximum(jnp.linalg.norm(phi, axis=-2), 1e-30)
    )
    y = lstsq_implicit(phi * scale[None, :], h, max(ridge, 1e-7))
    return y * scale[:, None]


def _pack(alpha: jax.Array) -> jax.Array:
    return jnp.concatenate([jnp.real(alpha), jnp.imag(alpha)])


def _unpack(theta: jax.Array) -> jax.Array:
    r = theta.shape[0] // 2
    return theta[:r] + 1j * theta[r:]


@functools.partial(
    jax.jit,
    static_argnames=(
        "max_iter", "tol", "lambda_up", "lambda_down", "ridge",
    ),
)
def _lm_core(
    h_re,
    h_im,
    t,
    theta0,
    lam0,
    rnorm0,
    it0,
    done0,
    *,
    max_iter: int,
    tol: float,
    lambda_up: float,
    lambda_down: float,
    ridge: float,
):
    """The jitted LM engine.  All inputs/outputs are REAL arrays — no
    complex array crosses the host/device boundary, so the complex data is assembled on device from its real
    and imaginary parts and decomposed again on the way out."""
    h = h_re + 1j * h_im
    h_norm = jnp.linalg.norm(h)

    def residual_vec(theta: jax.Array) -> jax.Array:
        alpha = _unpack(theta)
        phi = _phi_matrix(alpha, t)
        b = _solve_b(phi, h, ridge)
        res = h - jnp.matmul(phi, b, precision=HIGHEST)
        return jnp.concatenate([jnp.real(res).ravel(), jnp.imag(res).ravel()])

    def res_norm(theta: jax.Array) -> jax.Array:
        return jnp.linalg.norm(residual_vec(theta))

    # fresh start (it0 == 0): the residual at theta0 seeds rnorm
    rnorm_init = jnp.where(it0 == 0, res_norm(theta0), rnorm0)

    lam_cap = 1e12

    def cond(state):
        theta, lam, rnorm, it, done = state
        return jnp.logical_and(it < max_iter, jnp.logical_not(done))

    def body(state):
        theta, lam, rnorm, it, was_done = state
        jac = jax.jacfwd(residual_vec)(theta)  # (2Tk, 2r)
        res = residual_vec(theta)
        jtj = jnp.matmul(jac.T, jac, precision=HIGHEST)
        g = jnp.matmul(jac.T, res, precision=HIGHEST)
        diag = jnp.diagonal(jtj)
        diag = jnp.where(diag <= 0, 1.0, diag)

        # Classic LM damping escalation, traced: keep raising lambda
        # until a step is ACCEPTED (residual decreases) or lambda passes
        # the cap — a fixed trial count stops early on stiff spectra
        # where the gradient direction only helps at strong damping.
        def try_cond(s):
            lam_try, accepted, _, _ = s
            return jnp.logical_and(
                jnp.logical_not(accepted), lam_try <= lam_cap
            )

        def try_body(s):
            lam_try, _, _, _ = s
            a = jtj + lam_try * jnp.diag(diag)
            # SPD by construction: GEMM-based solve (utils.linalg)
            delta = spd_solve(a, g[:, None])[:, 0]
            theta_try = theta - delta
            r_try = res_norm(theta_try)
            ok = r_try < rnorm
            return (
                jnp.where(ok, lam_try, lam_try * lambda_up),
                ok,
                theta_try,
                r_try,
            )

        lam_acc, accepted, theta_try, r_try = lax.while_loop(
            try_cond,
            try_body,
            (lam, jnp.bool_(False), theta, rnorm),
        )

        theta_new = jnp.where(accepted, theta_try, theta)
        rnorm_new = jnp.where(accepted, r_try, rnorm)
        lam_new = jnp.where(accepted, lam_acc / lambda_down, lam_acc)
        improved = (rnorm - rnorm_new) > tol * jnp.maximum(rnorm, 1e-30)
        done = jnp.logical_or(
            jnp.logical_not(improved), jnp.logical_not(accepted)
        )
        # Gate on the incoming done flag so an element that has finished
        # is a strict no-op — required for exact per-member semantics
        # when this while_loop runs lock-step under vmap (the batched
        # ensemble path), and harmless otherwise (cond stops the loop).
        return (
            jnp.where(was_done, theta, theta_new),
            jnp.where(was_done, lam, lam_new),
            jnp.where(was_done, rnorm, rnorm_new),
            jnp.where(was_done, it, it + 1),
            jnp.logical_or(was_done, done),
        )

    state0 = (theta0, lam0, rnorm_init, it0, done0)
    theta, lam, rnorm, n_iters, done = lax.while_loop(cond, body, state0)
    alpha = _unpack(theta)
    phi = _phi_matrix(alpha, t)
    b = _solve_b(phi, h, ridge)
    return (
        theta, lam, rnorm, n_iters, done,
        jnp.real(b), jnp.imag(b), rnorm / h_norm,
    )


def varpro_lm(
    h,
    t,
    alpha0,
    max_iter: int = 50,
    tol: float = 1e-7,
    lambda0: float = 1.0,
    lambda_up: float = 4.0,
    lambda_down: float = 5.0,
    ridge: float = 0.0,
    state0=None,
    return_state: bool = False,
):
    """Levenberg-Marquardt over alpha with B eliminated by projection.

    Args:
        h: (T, k) complex data, time-major (projected snapshots); host
            numpy or any array — moved through a real-valued boundary.
        t: (T,) sample times.
        alpha0: (r,) complex initial eigenvalues.
        state0: optional resume state (theta, lam, rnorm, it, done) from
            a previous call's ``return_state=True`` output — the
            checkpoint/resume hook (see varpro_lm_checkpointed).

    Returns:
        (alpha, B, rel_residual, n_iters[, state]) with alpha and B as
        host complex arrays.
    """
    h_host = np.asarray(jax.device_get(h), dtype=np.complex64)
    t_arr = jnp.asarray(np.asarray(jax.device_get(t), dtype=np.float32))
    alpha0_host = np.asarray(jax.device_get(alpha0), dtype=np.complex64)
    theta0 = jnp.asarray(
        np.concatenate([alpha0_host.real, alpha0_host.imag]).astype(np.float32)
    )
    if state0 is None:
        lam0 = jnp.float32(lambda0)
        rnorm0 = jnp.float32(0.0)
        it0 = jnp.int32(0)
        done0 = jnp.bool_(False)
    else:
        theta0, lam0, rnorm0, it0, done0 = (jnp.asarray(s) for s in state0)

    theta, lam, rnorm, n_iters, done, b_re, b_im, rel = _lm_core(
        jnp.asarray(h_host.real),
        jnp.asarray(h_host.imag),
        t_arr,
        theta0,
        lam0,
        rnorm0,
        it0,
        done0,
        max_iter=max_iter,
        tol=tol,
        lambda_up=lambda_up,
        lambda_down=lambda_down,
        ridge=ridge,
    )
    theta_host = np.asarray(theta)
    r = theta_host.shape[0] // 2
    alpha = (theta_host[:r] + 1j * theta_host[r:]).astype(np.complex64)
    # a diverged fit can return inf coefficients; assembling inf*1j
    # raises under warnings-as-errors, but the caller (e.g. BOP-DMD
    # trial filtering) wants the non-finite values, not a crash
    with np.errstate(invalid="ignore"):
        b = (np.asarray(b_re) + 1j * np.asarray(b_im)).astype(np.complex64)
    if return_state:
        return alpha, b, rel, n_iters, (theta, lam, rnorm, n_iters, done)
    return alpha, b, rel, n_iters


def varpro_lm_batched(
    h,
    t,
    alpha0,
    max_iter: int = 50,
    tol: float = 1e-7,
    lambda0: float = 1.0,
    lambda_up: float = 4.0,
    lambda_down: float = 5.0,
    ridge: float = 0.0,
    mesh=None,
):
    """Batched LM over independent members: ONE jit, vmapped _lm_core.

    The DP/EP solver analogue: B independent variable-projection fits
    run lock-step inside one vmapped while_loop.  Per-member semantics
    are exact — the done flag gates every state update, so a member
    that converges early is a strict no-op while its batch-mates finish
    (verified against the per-member loop in tests/test_14_ensemble.py).

    h: (B, T, k) complex; t: (T,) shared sample times, or (B, T) for
    per-member sample times (the bagging/BOP-DMD case — every trial
    fits a different snapshot subset); alpha0: (B, r).
    Returns (alpha (B, r), B (B, r, k), rel_residual (B,), n_iters (B,))
    as host arrays.

    ``mesh``: optional (data, space, time) mesh — when its ``data``
    axis is sharded, the batch is EP-sharded over it via shard_map
    (members padded to a multiple of the axis size); trials are
    independent, so no collectives are emitted at all.
    """
    h_host = np.asarray(jax.device_get(h), dtype=np.complex64)
    t_host = np.asarray(jax.device_get(t), dtype=np.float32)
    t_axis = 0 if t_host.ndim == 2 else None
    t_arr = jnp.asarray(t_host)
    a0 = np.asarray(jax.device_get(alpha0), dtype=np.complex64)
    theta0 = jnp.asarray(
        np.concatenate([a0.real, a0.imag], axis=-1).astype(np.float32)
    )
    n_batch = theta0.shape[0]
    core = functools.partial(
        _lm_core,
        max_iter=max_iter,
        tol=tol,
        lambda_up=lambda_up,
        lambda_down=lambda_down,
        ridge=ridge,
    )
    vcore = jax.vmap(core, in_axes=(0, 0, t_axis, 0, 0, 0, 0, 0))
    args = [
        jnp.asarray(h_host.real),
        jnp.asarray(h_host.imag),
        t_arr,
        theta0,
        jnp.full((n_batch,), lambda0, jnp.float32),
        jnp.zeros((n_batch,), jnp.float32),
        jnp.zeros((n_batch,), jnp.int32),
        jnp.zeros((n_batch,), bool),
    ]
    n_data = 1 if mesh is None else int(mesh.shape.get(AXIS_DATA, 1))
    if n_data > 1:
        from jax.sharding import PartitionSpec as P

        pad = (-n_batch) % n_data
        if pad:
            # pad with copies of member 0 (independent fits; dropped below)
            args = [
                a
                if i == 2 and t_axis is None
                else jnp.concatenate([a, jnp.repeat(a[:1], pad, axis=0)])
                for i, a in enumerate(args)
            ]
        batch_spec = P(AXIS_DATA)
        t_spec = batch_spec if t_axis == 0 else P()
        specs = (
            batch_spec, batch_spec, t_spec, batch_spec,
            batch_spec, batch_spec, batch_spec, batch_spec,
        )
        out = jax.shard_map(
            vcore,
            mesh=mesh,
            in_specs=specs,
            out_specs=batch_spec,
            check_vma=False,
        )(*args)
        theta, _lam, _rn, n_iters, _done, b_re, b_im, rel = (
            o[:n_batch] for o in out
        )
    else:
        theta, _lam, _rn, n_iters, _done, b_re, b_im, rel = vcore(*args)
    theta_host = np.asarray(theta)
    r = theta_host.shape[1] // 2
    alpha = (theta_host[:, :r] + 1j * theta_host[:, r:]).astype(np.complex64)
    # a diverged fit can return inf coefficients; assembling inf*1j
    # raises under warnings-as-errors, but the caller (e.g. BOP-DMD
    # trial filtering) wants the non-finite values, not a crash
    with np.errstate(invalid="ignore"):
        b = (np.asarray(b_re) + 1j * np.asarray(b_im)).astype(np.complex64)
    return alpha, b, np.asarray(rel), np.asarray(n_iters)


def varpro_lm_checkpointed(
    h: jax.Array,
    t: jax.Array,
    alpha0: jax.Array,
    checkpoint_path: str,
    max_iter: int = 50,
    chunk_iters: int = 10,
    tol: float = 1e-7,
):
    """Checkpointed LM: run in chunks, persisting solver state to HDF5.

    A killed solve resumes from the last completed chunk (SURVEY.md
    section 5, checkpoint/resume for the iterative solvers).  Each chunk
    is one jit-compiled ``varpro_lm`` segment whose while_loop cap is the
    chunk's absolute iteration bound.
    """
    from pathlib import Path

    from dmd_era5_tpu.utils.checkpoint import load_pytree, save_pytree

    state = None
    start_iter = 0
    path = Path(checkpoint_path)
    if path.exists():
        a0 = np.asarray(jax.device_get(alpha0), dtype=np.complex64)
        template = (
            jnp.asarray(
                np.concatenate([a0.real, a0.imag]).astype(np.float32)
            ),
            jnp.float32(0),
            jnp.float32(0),
            jnp.int32(0),
            jnp.bool_(False),
        )
        state, meta = load_pytree(path, like=template)
        state = tuple(jnp.asarray(s) for s in state)
        start_iter = int(state[3])

    it = start_iter
    result = None
    while it < max_iter:
        cap = min(it + chunk_iters, max_iter)
        alpha, b, rel, n_iters, state = varpro_lm(
            h, t, alpha0, max_iter=cap, tol=tol,
            state0=state, return_state=True,
        )
        result = (alpha, b, rel, n_iters)
        save_pytree(path, state, metadata={"iteration": int(n_iters)})
        it = int(n_iters)
        if bool(state[4]) or it >= max_iter:  # done flag
            break
        if it == start_iter:  # no progress (converged at cap boundary)
            break
        start_iter = it
    if result is None:
        alpha, b, rel, n_iters, state = varpro_lm(
            h, t, alpha0, max_iter=max_iter, tol=tol,
            state0=state, return_state=True,
        )
        result = (alpha, b, rel, n_iters)
    return result


def _eig_init(z: jax.Array, t, rank: int) -> np.ndarray:
    """Exact-DMD eigenvalue init on the projected data z (k, T).

    Returns HOST complex eigenvalues (the small eigenproblem lives on
    host anyway).
    """
    t_host = np.asarray(jax.device_get(t), dtype=np.float64)
    dt = float(t_host[1] - t_host[0])
    z1, z2 = z[:, :-1], z[:, 1:]
    u, s, vt = jnp.linalg.svd(z1.astype(jnp.float32), full_matrices=False)
    u, s, vt = u[:, :rank], s[:rank], vt[:rank, :]
    atilde = jnp.matmul(
        jnp.matmul(u.T, z2, precision=HIGHEST),
        vt.T / s[None, :],
        precision=HIGHEST,
    )
    eigvals, _ = eig_host(atilde)  # host complex (eager path)
    return (np.log(np.asarray(eigvals)) / dt).astype(np.complex64)


def _eig_init_batched(z: jax.Array, t, rank: int) -> np.ndarray:
    """Batched exact-DMD eigenvalue init on projected data z (B, k, T)."""
    t_host = np.asarray(jax.device_get(t), dtype=np.float64)
    dt = float(t_host[1] - t_host[0])
    z1, z2 = z[..., :-1], z[..., 1:]
    u, s, vt = jnp.linalg.svd(z1.astype(jnp.float32), full_matrices=False)
    u = u[..., :rank]
    s = s[..., :rank]
    vt = vt[..., :rank, :]
    atilde = jnp.matmul(
        jnp.matmul(jnp.swapaxes(u, -1, -2), z2, precision=HIGHEST),
        jnp.swapaxes(vt, -1, -2) / s[..., None, :],
        precision=HIGHEST,
    )  # (B, r, r)
    w, _ = np.linalg.eig(np.asarray(jax.device_get(atilde), dtype=np.complex64))
    order = np.argsort(-np.abs(w), axis=-1, kind="stable")
    w = np.take_along_axis(w, order, axis=-1)
    return (np.log(w) / dt).astype(np.complex64)


class BatchedOptDMDResult(NamedTuple):
    """Per-member optimized-DMD fits from one batched solve.

    alpha (B, r) complex; modes (B, S, r) complex (unit columns);
    amplitudes (B, r) real; b_proj (B, r, k) complex; residual (B,);
    n_iters (B,).
    """

    alpha: np.ndarray
    modes: np.ndarray
    amplitudes: np.ndarray
    b_proj: np.ndarray
    residual: np.ndarray
    n_iters: np.ndarray


def optdmd_from_svd_batched(
    u: jax.Array,
    s: jax.Array,
    v: jax.Array,
    t: jax.Array,
    rank: int | None = None,
    alpha0: np.ndarray | None = None,
    max_iter: int = 50,
    tol: float = 1e-7,
) -> BatchedOptDMDResult:
    """Batched optimized DMD from batched truncated SVDs.

    The ensemble (DP/EP) analogue of :func:`optdmd_from_svd`: u (B, S,
    k), s (B, k), v (B, k, T) — e.g. the FitState of
    ``pipeline.ensemble.fit_per_variable_level`` — solved by ONE
    vmapped LM; the mode lift is one batched skinny GEMM.
    """
    k = s.shape[-1]
    rank = rank or k
    z_proj = s[..., None] * v  # (B, k, T)
    h = np.asarray(jax.device_get(z_proj)).transpose(0, 2, 1)  # (B, T, k)

    if alpha0 is None:
        alpha0 = _eig_init_batched(z_proj, t, rank)

    alpha, b, rel, n_iters = varpro_lm_batched(
        h, t, alpha0, max_iter=max_iter, tol=tol
    )

    amps = np.linalg.norm(b, axis=2)  # (B, r)
    safe = np.where(amps == 0, 1.0, amps)
    # diverged members carry inf/nan coefficients (callers filter);
    # don't let the normalization trip warnings-as-errors
    with np.errstate(invalid="ignore", divide="ignore"):
        coef = (b / safe[..., None]).transpose(0, 2, 1)  # (B, k, r)
    m_re = jnp.matmul(
        u, jnp.asarray(coef.real.astype(np.float32)), precision=HIGHEST
    )
    m_im = jnp.matmul(
        u, jnp.asarray(coef.imag.astype(np.float32)), precision=HIGHEST
    )
    modes = (
        np.asarray(jax.device_get(m_re))
        + 1j * np.asarray(jax.device_get(m_im))
    ).astype(np.complex64)
    return BatchedOptDMDResult(
        alpha,
        modes,
        amps.astype(np.float32),
        b,
        np.asarray(rel, dtype=np.float32),
        np.asarray(n_iters, dtype=np.int32),
    )


def optdmd_from_svd(
    u: jax.Array,
    s: jax.Array,
    v: jax.Array,
    t: jax.Array,
    rank: int | None = None,
    alpha0: jax.Array | None = None,
    max_iter: int = 50,
    tol: float = 1e-7,
) -> OptDMDResult:
    """Optimized DMD from the truncated SVD of the snapshot matrix.

    Args:
        u: (S, k) left singular vectors (may be space-sharded).
        s: (k,) singular values.
        v: (k, T) right singular vectors (component-major rows).
        t: (T,) sample times (uniform or not — varpro does not care).
        rank: number of eigenvalues r <= k (default k).

    The variable-projection fit sees only H = (diag(s) V)^T, shape
    (T, k); the single S-sized operation is the final mode lift.
    """
    k = s.shape[0]
    rank = rank or k
    z_proj = s[:, None] * v  # (k, T) projected snapshots, real
    h = np.asarray(jax.device_get(z_proj)).T  # (T, k) host

    if alpha0 is None:
        alpha0 = _eig_init(z_proj, t, rank)

    alpha, b, rel_res, n_iters = varpro_lm(
        h, t, alpha0, max_iter=max_iter, tol=tol
    )

    # Amplitudes: ||U B^T e_j|| = ||B[j, :]|| since U is orthonormal.
    amps = np.linalg.norm(b, axis=1)
    safe = np.where(amps == 0, 1.0, amps)
    # diverged fits carry inf/nan amplitudes (callers filter); keep the
    # normalization quiet under warnings-as-errors
    with np.errstate(invalid="ignore", divide="ignore"):
        coef = (b / safe[:, None]).T  # (k, r) host complex
    # mode lift: the single S-sized op, as two REAL device GEMMs (no
    # complex transfers), assembled into host complex
    m_re = jnp.matmul(
        u, jnp.asarray(coef.real.astype(np.float32)), precision=HIGHEST
    )
    m_im = jnp.matmul(
        u, jnp.asarray(coef.imag.astype(np.float32)), precision=HIGHEST
    )
    modes = (
        np.asarray(jax.device_get(m_re))
        + 1j * np.asarray(jax.device_get(m_im))
    ).astype(np.complex64)
    return OptDMDResult(
        alpha, modes, amps.astype(np.float32), b,
        np.float32(jax.device_get(rel_res)),
        np.int32(jax.device_get(n_iters)),
    )


def fit_optdmd(
    x: jax.Array,
    t: jax.Array,
    rank: int,
    max_iter: int = 50,
    tol: float = 1e-7,
) -> OptDMDResult:
    """Optimized DMD of a (S, T) snapshot matrix (single-device entry).

    The sharded pipeline composes ``ops.truncated_svd`` (distributed)
    with :func:`optdmd_from_svd` instead.
    """
    u, sv, vt = jnp.linalg.svd(x.astype(jnp.float32), full_matrices=False)
    u, sv, vt = u[:, :rank], sv[:rank], vt[:rank, :]
    return optdmd_from_svd(u, sv, vt, t, rank=rank, max_iter=max_iter, tol=tol)


def optdmd_reconstruct(result: OptDMDResult, t) -> jax.Array:
    """X^(S, T') = modes diag(amplitudes) exp(alpha t) — real part."""
    from dmd_era5_tpu.models.forecast import rollout

    return rollout(result, t)
