"""Exact (projected) Dynamic Mode Decomposition.

The reference cites DMD as the purpose of its SVD pipeline but stops at
the truncated SVD (/root/reference/README.md:85,139; SURVEY.md fact 2).
This module supplies the missing decomposition: exact DMD built from the
(U, s, V) factors, which also provides the eigenvalue initialization for
the optimized-DMD variable-projection solver (models/optdmd.py).

Convention: the snapshot matrix X is (space, time) — identical to the
output of the preprocessing chain — with uniform time step ``dt``.
The reduced operator is built from the rank-k factors only, so every
S-proportional product is a skinny GEMM that shards over the space axis.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from dmd_era5_tpu.utils.linalg import eig_host

HIGHEST = lax.Precision.HIGHEST

__all__ = ["DMDResult", "exact_dmd", "dmd_from_svd", "reconstruct"]


class DMDResult(NamedTuple):
    """Exact-DMD fit.

    eigenvalues: (r,) complex discrete-time eigenvalues (one step = dt).
    omega:       (r,) complex continuous-time eigenvalues log(lambda)/dt.
    modes:       (S, r) complex DMD modes (exact modes, unit-normalized).
    amplitudes:  (r,) complex mode amplitudes fit to the first snapshot.
    dt:          the sampling interval the eigenvalues refer to.
    """

    eigenvalues: jax.Array
    omega: jax.Array
    modes: jax.Array
    amplitudes: jax.Array
    dt: float


def dmd_from_svd(
    x2: jax.Array,
    u: jax.Array,
    s: jax.Array,
    v: jax.Array,
    dt: float = 1.0,
) -> DMDResult:
    """Exact DMD given the truncated SVD of the left-shifted snapshots.

    Args:
        x2: (S, T-1) right-shifted snapshots X[:, 1:].
        u:  (S, r) left singular vectors of X1 = X[:, :-1].
        s:  (r,) singular values of X1.
        v:  (r, T-1) right singular vectors of X1 (rows = components).
        dt: sampling interval.

    The reduced operator A~ = U^T X2 V S^-1 is r x r and replicated; its
    eigendecomposition runs redundantly on every device.  Exact modes
    Phi = X2 V S^-1 W are one skinny sharded GEMM.
    """
    s_inv = 1.0 / s
    # (r, T-1) @ (T-1, r) -> r x r ; U^T X2 is the only S-contraction.
    ut_x2 = jnp.matmul(u.T, x2, precision=HIGHEST)  # (r, T-1)
    atilde = jnp.matmul(ut_x2, v.T * s_inv[None, :], precision=HIGHEST)

    # r x r nonsymmetric eig: the replicated small problem goes through
    # a host callback (utils.linalg.eig_host); the eager path returns
    # HOST complex arrays.
    eigvals, w = eig_host(atilde)
    eigvals = np.asarray(eigvals)
    w = np.asarray(w)

    # Exact modes: Phi = X2 V S^-1 W  (S, r).  The S-sized GEMM runs on
    # device in real arithmetic; the complex combination with W's real
    # and imaginary parts is two skinny real GEMMs assembled on host.
    vs = v.T * s_inv[None, :]  # (T-1, r) real
    m = jnp.matmul(x2, vs, precision=HIGHEST)  # (S, r) device real
    phi_re = jnp.matmul(m, jnp.asarray(w.real), precision=HIGHEST)
    phi_im = jnp.matmul(m, jnp.asarray(w.imag), precision=HIGHEST)
    phi = (
        np.asarray(jax.device_get(phi_re))
        + 1j * np.asarray(jax.device_get(phi_im))
    ).astype(np.complex64)
    norms = np.linalg.norm(phi, axis=0)
    norms = np.where(norms == 0, 1.0, norms)
    phi = phi / norms[None, :]

    # Amplitudes from the first snapshot x0 = X1[:, 0] = U S V[:, 0];
    # tiny (S, r) lstsq on host complex
    x0 = np.asarray(
        jax.device_get(jnp.matmul(u, s * v[:, 0], precision=HIGHEST))
    )
    b = np.linalg.lstsq(phi, x0.astype(np.complex64), rcond=None)[0]

    omega = (np.log(eigvals) / dt).astype(np.complex64)
    return DMDResult(eigvals, omega, phi, b, dt)


def exact_dmd(x: jax.Array, rank: int, dt: float = 1.0) -> DMDResult:
    """Exact DMD of a (S, T) snapshot matrix at a given rank.

    Single-device convenience entry; the sharded pipeline composes
    ``ops.truncated_svd`` with :func:`dmd_from_svd` instead.
    """
    x1 = x[:, :-1]
    x2 = x[:, 1:]
    u, s, vt = jnp.linalg.svd(x1, full_matrices=False)
    u, s, vt = u[:, :rank], s[:rank], vt[:rank, :]
    return dmd_from_svd(x2, u, s, vt, dt=dt)


def reconstruct(result: DMDResult, n_steps: int) -> jax.Array:
    """Reconstruct/extrapolate snapshots X^(t_i) = Phi diag(b) exp(omega t).

    Returns the real part, shape (S, n_steps), t_i = i * dt.
    """
    from dmd_era5_tpu.models.forecast import rollout

    return rollout(result, np.arange(n_steps) * result.dt)
