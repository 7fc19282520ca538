"""DMD with control: operator recovery on a known forced linear system.

Oracle strategy (SURVEY.md section 4): simulate x_{k+1} = A x_k + B u_k
with KNOWN low-rank A and B and a random input sequence, then check
DMDc recovers the unforced spectrum, the reduced input map, and the
forced trajectory — and that plain DMD (which conflates forcing with
dynamics) does measurably worse on the same data.
"""

from __future__ import annotations

import numpy as np
import pytest

from dmd_era5_tpu.models.dmdc import dmdc_rollout, fit_dmdc


def _forced_system(s_rows=80, r0=4, q=2, t_total=120, seed=0):
    """x_{k+1} = U A0 U^T x_k + U B0 u_k, dynamics in a known subspace."""
    rng = np.random.default_rng(seed)
    u_true, _ = np.linalg.qr(rng.standard_normal((s_rows, r0)))
    # stable rotation-ish reduced dynamics with distinct |eigenvalues|
    th1, th2 = 0.3, 1.1
    rot = lambda t, g: g * np.array(  # noqa: E731
        [[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]]
    )
    a0 = np.zeros((r0, r0))
    a0[:2, :2] = rot(th1, 0.98)
    a0[2:, 2:] = rot(th2, 0.9)
    b0 = rng.standard_normal((r0, q))
    u_seq = rng.standard_normal((q, t_total - 1)).astype(np.float32)

    x = np.zeros((s_rows, t_total), np.float32)
    z = rng.standard_normal(r0)
    x[:, 0] = u_true @ z
    for k in range(t_total - 1):
        z = a0 @ z + b0 @ u_seq[:, k]
        x[:, k + 1] = u_true @ z
    return x, u_seq, a0, b0, u_true


def test_spectrum_and_trajectory_recovery():
    x, u_seq, a0, b0, _ = _forced_system()
    res = fit_dmdc(x, u_seq, rank=4)

    # unforced eigenvalues match eig(A0) (the forcing is disentangled)
    lam_ref = np.sort_complex(np.linalg.eigvals(a0))
    lam_got = np.sort_complex(res.eigenvalues.astype(np.complex128))
    np.testing.assert_allclose(lam_got, lam_ref, rtol=0, atol=2e-3)

    # forced rollout from x0 reproduces the training trajectory
    xr = np.asarray(dmdc_rollout(res, x[:, 0], u_seq))
    err = np.linalg.norm(xr - x) / np.linalg.norm(x)
    assert err < 1e-3, err


def test_reduced_input_map():
    x, u_seq, a0, b0, u_true = _forced_system()
    res = fit_dmdc(x, u_seq, rank=4)
    # B_red expressed in the true subspace: u_hat^T B = (u_hat^T U) B0
    u_hat = np.asarray(res.u_hat)
    b_red_ref = (u_hat.T @ u_true) @ b0
    np.testing.assert_allclose(
        np.asarray(res.b_red), b_red_ref, rtol=0, atol=5e-3
    )


def test_generalizes_to_unseen_inputs():
    x, u_seq, a0, b0, u_true = _forced_system()
    res = fit_dmdc(x, u_seq, rank=4)

    rng = np.random.default_rng(7)
    n_new = 40
    u_new = rng.standard_normal((2, n_new)).astype(np.float32)
    z = np.asarray(u_true.T @ x[:, -1])
    x_true = [x[:, -1]]
    for k in range(n_new):
        z = a0 @ z + b0 @ u_new[:, k]
        x_true.append(u_true @ z)
    x_true = np.stack(x_true, axis=1).astype(np.float32)

    xr = np.asarray(dmdc_rollout(res, x[:, -1], u_new))
    err = np.linalg.norm(xr - x_true) / np.linalg.norm(x_true)
    assert err < 1e-2, err


def test_beats_uncontrolled_dmd_on_forced_data():
    from dmd_era5_tpu.models.dmd import exact_dmd

    x, u_seq, a0, _, _ = _forced_system(seed=3)
    res = fit_dmdc(x, u_seq, rank=4)
    d = exact_dmd(x, rank=4)

    lam_ref = np.sort_complex(np.linalg.eigvals(a0))
    err_c = np.abs(
        np.sort_complex(res.eigenvalues.astype(np.complex128)) - lam_ref
    ).max()
    err_plain = np.abs(
        np.sort_complex(d.eigenvalues.astype(np.complex128)) - lam_ref
    ).max()
    assert err_c < 0.1 * err_plain, (err_c, err_plain)


def test_control_recovery_under_magnitude_imbalance():
    """Unbalanced units (review r4): state magnitudes 1e4x the control
    magnitudes must not silently zero the control subspace — the stack
    is row-balanced internally and B_red comes back in raw input units."""
    x, u_seq, a0, b0, u_true = _forced_system()
    # physical-units scenario: big states, tiny measured forcing
    scale_x, scale_u = 1e3, 1e-3
    x_big = (x * scale_x).astype(np.float32)
    u_small = (u_seq * scale_u).astype(np.float32)
    # same system in the new units: B scales by scale_x/scale_u
    res = fit_dmdc(x_big, u_small, rank=4)

    # the control map survived (pre-fix: b_red ~= 0)
    u_hat = np.asarray(res.u_hat)
    b_red_ref = (u_hat.T @ u_true) @ b0 * (scale_x / scale_u)
    np.testing.assert_allclose(
        np.asarray(res.b_red), b_red_ref, rtol=2e-3, atol=2e-3 * abs(b_red_ref).max()
    )

    # forced rollout in the raw units reproduces the trajectory
    xr = np.asarray(dmdc_rollout(res, x_big[:, 0], u_small))
    err = np.linalg.norm(xr - x_big) / np.linalg.norm(x_big)
    assert err < 1e-3, err

    # degenerate guard: all-zero controls fall back to gamma=1 (finite fit)
    res0 = fit_dmdc(x_big, np.zeros_like(u_small), rank=4)
    assert np.isfinite(np.asarray(res0.b_red)).all()


def test_input_shape_validation():
    x, u_seq, *_ = _forced_system()
    with pytest.raises(ValueError, match=r"\(q, T-1\)"):
        fit_dmdc(x, u_seq[:, :-3], rank=4)


def test_dmdc_from_svd_matches_full_route():
    """The POD-projected pipeline route (dmdc_from_svd on U, s, V)
    recovers the same spectrum/trajectory as fit_dmdc on X when the
    SVD basis captures the dynamics (k >= true rank)."""
    import jax.numpy as jnp

    from dmd_era5_tpu.models.dmdc import dmdc_from_svd

    x, u_seq, a0, b0, _ = _forced_system()
    uu, ss, vvt = np.linalg.svd(x, full_matrices=False)
    k = 6
    res = dmdc_from_svd(
        jnp.asarray(uu[:, :k]),
        jnp.asarray(ss[:k]),
        jnp.asarray(vvt[:k]),
        jnp.asarray(u_seq),
        rank=4,
    )
    lam_ref = np.sort_complex(np.linalg.eigvals(a0))
    lam_got = np.sort_complex(res.eigenvalues.astype(np.complex128))
    np.testing.assert_allclose(lam_got, lam_ref, rtol=0, atol=2e-3)
    assert res.residual < 1e-3
    # modes and lift basis live in FULL space
    assert res.modes.shape == (x.shape[0], 4)
    assert res.u_hat.shape == (x.shape[0], 4)
    xr = np.asarray(dmdc_rollout(res, x[:, 0], u_seq))
    err = np.linalg.norm(xr - x) / np.linalg.norm(x)
    assert err < 1e-3, err


def test_dmdc_rank_omega_validation():
    x, u_seq, *_ = _forced_system()
    with pytest.raises(ValueError, match="rank_omega"):
        fit_dmdc(x, u_seq, rank=4, rank_omega=0)
