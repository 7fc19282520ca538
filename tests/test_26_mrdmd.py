"""Multiresolution DMD: scale separation, exactness identities, recovery.

Oracle strategy (SURVEY.md section 4): synthetic snapshot matrices with
KNOWN scale-separated spectral content — a slow global oscillation, a
fast oscillation, and a transient active only in part of the time range
(the regime mrDMD exists for and a single global DMD cannot represent)
— checked for frequency recovery per level and for the algebraic
identity reconstruction == x - residual.  Every oscillation is a
cos/sin PAIR of spatial patterns (a single standing pattern is
spatial-rank-1 and no linear flow generates it).
"""

from __future__ import annotations

import numpy as np
import pytest

from dmd_era5_tpu.models.mrdmd import fit_mrdmd, mrdmd_reconstruct


def _wave(rng, s_rows, t, w, amp):
    return amp * (
        np.outer(rng.standard_normal(s_rows), np.cos(w * t))
        + np.outer(rng.standard_normal(s_rows), np.sin(w * t))
    )


def _two_scale_signal(s_rows=96, t_total=256, dt=0.1, seed=0):
    """slow pair (0.2 rad/s) + fast pair (6 rad/s) + tiny noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(t_total) * dt
    x = (
        _wave(rng, s_rows, t, 0.2, 2.0)
        + _wave(rng, s_rows, t, 6.0, 0.5)
        + 1e-4 * rng.standard_normal((s_rows, t_total))
    )
    return x.astype(np.float32), dt


def test_reconstruction_identity_and_residual_decay():
    x, dt = _two_scale_signal()
    res = fit_mrdmd(x, dt=dt, rank=6, max_levels=3, max_cycles=2.0)
    assert res.t_used == x.shape[1]

    # slow-part sums reconstruct exactly what was subtracted
    recon = mrdmd_reconstruct(res)
    np.testing.assert_allclose(
        recon, x[:, : res.t_used] - res.residual, rtol=1e-4, atol=5e-3
    )

    # the hierarchy must explain nearly all signal energy
    rel = np.linalg.norm(res.residual) / np.linalg.norm(x)
    assert rel < 0.05, rel


def test_scale_separation_across_levels():
    x, dt = _two_scale_signal()
    res = fit_mrdmd(x, dt=dt, rank=6, max_levels=3, max_cycles=2.0)

    # level 0 (T=256, dt=0.1 -> slow budget 2 cycles = |omega| <= 0.49):
    # the 0.2 rad/s pair is slow, the 6 rad/s pair is NOT
    lv0 = res.levels[0]
    active = np.abs(lv0.amplitudes[0]) > 1e-2 * np.abs(lv0.amplitudes).max()
    omegas0 = lv0.omega[0][active]
    assert omegas0.size > 0
    assert np.all(np.abs(omegas0) <= 0.5 + 1e-6)
    freqs0 = np.abs(np.imag(omegas0))
    assert np.any(np.abs(freqs0 - 0.2) < 0.05), freqs0
    # the fast frequency is NOT in the level-0 slow set
    assert not np.any(np.abs(freqs0 - 6.0) < 1.0)

    # the fast 6 rad/s pair must surface as SLOW at a finer level
    found = False
    for lv in res.levels[1:]:
        for win in range(lv.omega.shape[0]):
            act = np.abs(lv.amplitudes[win]) > 1e-3
            f = np.abs(np.imag(lv.omega[win][act]))
            if np.any(np.abs(f - 6.0) < 0.5):
                found = True
    assert found


def test_transient_localization():
    """A burst living only in the second half must appear in the level-1
    second-half window with far more energy than the first."""
    rng = np.random.default_rng(1)
    s_rows, t_total, dt = 64, 256, 0.1
    t = np.arange(t_total) * dt
    x = _wave(rng, s_rows, t, 0.15, 1.5)
    half = t_total // 2
    burst = np.zeros((s_rows, t_total))
    burst[:, half:] = _wave(rng, s_rows, t[:half], 4.0, 1.0)
    x = (x + burst).astype(np.float32)

    res = fit_mrdmd(x, dt=dt, rank=6, max_levels=2, max_cycles=2.0)
    lv1 = res.levels[1]
    e_first = np.linalg.norm(lv1.amplitudes[0])
    e_second = np.linalg.norm(lv1.amplitudes[1])
    active = np.abs(lv1.amplitudes[1]) > 1e-2 * max(e_second, 1e-30)
    freqs_second = np.abs(np.imag(lv1.omega[1]))
    # the burst frequency is recovered in the second window...
    assert np.any(np.abs(freqs_second[active] - 4.0) < 0.5)
    # ...which carries far more level-1 energy than the first
    assert e_second > 3.0 * e_first, (e_first, e_second)


def test_beats_single_window_dmd_on_transients():
    """mrDMD's raison d'etre: piecewise spectra fit transient content a
    single global rank-r DMD cannot."""
    from dmd_era5_tpu.models.dmd import exact_dmd, reconstruct

    rng = np.random.default_rng(2)
    s_rows, t_total, dt = 64, 256, 0.1
    t = np.arange(t_total) * dt
    x = _wave(rng, s_rows, t, 0.1, 1.0)
    for q, w in enumerate((1.5, 3.0, 5.0, 8.0)):  # a different tone per quarter
        seg = slice(q * 64, (q + 1) * 64)
        x[:, seg] += _wave(rng, s_rows, t[:64], w, 1.0)
    x = x.astype(np.float32)

    res = fit_mrdmd(x, dt=dt, rank=6, max_levels=3, max_cycles=2.0)
    err_mr = np.linalg.norm(res.residual) / np.linalg.norm(x)

    d = exact_dmd(x, rank=6, dt=dt)
    xr = np.asarray(reconstruct(d, t_total))
    err_dmd = np.linalg.norm(x - xr) / np.linalg.norm(x)
    assert err_mr < 0.5 * err_dmd, (err_mr, err_dmd)


def test_validation_and_no_modes_paths():
    x, dt = _two_scale_signal(t_total=64)
    with pytest.raises(ValueError, match="finest window"):
        fit_mrdmd(x, dt=dt, rank=6, max_levels=5)

    res = fit_mrdmd(x, dt=dt, rank=4, max_levels=2, return_modes=False)
    assert res.levels[0].modes is None
    with pytest.raises(ValueError, match="return_modes"):
        mrdmd_reconstruct(res)
    # spectra are still produced
    assert res.levels[1].omega.shape == (2, 4)


def test_time_truncation():
    x, dt = _two_scale_signal(t_total=250)  # not divisible by 4
    res = fit_mrdmd(x, dt=dt, rank=4, max_levels=3)
    assert res.t_used == 248
    assert res.residual.shape == (x.shape[0], 248)


def test_from_svd_subspace_bias_vs_raw_oracle():
    """Quantify the mrdmd_from_svd approximation (review r3 item 4).

    Data = strong global slow dynamics (rank 4) + a WEAK brief transient
    whose spatial pattern is orthogonal to the global top-4 POD modes.
    The raw-window oracle (fit_mrdmd on X — classic per-window bases)
    must capture the transient; the subspace route (mrdmd_from_svd with
    the global k=4 basis) is provably blind to it: its reconstruction
    error on the transient window stays at the full transient energy,
    while the raw oracle's is an order of magnitude below."""
    from dmd_era5_tpu.models.mrdmd import mrdmd_from_svd

    rng = np.random.default_rng(0)
    s_rows, t_total = 256, 128
    q_all, _ = np.linalg.qr(rng.standard_normal((s_rows, 6)))
    t = np.arange(t_total, dtype=np.float64)

    # global slow content: 2 oscillation pairs, O(1) amplitude
    x = np.zeros((s_rows, t_total))
    for j, (freq, amp) in enumerate(((0.05, 1.0), (0.11, 0.8))):
        x += amp * np.outer(q_all[:, 2 * j], np.cos(freq * t))
        x += amp * np.outer(q_all[:, 2 * j + 1], np.sin(freq * t))

    # weak transient: lives only in window [64, 96), pattern q_all[:,4:6]
    # (orthogonal to the energy-dominant directions), fast oscillation
    win = slice(64, 96)
    tw = t[win] - 64.0
    amp_tr = 0.05
    transient = amp_tr * (
        np.outer(q_all[:, 4], np.cos(1.2 * tw))
        + np.outer(q_all[:, 5], np.sin(1.2 * tw))
    )
    x_tr = x.copy()
    x_tr[:, win] += transient
    x_tr = x_tr.astype(np.float32)

    # global top-4 SVD: the transient is orthogonal AND weak, so the
    # leading 4 modes are the slow pairs (verify the premise)
    uu, ss, vvt = np.linalg.svd(x_tr, full_matrices=False)
    k = 4
    leak = np.linalg.norm(uu[:, :k].T @ q_all[:, 4:6])
    assert leak < 0.3, f"premise broken: transient leaks {leak} into top-k"

    kwargs = dict(dt=1.0, max_levels=3, max_cycles=2.0)
    res_raw = fit_mrdmd(x_tr, rank=4, **kwargs)
    res_sub = mrdmd_from_svd(
        uu[:, :k], ss[:k], vvt[:k], rank=4, **kwargs
    )

    recon_raw = mrdmd_reconstruct(res_raw)
    recon_sub = mrdmd_reconstruct(res_sub)
    tr_norm = np.linalg.norm(transient)
    err_raw = np.linalg.norm((recon_raw - x_tr)[:, win]) / tr_norm
    err_sub = np.linalg.norm((recon_sub - x_tr)[:, win]) / tr_norm

    # the raw oracle captures the transient; the subspace route's error
    # on the transient window is ~100% of the transient energy (blind)
    assert err_raw < 0.25, err_raw
    assert err_sub > 0.8, err_sub
    # and the documented bias bound: subspace error is capped by the
    # out-of-subspace energy (it cannot be MORE wrong than blind)
    assert err_sub < 1.5, err_sub


def test_gram_route_matches_device_route():
    """fit_mrdmd_gram(X^T X) == fit_mrdmd(X) (review r4 item 7): the
    whole hierarchy from ONE T x T Gram — spectra, masks, amplitudes,
    residual norm — no S-sized array anywhere in the fit."""
    from dmd_era5_tpu.models.mrdmd import fit_mrdmd_gram

    x, dt = _two_scale_signal()
    ref = fit_mrdmd(x, dt=dt, rank=6, max_levels=3, max_cycles=2.0)
    gx = (x.astype(np.float64).T @ x.astype(np.float64))
    got = fit_mrdmd_gram(gx, dt=dt, rank=6, max_levels=3, max_cycles=2.0)

    assert got.t_used == ref.t_used
    for lv_ref, lv_got in zip(ref.levels, got.levels):
        assert lv_got.t_window == lv_ref.t_window
        # eigenvalues per window, order-insensitive
        for w in range(lv_ref.omega.shape[0]):
            om_ref = np.sort_complex(lv_ref.omega[w])
            om_got = np.sort_complex(lv_got.omega[w])
            np.testing.assert_allclose(om_got, om_ref, rtol=0, atol=5e-3)
        # identical slow/kept counts (the masks drive the hierarchy)
        assert lv_got.slow_mask.sum() == lv_ref.slow_mask.sum()
        assert lv_got.kept_mask.sum() == lv_ref.kept_mask.sum()
        assert lv_got.mode_map is not None
    # residual energy agrees (f32 device vs f64 host arithmetic)
    np.testing.assert_allclose(
        got.residual_fro, ref.residual_fro,
        rtol=2e-2, atol=1e-3 * np.linalg.norm(x),
    )


def test_streamed_mrdmd_from_packed_file(tmp_path):
    """fit_mrdmd_streamed: one Gram pass over the packed artifact + an
    optional mode pass; reconstruction matches the in-memory route
    without X ever materializing inside the fit."""
    from dmd_era5_tpu.models.mrdmd import fit_mrdmd_streamed
    from dmd_era5_tpu.snapmat.loader import save_packed_matrix

    x, dt = _two_scale_signal()
    path = tmp_path / "x.h5"
    save_packed_matrix(path, x, d=1)

    ref = fit_mrdmd(x, dt=dt, rank=6, max_levels=3, max_cycles=2.0)
    got = fit_mrdmd_streamed(
        path, dt=dt, rank=6, max_levels=3, max_cycles=2.0,
        block_rows=17, return_modes=True,
    )
    # reconstructions are eigen-order/phase invariant: strongest check
    rec_ref = mrdmd_reconstruct(ref)
    rec_got = mrdmd_reconstruct(got)
    scale = np.linalg.norm(x)
    assert np.linalg.norm(rec_got - rec_ref) / scale < 2e-2
    # and the captured energy fraction matches
    np.testing.assert_allclose(
        got.residual_fro / scale, ref.residual_fro / scale, atol=2e-2
    )


def test_gram_route_validation():
    from dmd_era5_tpu.models.mrdmd import fit_mrdmd_gram

    gx = np.eye(16)
    with pytest.raises(ValueError, match="finest window"):
        fit_mrdmd_gram(gx, rank=8, max_levels=3)
