"""One-pass (two-sided sketch) randomized SVD: correctness tier.

Oracle strategy follows SURVEY.md section 4: exact numpy SVD of the
same matrix; the one-pass estimate is checked on subspace angle,
singular values of the dominant (well-separated) part, and
reconstruction error within a constant factor of optimal — the
published accuracy model for sketch-and-solve (ops/onepass.py
docstring).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from dmd_era5_tpu.ops import onepass_svd
from dmd_era5_tpu.ops.onepass import OnePassSketch, psi_panel


def _lowrank(rng, s, t, rank, decay, noise):
    a = rng.standard_normal((s, rank))
    b = rng.standard_normal((rank, t))
    core = (a * np.logspace(0, -decay, rank)) @ b
    return (core + noise * rng.standard_normal((s, t))).astype(np.float32)


def _subspace_gap(u_est, u_ref):
    qa, _ = np.linalg.qr(np.asarray(u_est))
    qb, _ = np.linalg.qr(np.asarray(u_ref))
    return 1.0 - np.linalg.svd(qa.T @ qb, compute_uv=False).min()


def test_onepass_recovers_dominant_subspace(rng):
    x = _lowrank(rng, 1024, 96, rank=8, decay=1, noise=1e-4)
    res = onepass_svd(jnp.asarray(x), 8, seed=3)
    u_np, s_np, _ = np.linalg.svd(x, full_matrices=False)
    assert _subspace_gap(res.U, u_np[:, :8]) < 1e-3
    # interior singular values are tight; the trailing estimate inflates
    # by the one-pass constant factor (docstring accuracy model)
    np.testing.assert_allclose(np.asarray(res.s)[:6], s_np[:6], rtol=2e-2)
    np.testing.assert_allclose(np.asarray(res.s), s_np[:8], rtol=1e-1)


def test_onepass_reconstruction_within_constant_of_optimal(rng):
    x = _lowrank(rng, 2048, 128, rank=40, decay=2, noise=1e-3)
    k = 10
    res = onepass_svd(jnp.asarray(x), k, seed=0)
    approx = (
        np.asarray(res.U) * np.asarray(res.s)[None, :]
    ) @ np.asarray(res.V)
    err = np.linalg.norm(x - approx)
    s_np = np.linalg.svd(x, compute_uv=False)
    opt = np.linalg.norm(s_np[k:])
    assert err <= 1.6 * opt, (err, opt)


@pytest.mark.parametrize(
    "decay,noise,k",
    [
        (2, 1e-3, 10),   # fast decay: small true error, small estimate
        (0.5, 0.3, 10),  # heavy tail: large true error, estimate must flag it
    ],
)
def test_onepass_error_estimate_brackets_truth(rng, decay, noise, k):
    """The posterior tail_rel_err_est (review r4 item 6) must bracket
    the true rank-k Frobenius reconstruction error on known-spectrum
    matrices: an upper-bound-flavored estimate within a small constant
    (sketch concentration), never an underestimate by more than ~30%."""
    x = _lowrank(rng, 2048, 128, rank=40, decay=decay, noise=noise)
    sk = OnePassSketch(128, k, seed=1)
    sk.update(0, jnp.asarray(x))
    res = sk.finalize()
    est = sk.tail_rel_err_est

    approx = (
        np.asarray(res.U) * np.asarray(res.s)[None, :]
    ) @ np.asarray(res.V)
    true_rel = np.linalg.norm(x - approx) / np.linalg.norm(x)
    # measured est/true ~ 0.70-0.75 on these spectra (the quadrature
    # sum drops the positive cross term); the bracket guards both
    # directions without over-fitting the constant
    assert 0.5 * true_rel <= est <= 3.0 * max(true_rel, 1e-7), (
        est,
        true_rel,
    )


def test_streamed_onepass_stamps_estimate_and_warns(tmp_path, rng, caplog):
    """svd_backend=onepass must surface the accuracy trade: the info
    dict carries onepass_tail_rel_err_est and a warning is logged when
    the estimate exceeds tolerance (review r4: 'a user selecting
    svd_backend=onepass gets an artifact whose tail components are
    garbage with no error estimate and no warning')."""
    import logging

    from dmd_era5_tpu.pipeline.streamed_fit import streamed_onepass_svd
    from dmd_era5_tpu.snapmat.loader import save_packed_matrix

    x = _lowrank(rng, 1024, 64, rank=40, decay=0.3, noise=0.5)
    path = tmp_path / "noisy.h5"
    save_packed_matrix(path, x, d=1)
    info: dict = {}
    with caplog.at_level(logging.WARNING, logger="StreamedFit"):
        streamed_onepass_svd(path, 32, block_rows=256, info=info)
    assert "onepass_tail_rel_err_est" in info
    assert info["onepass_tail_rel_err_est"] > 0.1
    assert any(
        "posterior error estimate" in r.message for r in caplog.records
    )

    # clean spectrum: no warning
    x_clean = _lowrank(rng, 1024, 64, rank=8, decay=1, noise=1e-5)
    path2 = tmp_path / "clean.h5"
    save_packed_matrix(path2, x_clean, d=1)
    info2: dict = {}
    with caplog.at_level(logging.WARNING, logger="StreamedFit"):
        caplog.clear()
        streamed_onepass_svd(path2, 8, block_rows=256, info=info2)
    assert info2["onepass_tail_rel_err_est"] < 0.1
    assert not any(
        "posterior error estimate" in r.message for r in caplog.records
    )


def _accumulators(sk: OnePassSketch):
    y = jnp.concatenate(
        [p for _, p in sorted(sk._y_parts, key=lambda t: t[0])], axis=0
    )
    return np.asarray(y), np.asarray(sk.w), np.asarray(sk.g)


def test_onepass_streamed_blocks_match_single_shot(rng):
    """Row-blocked accumulation == whole-matrix call (same seeds).

    The sketches (Y, W, G) are the blocking-invariant quantities and
    must agree to f32 roundoff; the finalize solve on a near-rank-
    deficient Gram amplifies that roundoff, so the outputs get a
    looser check.
    """
    x = _lowrank(rng, 512, 64, rank=12, decay=1, noise=1e-4)
    whole = OnePassSketch(64, 6, seed=7)
    whole.update(0, jnp.asarray(x))
    blocked = OnePassSketch(64, 6, seed=7)
    for r0 in (0, 128, 256, 384):
        blocked.update(r0, jnp.asarray(x[r0 : r0 + 128]))
    for a, b, name in zip(
        _accumulators(whole), _accumulators(blocked), "ywg"
    ):
        np.testing.assert_allclose(
            a, b, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(a).max()),
            err_msg=name,
        )
    np.testing.assert_allclose(
        np.asarray(blocked.finalize().s),
        np.asarray(whole.finalize().s),
        rtol=2e-2,
    )


def test_onepass_block_order_invariant(rng):
    """Psi panels are keyed by global row index, so block ORDER cannot
    change the accumulated sketches (beyond f32 addition order)."""
    x = _lowrank(rng, 256, 48, rank=6, decay=1, noise=1e-4)
    a = OnePassSketch(48, 4, seed=1)
    for r0 in (0, 64, 128, 192):
        a.update(r0, jnp.asarray(x[r0 : r0 + 64]))
    b = OnePassSketch(48, 4, seed=1)
    for r0 in (192, 64, 0, 128):
        b.update(r0, jnp.asarray(x[r0 : r0 + 64]))
    for pa, pb, name in zip(_accumulators(a), _accumulators(b), "ywg"):
        np.testing.assert_allclose(
            pa, pb, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(pa).max()),
            err_msg=name,
        )
    np.testing.assert_allclose(
        np.asarray(a.finalize().s), np.asarray(b.finalize().s), rtol=2e-2
    )


def test_onepass_centered_matches_centered_oracle(rng):
    x = _lowrank(rng, 512, 64, rank=8, decay=1, noise=1e-4)
    x = x + rng.standard_normal((512, 1)).astype(np.float32)  # row offsets
    res = onepass_svd(jnp.asarray(x), 6, seed=2, center=True)
    xc = x - x.mean(axis=1, keepdims=True)
    u_np, s_np, _ = np.linalg.svd(xc, full_matrices=False)
    assert _subspace_gap(res.U, u_np[:, :6]) < 1e-3
    np.testing.assert_allclose(np.asarray(res.s), s_np[:6], rtol=2e-2)


def test_psi_panel_deterministic_and_rademacher():
    p1 = psi_panel(5, 128, 64, 32)
    p2 = psi_panel(5, 128, 64, 32)
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
    vals = np.unique(np.asarray(p1))
    np.testing.assert_array_equal(vals, [-1.0, 1.0])
    p3 = psi_panel(5, 0, 64, 32)
    assert not np.array_equal(np.asarray(p1), np.asarray(p3))


def test_onepass_empty_raises():
    sk = OnePassSketch(16, 2)
    with pytest.raises(ValueError, match="No blocks"):
        sk.finalize()


def test_streamed_onepass_single_disk_pass(tmp_path, rng, monkeypatch):
    """Out-of-core one-pass == in-memory one-pass, and the file is read
    exactly once."""
    from dmd_era5_tpu.pipeline import streamed_fit
    from dmd_era5_tpu.snapmat import create_mock_era5
    from dmd_era5_tpu.snapmat.loader import (
        build_snapshot_matrix,
        save_packed_snapshot,
    )

    x = _lowrank(rng, 600, 48, rank=10, decay=1, noise=1e-4)
    fs = create_mock_era5(
        "2020-01-01", "2020-01-02", ["temperature"], [1000], seed=0
    )
    _, meta = build_snapshot_matrix(fs)
    path = tmp_path / "packed.h5"
    save_packed_snapshot(path, x, meta)

    reads = []
    real_read = streamed_fit.read_packed_rows

    def counting_read(p, r0, r1):
        reads.append((r0, r1))
        return real_read(p, r0, r1)

    monkeypatch.setattr(streamed_fit, "read_packed_rows", counting_read)
    res = streamed_fit.streamed_onepass_svd(path, 6, block_rows=150, seed=9)
    assert len(reads) == 4  # 600 rows / 150-row blocks, ONE pass
    ref = onepass_svd(jnp.asarray(x), 6, seed=9, block_rows=150)
    np.testing.assert_allclose(
        np.asarray(res.s), np.asarray(ref.s), rtol=1e-4
    )


def test_streamed_onepass_bf16_packed(tmp_path, rng):
    """Regression: a bf16-packed artifact streams through the one-pass
    sketch DECODED (uint16 storage viewed as bf16), not as raw integer
    bits — caught by the 0.25-degree scale bench, where singular values
    came back 6000x off."""
    import numpy as np

    from dmd_era5_tpu.pipeline.streamed_fit import streamed_onepass_svd
    from dmd_era5_tpu.snapmat.loader import save_packed_matrix

    s_rows, t_cols, k = 512, 96, 8
    u = np.linalg.qr(rng.standard_normal((s_rows, k)))[0]
    v = np.linalg.qr(rng.standard_normal((t_cols, k)))[0]
    sig = np.linspace(50, 10, k)
    x = (u * sig) @ v.T + 0.01 * rng.standard_normal((s_rows, t_cols))
    x = x.astype(np.float32)
    path = tmp_path / "bf16_onepass.h5"
    save_packed_matrix(path, x, d=1, bf16=True)

    res = streamed_onepass_svd(path, k, block_rows=128)
    s_ref = np.linalg.svd(x, compute_uv=False)[:k]
    np.testing.assert_allclose(np.asarray(res.s), s_ref, rtol=0.05)
