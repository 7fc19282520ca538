"""chip_smoke.py's phases rehearsed on the CPU at small sizes.

The script itself refuses to run without a GPU; its phase functions
take the size as an argument, so the comparisons, oracles and control
flow are exercised here before a chip run.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402

ROWS = 1 << 14


@pytest.fixture(scope="module")
def week_slice():
    x = cs.synth_matrix(0, ROWS, cs.WEEK_COLS)
    return x, cs.host_gram(x)


def test_oracle_helpers_match_numpy(rng):
    x = rng.standard_normal((300, 12))
    g = x.T @ x
    xc = x - x.mean(axis=1, keepdims=True)
    np.testing.assert_allclose(cs.centered_gram(g), xc.T @ xc, atol=1e-9)
    np.testing.assert_allclose(
        cs.gram_singular_values(g)[:5], np.linalg.svd(x, compute_uv=False)[:5]
    )
    h = np.vstack([x[:, 1:], x[:, :-1]])
    np.testing.assert_allclose(cs.hankel_gram(g, 2), h.T @ h, atol=1e-9)
    om = rng.standard_normal((12, 6))
    s, loss = cs.sketch_oracle(xc.T @ xc, om, 4)
    q, _ = np.linalg.qr(xc @ om)
    s_ref = np.linalg.svd(q.T @ xc, compute_uv=False)[:4]
    np.testing.assert_allclose(s, s_ref, rtol=1e-9)
    resid = np.sqrt(np.sum(xc**2) - np.sum(s_ref**2)) / np.linalg.norm(xc)
    assert loss == pytest.approx(resid, rel=1e-9)


def test_check_raises_above_tolerance():
    cs.check("fine", 1e-4, 1e-3, "f32")
    with pytest.raises(AssertionError, match="above tolerance"):
        cs.check("bad", 2e-3, 1e-3, "f32")
    with pytest.raises(AssertionError):
        cs.check("nan", float("nan"), 1e-3, "f32")


def test_phase_ingest():
    cs.phase_ingest(0, rows=4096)


def test_phase_fit_step(week_slice):
    x, g = week_slice
    out = cs.phase_fit_step(x, g, 0)
    assert out["step_s"] > 0 and out["bound_s"] > 0


def test_phase_svd_and_dmd(week_slice):
    x, g = week_slice
    u, s, v = cs.phase_svd(x, g)
    assert u.shape == (ROWS, cs.K) and v.shape == (cs.K, cs.WEEK_COLS)
    cs.phase_dmd((u, s, v), 0)


def test_phase_stages(tmp_path, monkeypatch):
    monkeypatch.setenv("DMD_ERA5_TPU_ROOT", str(tmp_path))
    cs.phase_stages(str(tmp_path))


def test_phase_four_on_virtual_devices(week_slice):
    x, g = week_slice
    cs.phase_four(x, g, 0)
