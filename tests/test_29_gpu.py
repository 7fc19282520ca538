"""Tests that only the card can answer: they skip without a GPU.

Run on the H100 with ``JAX_PLATFORMS=cuda python -m pytest -m gpu``
(``chip_smoke.py`` runs them as its second phase).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_platform_is_gpu(gpu_device):
    assert gpu_device.platform == "gpu"
    assert jax.default_backend() == "gpu"


def test_ingest_pass_matches_f64_at_highest(gpu_device, rng):
    """f32 operands must not run in TF32: the ingest products agree with
    float64 to ~1e-6, where TF32 would leave ~1e-3."""
    from dmd_era5_tpu.ops.matmul import sketch_center_gram_project

    m, t, n = 1 << 16, 168, 128
    x = rng.standard_normal((m, t)).astype(np.float32)
    w = rng.standard_normal((t, n)).astype(np.float32)
    yc, rs, _, g, c = sketch_center_gram_project(
        jax.device_put(x, gpu_device), jax.device_put(w, gpu_device)
    )
    x64 = x.astype(np.float64)
    y64 = x64 @ w - np.outer(x64.mean(axis=1), w.astype(np.float64).sum(0))
    for got, want in (
        (yc, y64), (g, y64.T @ y64), (c, y64.T @ x64), (rs, x64.sum(1)),
    ):
        err = np.abs(np.asarray(got, np.float64) - want).max()
        assert err <= 1e-5 * np.abs(want).max(), err


def test_peaks_resolve_for_this_card(gpu_device):
    from dmd_era5_tpu.utils.profiling import device_peaks

    peaks = device_peaks(gpu_device)
    assert peaks.bf16_flops > peaks.f32_flops > 0 and peaks.hbm_bw > 0
