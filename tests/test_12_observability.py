"""Profiling, debug, and determinism utilities."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dmd_era5_tpu.ops import randomized_svd
from dmd_era5_tpu.parallel import make_mesh, shard_rows
from dmd_era5_tpu.utils.debug import (
    assert_finite,
    check_deterministic,
    debug_nans,
    tree_checksum,
)
from dmd_era5_tpu.utils.profiling import (
    device_peaks,
    measure,
    roofline,
    throughput,
)


def test_measure_returns_positive_time():
    f = jax.jit(lambda x: x @ x.T)
    x = jnp.ones((128, 128))
    dt = measure(f, x, iters=3, warmup=1)
    assert dt > 0


class _Device:
    """Stand-in for a jax.Device: only ``device_kind`` is read."""

    def __init__(self, kind):
        self.device_kind = kind


H100 = _Device("NVIDIA H100 80GB HBM3")


def test_device_peaks_known():
    peaks = device_peaks(H100)
    assert peaks.bf16_flops == 989e12 and peaks.hbm_bw == 3.35e12
    assert peaks.f32_flops == 67e12


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe", None])
def test_device_peaks_unknown_kind_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks(_Device(kind))


def test_device_peaks_cpu_process_raises():
    """The CPU is not an accelerator with published peaks: no fallback."""
    with pytest.raises(KeyError):
        device_peaks()


def test_roofline_classification():
    out = roofline(flops=1e12, bytes_accessed=1e6, seconds=1.0, device=H100)
    assert out["bound"] == "compute"
    out = roofline(flops=1e6, bytes_accessed=1e12, seconds=1.0, device=H100)
    assert out["bound"] == "memory"


def test_throughput_counters():
    tp = throughput(2_000_000_000, 2.0)
    assert tp["gelements_per_s"] == 1.0


def test_assert_finite_raises():
    ok = {"a": jnp.ones(3)}
    assert_finite(ok)
    bad = {"a": jnp.asarray([1.0, np.nan])}
    with pytest.raises(FloatingPointError, match="non-finite"):
        assert_finite(bad, "bad")


def test_debug_nans_context():
    with debug_nans():
        assert jax.config.jax_debug_nans
        with pytest.raises(FloatingPointError):
            jax.jit(lambda x: jnp.log(x))(jnp.float32(-1.0))
    assert not jax.config.jax_debug_nans


def test_tree_checksum_sensitivity():
    a = {"x": jnp.ones((4, 4))}
    b = {"x": jnp.ones((4, 4)).at[0, 0].set(2.0)}
    assert tree_checksum(a) != tree_checksum(b)
    assert tree_checksum(a) == tree_checksum({"x": jnp.ones((4, 4))})


def test_distributed_svd_is_deterministic(rng):
    """Deterministic-collectives contract: same mesh + inputs ->
    bit-identical factors across runs."""
    mesh = make_mesh()
    x = rng.standard_normal((512, 32)).astype(np.float32)
    xs, _ = shard_rows(x, mesh)

    def run():
        res = randomized_svd(xs, 8, mesh=mesh, seed=0)
        return res.U, res.s, res.V

    assert check_deterministic(run)
