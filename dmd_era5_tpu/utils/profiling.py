"""Tracing, timing, and roofline counters.

The reference has no profiling at all (SURVEY.md section 5); this module
supplies the observability layer: profiler trace capture
(TensorBoard/Perfetto via jax.profiler), steady-state timing
synchronized with ``block_until_ready``, and roofline utilization
against the published peaks of the device kinds this repo runs on.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Callable

import jax
import numpy as np

__all__ = [
    "trace",
    "measure",
    "DevicePeaks",
    "device_peaks",
    "roofline",
    "throughput",
]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace viewable in TensorBoard/Perfetto."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def measure(
    fn: Callable,
    *args,
    iters: int = 5,
    warmup: int = 2,
) -> float:
    """Median steady-state seconds per call of a jitted function."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


@dataclass(frozen=True)
class DevicePeaks:
    """Peak compute/bandwidth for roofline accounting."""

    name: str
    bf16_flops: float  # FLOP/s
    f32_flops: float
    hbm_bw: float  # bytes/s


# Published dense peaks, keyed by the ``device_kind`` the card reports.
# NVIDIA H100 SXM data sheet: 989 TFLOP/s bf16, 67 TFLOP/s f32 outside
# the tensor cores (what Precision.HIGHEST gets; TF32 is 495), 3.35 TB/s
# HBM3 — at the full 700 W power limit.
_PEAKS = {
    "NVIDIA H100 80GB HBM3": DevicePeaks("H100 SXM", 989e12, 67e12, 3.35e12),
}


def device_peaks(device=None) -> DevicePeaks:
    """Peaks of ``device`` (default: the first device); a device kind
    not in the table is an error, never a default."""
    device = device or jax.devices()[0]
    kind = getattr(device, "device_kind", None)
    if kind not in _PEAKS:
        raise KeyError(
            f"no published peaks for device kind {kind!r} "
            f"(known: {sorted(_PEAKS)})"
        )
    return _PEAKS[kind]


def roofline(
    flops: float,
    bytes_accessed: float,
    seconds: float,
    device=None,
    dtype: str = "bf16",
) -> dict:
    """Achieved fraction of compute and bandwidth peaks."""
    peaks = device_peaks(device)
    peak_flops = peaks.bf16_flops if dtype == "bf16" else peaks.f32_flops
    achieved_flops = flops / seconds
    achieved_bw = bytes_accessed / seconds
    return {
        "device": peaks.name,
        "seconds": seconds,
        "tflops": achieved_flops / 1e12,
        "flops_util": achieved_flops / peak_flops,
        "gbps": achieved_bw / 1e9,
        "bw_util": achieved_bw / peaks.hbm_bw,
        "bound": "compute"
        if achieved_flops / peak_flops > achieved_bw / peaks.hbm_bw
        else "memory",
    }


def throughput(elements: int, seconds: float) -> dict:
    """Snapshot-matrix elements/s — the north-star scaling metric."""
    return {
        "elements": elements,
        "seconds": seconds,
        "elements_per_s": elements / seconds,
        "gelements_per_s": elements / seconds / 1e9,
    }
