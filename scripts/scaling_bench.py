"""Weak-scaling harness: snapshot-matrix elements/s vs device count.

Measures the fused fit step at constant per-device rows while growing
the space axis — the north-star scaling metric.  On the cards of one host
this reports weak-scaling efficiency; with the virtual CPU mesh (set
XLA_FLAGS=--xla_force_host_platform_device_count=N JAX_PLATFORMS=cpu) it
validates the collective structure only.

Usage: python scripts/scaling_bench.py [rows_per_device] [t_cols] [k]
"""

from __future__ import annotations

import json
import os
import sys

import jax

sys.path.insert(0, ".")

from dmd_era5_tpu.core.paths import enable_compile_cache  # noqa: E402
from dmd_era5_tpu.parallel import make_mesh  # noqa: E402
from dmd_era5_tpu.pipeline.train_step import example_batch, make_fit_step  # noqa: E402
from dmd_era5_tpu.utils.profiling import measure, throughput  # noqa: E402


def main() -> None:
    rows_per_device = int(sys.argv[1]) if len(sys.argv) > 1 else 1 << 15
    t_cols = int(sys.argv[2]) if len(sys.argv) > 2 else 256
    k = int(sys.argv[3]) if len(sys.argv) > 3 else 32

    enable_compile_cache()
    devices = jax.devices()
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devices)]
    results = []
    for n in counts:
        mesh = make_mesh(devices=devices[:n])
        step = make_fit_step(mesh, n_components=k)
        x, omega = example_batch(1, rows_per_device * n, t_cols, k + 8)
        dt = measure(step, x, omega, iters=5, warmup=2)
        tp = throughput(rows_per_device * n * t_cols, dt)
        results.append((n, dt, tp["gelements_per_s"]))
        print(
            f"devices={n:3d}  {dt*1e3:8.2f} ms  "
            f"{tp['gelements_per_s']:8.2f} Gelem/s",
            file=sys.stderr,
        )

    base = results[0][2]  # Gelem/s at 1 device
    table = [
        {
            "devices": n,
            "ms": round(dt * 1e3, 2),
            "gelements_per_s": round(g, 3),
            "weak_scaling_efficiency": round(g / (base * n), 3),
        }
        for n, dt, g in results
    ]
    print(json.dumps(table))


if __name__ == "__main__":
    main()
