"""Headline benchmark: snapshot-matrix decomposition throughput.

Runs the flagship fused fit step (standardize -> randomized-sketch SVD
-> reduced DMD operator, pipeline/train_step.py) on the GPU and prints
ONE JSON line:

  {"metric": ..., "value": N, "unit": ..., "device": {...}, ...}

with the device it ran on.  Diagnostics go to stderr.  Exits non-zero
when JAX finds no GPU.

Timing: the step is timed at S and 3S rows (median of ``iters`` runs,
each synchronized with ``block_until_ready``) and the throughput is the
SLOPE, which cancels fixed per-call costs.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def bench_fit_step(s_rows: int, t_cols: int, k: int, sketch: int, iters: int = 10):
    import jax
    import jax.numpy as jnp

    from dmd_era5_tpu.core.paths import enable_compile_cache
    from dmd_era5_tpu.pipeline.train_step import fit_step_fused

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's devices are {jax.devices()}")
    enable_compile_cache()
    log(f"device: {dev.platform} {dev.device_kind}")
    # bf16-RESIDENT X is the headline configuration: the loader/packer
    # path (native/packer.cpp, snapmat/loader.py) lands bf16 on the card.
    # Set BENCH_DTYPE=float32 for the full-precision measurement.
    gemm_dtype = dict(bfloat16=jnp.bfloat16, float32=jnp.float32)[
        os.environ.get("BENCH_DTYPE", "bfloat16")
    ]
    k1, k2 = jax.random.split(jax.random.key(0))
    omega = jax.random.normal(k2, (t_cols, sketch), dtype=jnp.float32)
    step = jax.jit(
        lambda x, om: fit_step_fused(x, om, n_components=k, gemm_dtype=gemm_dtype)
    )
    compile_s = []

    def timed_at(rows: int) -> float:
        x = jax.random.normal(k1, (rows, t_cols), dtype=jnp.float32).astype(
            gemm_dtype
        )
        t0 = time.perf_counter()
        jax.block_until_ready(step(x, omega))
        compile_s.append(round(time.perf_counter() - t0, 2))
        for _ in range(2):
            jax.block_until_ready(step(x, omega))
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            jax.block_until_ready(step(x, omega))
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    t_small = timed_at(s_rows)
    t_large = timed_at(3 * s_rows)
    dt = (t_large - t_small) / 2  # seconds per s_rows x t_cols step
    log(f"step at S: {t_small * 1e3:.3f} ms, at 3S: {t_large * 1e3:.3f} ms")
    return dt, {"step_ms_S": t_small * 1e3, "step_ms_3S": t_large * 1e3,
                "compile_s": compile_s}, dev


def main():
    s_rows = int(os.environ.get("BENCH_S", 1 << 19))
    t_cols = int(os.environ.get("BENCH_T", 512))
    k = int(os.environ.get("BENCH_K", 100))
    sketch = int(os.environ.get("BENCH_SKETCH", 128))

    dt, meta, dev = bench_fit_step(s_rows, t_cols, k, sketch)
    import jax

    out = {
        "metric": "snapshot_matrix_fit_throughput",
        "value": s_rows * t_cols / dt / 1e9,
        "unit": "Gelements/s",
        "shape": [s_rows, t_cols, k, sketch],
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
        **meta,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
