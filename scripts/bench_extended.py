"""Extended benchmarks: exact TSQR path, Hankel operator, optDMD.

The headline bench (bench.py) times the fused randomized fit step only;
these time the other production compute paths.  Each benchmark prints
one JSON line to stdout and everything is also merged into
``chiprun_out/BENCH_EXTENDED.json``.

Timing protocol: S-scalable paths are timed at S and 3S rows and
reported via the SLOPE (fixed per-call overheads cancel), each time the
minimum of several runs synchronized with ``block_until_ready``;
iteration-bound optDMD is reported as wall time.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def _sync(x):
    import jax

    return jax.block_until_ready(x)


def _min_time(fn, *args, iters: int = 8) -> float:
    _sync(fn(*args))
    _sync(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(out)
        times.append(time.perf_counter() - t0)
    return float(np.min(times))


def bench_exact_svd(s_rows: int, t_cols: int, k: int):
    """Exact truncated SVD: TSQR + small replicated SVD + basis lift."""
    import jax
    import jax.numpy as jnp

    from dmd_era5_tpu.ops.svd import exact_truncated_svd

    dev = jax.devices()[0]
    key = jax.random.key(0)

    def timed_at(rows: int) -> float:
        x = jax.device_put(
            jax.random.normal(key, (rows, t_cols), dtype=jnp.float32), dev
        )
        fn = jax.jit(lambda x: exact_truncated_svd(x, k).s)
        return _min_time(fn, x)

    t_small = timed_at(s_rows)
    t_large = timed_at(3 * s_rows)
    dt = (t_large - t_small) / 2
    log(f"exact svd: S {t_small*1e3:.1f} ms, 3S {t_large*1e3:.1f} ms, slope {dt*1e3:.2f} ms")
    return {
        "metric": "exact_tsqr_svd_throughput",
        "value": round(s_rows * t_cols / dt / 1e9, 4),
        "unit": "Gelements/s",
        "shape": [s_rows, t_cols, k],
        "step_ms": round(dt * 1e3, 3),
    }


def bench_exact_svd_gram(s_rows: int, t_cols: int, k: int):
    """Gram-route exact SVD: T x T eigh subspace + Rayleigh-Ritz."""
    import jax
    import jax.numpy as jnp

    from dmd_era5_tpu.ops.svd import exact_truncated_svd_gram

    dev = jax.devices()[0]
    key = jax.random.key(0)

    def timed_at(rows: int) -> float:
        x = jax.device_put(
            jax.random.normal(key, (rows, t_cols), dtype=jnp.float32), dev
        )
        # production default: the bf16_split Gram
        fn = jax.jit(
            lambda x: exact_truncated_svd_gram(
                x, k, gram_precision="bf16_split"
            ).s
        )
        return _min_time(fn, x)

    t_small = timed_at(s_rows)
    t_large = timed_at(3 * s_rows)
    dt = (t_large - t_small) / 2
    log(
        f"exact gram svd: S {t_small*1e3:.1f} ms, 3S {t_large*1e3:.1f} ms, "
        f"slope {dt*1e3:.2f} ms"
    )
    return {
        "metric": "exact_gram_svd_throughput",
        "value": round(s_rows * t_cols / dt / 1e9, 4),
        "unit": "Gelements/s",
        "shape": [s_rows, t_cols, k],
        "step_ms": round(dt * 1e3, 3),
    }


def bench_batched_optdmd(batch: int, s_rows: int, t_cols: int, rank: int):
    """Batched (EP) optDMD: B independent varpro fits in ONE vmapped LM."""
    import jax
    import jax.numpy as jnp

    from dmd_era5_tpu.models.optdmd import (
        optdmd_from_svd,
        optdmd_from_svd_batched,
    )
    from dmd_era5_tpu.ops.svd import randomized_svd

    dev = jax.devices()[0]
    rng = np.random.default_rng(1)
    tgrid = np.linspace(0.0, 4.0, t_cols).astype(np.float32)
    alphas = np.array([-0.2 + 3.1j, -0.5 + 1.2j, -0.05 + 6.0j])
    sig = np.real(np.exp(np.outer(alphas, tgrid)))
    us, ss, vs = [], [], []
    for _ in range(batch):
        modes = rng.standard_normal((s_rows, 3))
        x = (modes @ sig + 0.01 * rng.standard_normal((s_rows, t_cols))).astype(
            np.float32
        )
        res = randomized_svd(jax.device_put(jnp.asarray(x), dev), rank)
        us.append(res.U)
        ss.append(res.s)
        vs.append(res.V)
    u = jnp.stack(us)
    s = jnp.stack(ss)
    v = jnp.stack(vs)
    td = jax.device_put(jnp.asarray(tgrid), dev)

    t0 = time.perf_counter()
    optdmd_from_svd_batched(u, s, v, td, max_iter=30)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    optdmd_from_svd_batched(u, s, v, td, max_iter=30)
    batched_wall = time.perf_counter() - t0

    t0 = time.perf_counter()
    for b in range(batch):
        optdmd_from_svd(u[b], s[b], v[b], td, max_iter=30)
    loop_wall = time.perf_counter() - t0
    log(
        f"batched optdmd: first {first:.1f}s, batched {batched_wall*1e3:.1f} ms "
        f"vs per-member loop {loop_wall*1e3:.1f} ms "
        f"({loop_wall/batched_wall:.1f}x)"
    )
    return {
        "metric": "batched_optdmd_speedup",
        "value": round(loop_wall / batched_wall, 2),
        "unit": "x vs per-member loop (batch %d, rank %d)" % (batch, rank),
        "shape": [batch, s_rows, t_cols, rank],
        "batched_ms": round(batched_wall * 1e3, 2),
        "loop_ms": round(loop_wall * 1e3, 2),
    }


def bench_hankel_svd(s_rows: int, t_cols: int, d: int, k: int):
    """Hankel-operator randomized SVD (never materializes H_d(X))."""
    import jax
    import jax.numpy as jnp

    from dmd_era5_tpu.ops.hankel import hankel_randomized_svd

    dev = jax.devices()[0]
    key = jax.random.key(1)

    def timed_at(rows: int) -> float:
        x = jax.device_put(
            jax.random.normal(key, (rows, t_cols), dtype=jnp.float32), dev
        )
        fn = jax.jit(lambda x: hankel_randomized_svd(x, d=d, n_components=k).s)
        return _min_time(fn, x)

    t_small = timed_at(s_rows)
    t_large = timed_at(3 * s_rows)
    dt = (t_large - t_small) / 2
    # elements of the IMPLICIT embedded matrix actually processed
    elements = s_rows * d * (t_cols - d + 1)
    log(f"hankel svd: S {t_small*1e3:.1f} ms, 3S {t_large*1e3:.1f} ms, slope {dt*1e3:.2f} ms")
    return {
        "metric": "hankel_operator_svd_throughput",
        "value": round(elements / dt / 1e9, 4),
        "unit": "Gelements/s (embedded)",
        "shape": [s_rows, t_cols, d, k],
        "step_ms": round(dt * 1e3, 3),
    }


def bench_hankel_svd_fused(s_rows: int, t_cols: int, d: int, k: int):
    """Fused Hankel SVD: one Pallas pass per power iteration, bf16."""
    import jax
    import jax.numpy as jnp

    from dmd_era5_tpu.ops.hankel import hankel_randomized_svd_fused

    dev = jax.devices()[0]
    key = jax.random.key(1)

    def timed_at(rows: int) -> float:
        x = jax.device_put(
            jax.random.normal(key, (rows, t_cols), dtype=jnp.float32), dev
        )
        fn = jax.jit(
            lambda x: hankel_randomized_svd_fused(
                x, d=d, n_components=k, gemm_dtype=jnp.bfloat16
            ).s
        )
        return _min_time(fn, x)

    t_small = timed_at(s_rows)
    t_large = timed_at(3 * s_rows)
    dt = (t_large - t_small) / 2
    elements = s_rows * d * (t_cols - d + 1)
    log(
        f"hankel fused svd: S {t_small*1e3:.1f} ms, 3S {t_large*1e3:.1f} ms, "
        f"slope {dt*1e3:.2f} ms"
    )
    return {
        "metric": "hankel_operator_svd_fused_throughput",
        "value": round(elements / dt / 1e9, 4),
        "unit": "Gelements/s (embedded)",
        "shape": [s_rows, t_cols, d, k],
        "step_ms": round(dt * 1e3, 3),
    }


def bench_hankel_exact_svd(s_rows: int, t_cols: int, d: int, k: int):
    """Exact Hankel-operator SVD: banded raw-Gram + one fused pass."""
    import jax
    import jax.numpy as jnp

    from dmd_era5_tpu.ops.hankel import hankel_exact_svd

    dev = jax.devices()[0]
    key = jax.random.key(2)

    def timed_at(rows: int) -> float:
        x = jax.device_put(
            jax.random.normal(key, (rows, t_cols), dtype=jnp.float32), dev
        )
        fn = jax.jit(lambda x: hankel_exact_svd(x, d, k).s)
        return _min_time(fn, x)

    t_small = timed_at(s_rows)
    t_large = timed_at(3 * s_rows)
    dt = (t_large - t_small) / 2
    elements = s_rows * d * (t_cols - d + 1)
    log(
        f"hankel exact svd: S {t_small*1e3:.1f} ms, 3S {t_large*1e3:.1f} ms, "
        f"slope {dt*1e3:.2f} ms"
    )
    return {
        "metric": "hankel_exact_svd_throughput",
        "value": round(elements / dt / 1e9, 4),
        "unit": "Gelements/s (embedded)",
        "shape": [s_rows, t_cols, d, k],
        "step_ms": round(dt * 1e3, 3),
    }


def bench_optdmd(s_rows: int, t_cols: int, rank: int, max_iter: int):
    """End-to-end optDMD fit: randomized SVD + varpro LM."""
    import jax
    import jax.numpy as jnp

    from dmd_era5_tpu.models.optdmd import optdmd_from_svd
    from dmd_era5_tpu.ops.svd import randomized_svd

    dev = jax.devices()[0]
    rng = np.random.default_rng(0)
    # decaying-oscillator data so the LM iteration does real work
    tgrid = np.linspace(0.0, 4.0, t_cols).astype(np.float32)
    alphas = np.array([-0.2 + 3.1j, -0.5 + 1.2j, -0.05 + 6.0j])
    modes = rng.standard_normal((s_rows, 3))
    sig = np.real(np.exp(np.outer(alphas, tgrid)))
    x = (modes @ sig + 0.01 * rng.standard_normal((s_rows, t_cols))).astype(
        np.float32
    )
    xd = jax.device_put(jnp.asarray(x), dev)
    td = jax.device_put(jnp.asarray(tgrid), dev)

    def fit(xd, td):
        u, s, v = randomized_svd(xd, n_components=rank)
        res = optdmd_from_svd(u, s, v, td, rank=rank, max_iter=max_iter)
        return res.residual

    t0 = time.perf_counter()
    _sync(fit(xd, td))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        _sync(fit(xd, td))
        times.append(time.perf_counter() - t0)
    wall = float(np.min(times))
    log(f"optdmd: first {compile_s:.1f}s, steady {wall*1e3:.1f} ms")
    return {
        "metric": "optdmd_fit_wall_ms",
        "value": round(wall * 1e3, 2),
        "unit": "ms (end-to-end, rank %d, %d LM iters)" % (rank, max_iter),
        "shape": [s_rows, t_cols, rank],
    }


def main():
    import jax

    from dmd_era5_tpu.core.paths import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    log(f"device: {dev.platform} {getattr(dev, 'device_kind', '?')}")

    s_rows = int(os.environ.get("BENCH_S", 1 << 19))
    t_cols = int(os.environ.get("BENCH_T", 512))
    k = int(os.environ.get("BENCH_K", 100))

    results = [
        bench_exact_svd(s_rows, t_cols, k),
        bench_exact_svd_gram(s_rows, t_cols, k),
        bench_hankel_svd(s_rows // 4, t_cols, 4, k),
        bench_hankel_svd_fused(s_rows // 4, t_cols, 4, k),
        bench_hankel_exact_svd(s_rows // 4, t_cols, 4, k),
        bench_optdmd(1 << 16, 256, 8, 30),
        bench_batched_optdmd(8, 1 << 14, 256, 8),
    ]
    for r in results:
        print(json.dumps(r), flush=True)
    # merge-by-metric: this driver owns only the classic metrics — a
    # wholesale rewrite would delete the scale-run entries recorded by
    # era5_scale_bench.py (the round-4 record-destruction bug)
    from dmd_era5_tpu.utils.benchrec import merge_into_bench_record

    out = os.path.join(
        os.path.dirname(__file__), "..", "chiprun_out", "BENCH_EXTENDED.json"
    )
    os.makedirs(os.path.dirname(out), exist_ok=True)
    merge_into_bench_record(os.path.abspath(out), results)


if __name__ == "__main__":
    main()
