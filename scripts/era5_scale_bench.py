"""North-star config 3 at true 0.25-degree ERA5 scale, on the card.

The engine's design regime: one week of hourly
0.25-degree ERA5 — 3 variables x 5 pressure levels on the 721 x 1440
grid, S = 721*1440*15 = 15,573,600 rows, T = 168 columns — through the
paths built for it:

  inmem     bf16-resident memory-lean fit step (X ~5.2 GB on the card),
  streamed  out-of-core randomized SVD (n_iter + 2 disk passes),
  onepass   out-of-core two-sided sketch (ONE disk pass),

plus a month (T = 744, ~23 GB packed — the regime the streamed backends
exist for).  The reference's whole-matrix-in-RAM
numpy/sklearn path (/root/reference/src/dmd_era5/era5_svd/era5_svd.py:
251-258) cannot run this configuration at all: H_d(X) at f64 would need
~21 GB resident plus LAPACK workspace for the week, ~93 GB for the
month.

Synthetic data with a KNOWN spectrum: X = U_true diag(sigma) V_true^T +
noise, generated blockwise (never materialized on host), with the
host-side f64-accumulated Gram G = X^T X of the EXACT bf16-stored bytes
providing the oracle singular values (eigh of a T x T matrix).

Writes its measurements into chiprun_out/BENCH_EXTENDED.json (merged by
metric) and prints one JSON line per path.  The packed files are HDF5
(snapmat/loader.py), so this script needs h5py; the working directory is
``SCALE_BENCH_DIR`` (default: ``scale_bench/`` in the checkout,
git-ignored).

Usage: python scripts/era5_scale_bench.py [--month] [--rows N] [--skip-inmem]
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

GRID_LAT, GRID_LON = 721, 1440
N_FIELDS = 15  # 3 vars x 5 levels
R_TRUE = 128
NOISE = 0.02


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def _temporal_basis(t_cols: int, rng: np.random.Generator) -> np.ndarray:
    """(T, R_TRUE) smooth orthonormal-ish temporal factors."""
    t = np.arange(t_cols, dtype=np.float64)
    cols = []
    for j in range(R_TRUE):
        freq = 2.0 * np.pi * (j // 2 + 1) / t_cols
        phase = rng.uniform(0, 2 * np.pi)
        damp = np.exp(-0.2 * (j / R_TRUE) * t / t_cols)
        cols.append(damp * np.cos(freq * t + phase))
    v = np.stack(cols, axis=1)
    v, _ = np.linalg.qr(v)
    return v


def _spatial_block(g0: int, g1: int, s_space: int) -> np.ndarray:
    """(g1-g0, R_TRUE) analytic spherical-harmonic-ish spatial factors
    for global row ids [g0, g1) — field-major over the 0.25-deg grid."""
    g = np.arange(g0, g1, dtype=np.int64)
    field = (g // s_space).astype(np.float64)
    pix = g % s_space
    lat = np.deg2rad(90.0 - 0.25 * (pix // GRID_LON))
    lon = np.deg2rad(-180.0 + 0.25 * (pix % GRID_LON))
    cos_lat = np.cos(lat)
    out = np.empty((g1 - g0, R_TRUE), np.float64)
    for j in range(R_TRUE):
        m = j % 7 + 1
        p = j % 5 + 1
        fmod = np.cos(0.7 * field * (j % 3 + 1))
        out[:, j] = (
            cos_lat ** (1 + j % 2)
            * np.cos(m * lon + p * lat + 0.13 * j)
            * fmod
        )
    return out


def synthesize_packed(
    path: Path, n_rows: int, t_cols: int, block: int = 1 << 17, seed: int = 0
) -> np.ndarray:
    """Write the bf16 packed file blockwise; return oracle singular
    values of the exact stored (bf16-rounded) matrix via the f64 Gram."""
    import h5py
    import ml_dtypes

    rng = np.random.default_rng(seed)
    s_space = GRID_LAT * GRID_LON
    sigma = 120.0 * (np.arange(1, R_TRUE + 1, dtype=np.float64)) ** -0.7
    v_t = _temporal_basis(t_cols, rng)  # (T, R)
    w = (sigma[:, None] * v_t.T).astype(np.float32)  # (R, T)

    gram = np.zeros((t_cols, t_cols), np.float64)
    t0 = time.perf_counter()
    with h5py.File(path, "w") as f:
        dset = f.create_dataset(
            "X", shape=(n_rows, t_cols), dtype=np.uint16,
            chunks=(min(1 << 14, n_rows), t_cols),
        )
        f.attrs["bf16"] = 1
        f.attrs["delay_embedding"] = 1
        for g0 in range(0, n_rows, block):
            g1 = min(g0 + block, n_rows)
            u_blk = _spatial_block(g0, g1, s_space).astype(np.float32)
            x_blk = u_blk @ w  # (blk, T) f32
            x_blk += NOISE * rng.standard_normal(x_blk.shape).astype(
                np.float32
            )
            x_bf16 = x_blk.astype(ml_dtypes.bfloat16)
            dset[g0:g1] = x_bf16.view(np.uint16)
            # oracle Gram of the EXACT stored bytes (f32 sgemm per
            # block, f64 accumulation across blocks)
            xb = x_bf16.astype(np.float32)
            gram += (xb.T @ xb).astype(np.float64)
    log(
        f"  synthesized {n_rows} x {t_cols} bf16 "
        f"({n_rows * t_cols * 2 / 1e9:.1f} GB) in "
        f"{time.perf_counter() - t0:.1f}s"
    )
    evals = np.linalg.eigvalsh(gram)[::-1]
    s_raw = np.sqrt(np.maximum(evals, 0.0))
    # centered oracle from the SAME Gram: with mu = X 1/T,
    # (X - mu 1^T)^T (X - mu 1^T) = G - g 1^T - 1 g^T + (1^T g / T) 11^T
    # where g = G 1 / T — no second pass over the data
    ones = np.ones(t_cols)
    g1 = gram @ ones / t_cols
    gram_c = (
        gram
        - np.outer(g1, ones)
        - np.outer(ones, g1)
        + (ones @ g1 / t_cols) * np.outer(ones, ones)
    )
    s_cen = np.sqrt(np.maximum(np.linalg.eigvalsh(gram_c)[::-1], 0.0))
    return s_raw, s_cen


def check_oracle(s_got: np.ndarray, s_oracle: np.ndarray) -> dict:
    """Max relative singular-value error over the head (first 8) and
    over everything returned (the tail of a randomized decomposition is
    the loose end; report both rather than hiding either)."""
    n = min(len(s_got), len(s_oracle))
    # zero oracle values (exactly rank-deficient synthetics) carry no
    # relative error; measure those against s_oracle[0] instead
    denom = np.where(s_oracle[:n] > 0, s_oracle[:n], s_oracle[0])
    rel = np.abs(np.asarray(s_got[:n], np.float64) - s_oracle[:n]) / denom
    return {
        "oracle_s_rel_err_head8": float(np.max(rel[: min(8, n)])),
        "oracle_s_rel_err_all": float(np.max(rel)),
    }


def run_inmem(path: Path, k: int, sketch: int) -> dict:
    """bf16-resident memory-lean fit step: the file as one device array."""
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    from dmd_era5_tpu.pipeline.streamed_fit import prefetched_row_blocks
    from dmd_era5_tpu.pipeline.train_step import fit_step_lean
    from dmd_era5_tpu.snapmat.loader import packed_info

    (n_rows, t_cols), _, _ = packed_info(path)
    dev = jax.devices()[0]
    # the memory-lean fit: X + U on the card, Yc never materialized
    step = jax.jit(
        lambda x, om: fit_step_lean(
            x, om, n_components=k, gemm_dtype=jnp.bfloat16,
            u_dtype=jnp.bfloat16,
        )
    )
    x_spec = jax.ShapeDtypeStruct((n_rows, t_cols), jnp.bfloat16)
    om_spec = jax.ShapeDtypeStruct((t_cols, sketch), jnp.float32)
    t0 = time.perf_counter()
    compiled = step.lower(x_spec, om_spec).compile()
    compile_s = time.perf_counter() - t0

    log(f"inmem: loading {n_rows} x {t_cols} bf16 onto the card...")
    t0 = time.perf_counter()
    x_host = np.zeros((n_rows, t_cols), dtype=ml_dtypes.bfloat16)
    for r0, blk in prefetched_row_blocks(path, n_rows, 1 << 19):
        x_host[r0 : r0 + blk.shape[0]] = blk.view(ml_dtypes.bfloat16)
    x = jax.device_put(x_host, dev)
    x.block_until_ready()
    del x_host
    load_s = time.perf_counter() - t0
    log(f"  load: {load_s:.1f}s (compile {compile_s:.1f}s)")

    key = jax.random.key(0)
    omega = jax.device_put(
        jax.random.normal(key, (t_cols, sketch), jnp.float32), dev
    )
    out = jax.block_until_ready(compiled(x, omega))
    times = []
    for _ in range(8):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(x, omega))
        times.append(time.perf_counter() - t0)
    step_s = float(np.median(times))
    s_got = np.asarray(out.s)
    elems = n_rows * t_cols
    return {
        "metric": "era5_025deg_week_inmem_fit",
        "value": round(elems / step_s / 1e9, 2),
        "unit": "Gelements/s (median step of 8)",
        "shape": [n_rows, t_cols, k],
        "step_ms": round(step_s * 1e3, 1),
        "load_s": round(load_s, 1),
        "compile_s": round(compile_s, 1),
        "peak_host_rss_gb": round(peak_rss_gb(), 2),
        "_s_full": s_got,
    }


def run_streamed(path: Path, k: int, onepass: bool, tag: str) -> dict:
    from dmd_era5_tpu.pipeline.streamed_fit import (
        streamed_onepass_svd,
        streamed_randomized_svd,
    )
    from dmd_era5_tpu.snapmat.loader import packed_info

    (n_rows, t_cols), _, _ = packed_info(path)
    block_rows = 1 << 18
    t0 = time.perf_counter()
    if onepass:
        res = streamed_onepass_svd(path, k, block_rows=block_rows)
        passes = 1
    else:
        res = streamed_randomized_svd(path, k, block_rows=block_rows)
        from dmd_era5_tpu.ops.svd import sklearn_n_iter

        passes = sklearn_n_iter(k, (n_rows, t_cols)) + 2
    s_host = np.asarray(res.s)
    wall = time.perf_counter() - t0
    elems = n_rows * t_cols
    return {
        "metric": f"era5_025deg_{tag}",
        "value": round(elems / wall / 1e9, 4),
        "unit": f"Gelements/s (end-to-end wall, {passes} passes)",
        "shape": [n_rows, t_cols, k],
        "wall_s": round(wall, 1),
        "disk_passes": passes,
        "peak_host_rss_gb": round(peak_rss_gb(), 2),
        "singular_values": s_host[:8].tolist(),
        "_s_full": s_host,
    }


def synthesize_year(
    path: Path, n_rows: int, t_cols: int = 8760, block: int = 1 << 16,
    seed: int = 0,
) -> np.ndarray:
    """Long-time-axis synthetic (north-star config 5: a full hourly
    year, T = 8760): X = U diag(sigma) V^T with V orthonormal (host f64
    QR of smooth temporal factors) and NO noise — the oracle is then
    EXACT in the R-space: X^T X = V S (U^T U) S V^T, so the true
    singular values are sqrt(eig(S G_U S)) with G_U = U^T U accumulated
    blockwise in f64 (2 S R^2 flops — seconds at any S, no T x T host
    Gram needed).  bf16 storage rounding is the only perturbation.

    Returns the exact singular values of the UNROUNDED matrix.
    """
    rng = np.random.default_rng(seed)
    s_space = GRID_LAT * GRID_LON
    sigma = 120.0 * (np.arange(1, R_TRUE + 1, dtype=np.float64)) ** -0.7
    v_t = _temporal_basis(t_cols, rng)  # (T, R) orthonormal f64
    w = (sigma[:, None] * v_t.T).astype(np.float32)  # (R, T)

    import h5py
    import ml_dtypes

    gu = np.zeros((R_TRUE, R_TRUE), np.float64)
    t0 = time.perf_counter()
    with h5py.File(path, "w") as f:
        dset = f.create_dataset(
            "X", shape=(n_rows, t_cols), dtype=np.uint16,
            chunks=(min(1 << 13, n_rows), min(t_cols, 1024)),
        )
        f.attrs["bf16"] = 1
        f.attrs["delay_embedding"] = 1
        for g0 in range(0, n_rows, block):
            g1 = min(g0 + block, n_rows)
            u_blk = _spatial_block(g0, g1, s_space)  # f64
            gu += u_blk.T @ u_blk
            x_blk = (u_blk.astype(np.float32)) @ w  # (blk, T) f32
            dset[g0:g1] = x_blk.astype(ml_dtypes.bfloat16).view(np.uint16)
    log(
        f"  synthesized {n_rows} x {t_cols} bf16 "
        f"({n_rows * t_cols * 2 / 1e9:.1f} GB) in "
        f"{time.perf_counter() - t0:.1f}s"
    )
    # exact spectrum from the R-space identity (V orthonormal)
    core = (sigma[:, None] * gu) * sigma[None, :]
    s_true = np.sqrt(np.maximum(np.linalg.eigvalsh(core)[::-1], 0.0))
    return s_true


def run_streamed_exact(path: Path, k: int, tag: str) -> dict:
    """2-pass out-of-core EXACT Gram SVD (streamed_exact_gram_svd):
    two disk passes instead of the randomized schedule's n_iter + 2, and
    the result is exact rather than sketched."""
    from dmd_era5_tpu.pipeline.streamed_fit import streamed_exact_gram_svd
    from dmd_era5_tpu.snapmat.loader import packed_info

    (n_rows, t_cols), _, _ = packed_info(path)
    t0 = time.perf_counter()
    res = streamed_exact_gram_svd(path, k, block_rows=1 << 18)
    s_host = np.asarray(res.s)
    wall = time.perf_counter() - t0
    elems = n_rows * t_cols
    return {
        "metric": f"era5_025deg_{tag}",
        "value": round(elems / wall / 1e9, 4),
        "unit": "Gelements/s (end-to-end wall, 2 passes, exact)",
        "shape": [n_rows, t_cols, k],
        "wall_s": round(wall, 1),
        "disk_passes": 2,
        "peak_host_rss_gb": round(peak_rss_gb(), 2),
        "_s_full": s_host,
    }


def run_dmd_holdout(
    path: Path, k: int, rank: int, holdout: int,
    svd_route: str = "randomized", tag: str = "week_dmd_holdout",
) -> dict:
    """DMD + blockwise holdout verification out-of-core (round-4
    item 2): streamed SVD on the TRAIN columns only, subspace DMD fit
    (k-sized solves, one U-lift GEMM), then the out-of-core scoring
    chain — rollout/undo/score streamed in row blocks, truth read
    blockwise from the packed artifact.  Host residency: U (S, k) f32 +
    truth (S, h) f32; device residency: O(one block) everywhere.

    ``svd_route="exact"`` uses the 2-pass exact Gram SVD."""
    import jax.numpy as jnp
    import ml_dtypes

    from dmd_era5_tpu.models.forecast import streamed_forecast_scores
    from dmd_era5_tpu.models.verification import ScoreAccumulator
    from dmd_era5_tpu.pipeline.streamed_fit import (
        prefetched_row_blocks,
        streamed_exact_gram_svd,
        streamed_randomized_svd,
    )
    from dmd_era5_tpu.snapmat.loader import packed_info

    (n_rows, t_cols), _, _ = packed_info(path)
    t_train = t_cols - holdout

    t0 = time.perf_counter()
    if svd_route == "exact":
        svd = streamed_exact_gram_svd(
            path, k, block_rows=1 << 18, col_limit=t_train
        )
    else:
        svd = streamed_randomized_svd(
            path, k, block_rows=1 << 18, col_limit=t_train
        )
    svd_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    # exact DMD on the PROJECTED factors z = s V (k x T host-small
    # solves; amplitudes from the mode pinv against x0 — no exp-column
    # underflow for heavily damped noise modes), then ONE (S, k) x
    # (k, rank) complex mode lift through U — the only S-sized work
    from dmd_era5_tpu.models.dmd import DMDResult, exact_dmd

    z = np.asarray(svd.s)[:, None] * np.asarray(svd.V)  # (k, T_train)
    proj = exact_dmd(jnp.asarray(z), rank=rank, dt=1.0)
    phi_p = np.asarray(proj.modes)  # (k, rank) complex
    u_dev = jnp.asarray(np.asarray(svd.U))
    phi = (
        np.asarray(
            jnp.matmul(u_dev, jnp.asarray(phi_p.real.astype(np.float32)))
        )
        + 1j
        * np.asarray(
            jnp.matmul(u_dev, jnp.asarray(phi_p.imag.astype(np.float32)))
        )
    ).astype(np.complex64)
    res = DMDResult(
        proj.eigenvalues, proj.omega, phi, proj.amplitudes, proj.dt
    )
    n_modes_used = int(
        np.isfinite(np.asarray(proj.amplitudes)).sum()
    )
    fit_s = time.perf_counter() - t0

    # truth + persistence: one blockwise pass over the packed file
    # (row-chunked storage reads full rows; the pass doubles as the
    # per-row latitude stream).  O(S*h) host residency by design.
    t0 = time.perf_counter()
    truth = np.empty((n_rows, holdout), np.float32)
    persist = np.empty((n_rows,), np.float32)
    for r0, blk in prefetched_row_blocks(path, n_rows, 1 << 19):
        xb = blk.view(ml_dtypes.bfloat16).astype(np.float32)
        truth[r0 : r0 + xb.shape[0]] = xb[:, t_train:]
        persist[r0 : r0 + xb.shape[0]] = xb[:, t_train - 1]
    read_s = time.perf_counter() - t0

    s_space = GRID_LAT * GRID_LON
    pix = np.arange(n_rows, dtype=np.int64) % s_space
    lat_rows = (90.0 - 0.25 * (pix // GRID_LON)).astype(np.float32)

    t0 = time.perf_counter()
    t_leads = np.arange(t_train, t_cols, dtype=np.float32)
    scores = streamed_forecast_scores(
        res, t_leads, truth, latitudes=lat_rows
    )
    from dmd_era5_tpu.models.verification import _space_weights

    w_rows = np.asarray(_space_weights(lat_rows, n_rows))
    acc_p = ScoreAccumulator()
    for r0 in range(0, n_rows, 1 << 20):
        r1 = min(r0 + (1 << 20), n_rows)
        acc_p.update(
            np.repeat(persist[r0:r1, None], holdout, axis=1),
            truth[r0:r1],
            w_rows[r0:r1],
        )
    p_scores = acc_p.finalize()
    score_s = time.perf_counter() - t0

    return {
        "metric": f"era5_025deg_{tag}",
        "svd_route": svd_route,
        "value": round(svd_s + fit_s + read_s + score_s, 1),
        "unit": f"s end-to-end (train {t_train} cols, {holdout} leads, "
        f"rank {rank})",
        "shape": [n_rows, t_cols, k, rank],
        "svd_s": round(svd_s, 1),
        "dmd_fit_s": round(fit_s, 1),
        "modes_used": n_modes_used,
        "truth_read_s": round(read_s, 1),
        "score_s": round(score_s, 1),
        "rmse_first_last": [
            round(float(scores["rmse"][0]), 4),
            round(float(scores["rmse"][-1]), 4),
        ],
        "acc_first_last": [
            round(float(scores["acc"][0]), 4),
            round(float(scores["acc"][-1]), 4),
        ],
        "persistence_rmse_first_last": [
            round(float(p_scores["rmse"][0]), 4),
            round(float(p_scores["rmse"][-1]), 4),
        ],
        "peak_host_rss_gb": round(peak_rss_gb(), 2),
    }


def merge_into_bench_extended(entries: list[dict]) -> None:
    from dmd_era5_tpu.utils.benchrec import merge_into_bench_record

    out = Path(__file__).resolve().parent.parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    merge_into_bench_record(out / "BENCH_EXTENDED.json", entries)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--month", action="store_true",
                    help="also run the T=744 month via streamed")
    ap.add_argument("--dmd-holdout", action="store_true",
                    help="DMD + blockwise holdout scores at the week shape")
    ap.add_argument("--week-exact", action="store_true",
                    help="only the 2-pass exact Gram leg at the week shape "
                    "(standalone; also runs as part of the full week)")
    ap.add_argument("--year", action="store_true",
                    help="full-hourly-year leg: T=8760 long-time-axis "
                    "out-of-core exact SVD (north-star config 5)")
    ap.add_argument("--year-rows", type=int, default=1 << 20,
                    help="rows for the year leg (default 1M ~ 17.5 GB "
                    "packed)")
    ap.add_argument("--month-dmd", action="store_true",
                    help="DMD + blockwise holdout at the MONTH shape "
                    "(exact 2-pass SVD route; 48 withheld leads)")
    ap.add_argument("--rows", type=int, default=GRID_LAT * GRID_LON * N_FIELDS)
    ap.add_argument("--week-cols", type=int, default=168)
    ap.add_argument("--skip-inmem", action="store_true")
    ap.add_argument("--skip-week", action="store_true")
    ap.add_argument("--keep-files", action="store_true")
    ap.add_argument("--k", type=int, default=100)
    args = ap.parse_args()

    import jax

    from dmd_era5_tpu.core.paths import enable_compile_cache

    enable_compile_cache()
    dev = jax.devices()[0]
    log(f"device: {dev.platform} {getattr(dev, 'device_kind', '?')}")

    workdir = Path(
        os.environ.get(
            "SCALE_BENCH_DIR", Path(__file__).resolve().parent.parent / "scale_bench"
        )
    )
    workdir.mkdir(parents=True, exist_ok=True)
    entries = []

    # ---- week: S x 168 ----
    week = workdir / "week.h5"
    if args.skip_week:
        week = None  # month-only run

    if week is not None:
        _run_week(args, workdir, week, entries)

    if args.week_exact:
        week_file = workdir / "week.h5"
        oracle_cache = (
            workdir / f"week_oracle_{args.rows}_{args.week_cols}.npz"
        )
        if week_file.exists() and oracle_cache.exists():
            s_oracle = np.load(oracle_cache)["s_raw"]
        else:
            s_oracle, s_cen = synthesize_packed(
                week_file, args.rows, args.week_cols
            )
            np.savez(oracle_cache, s_raw=s_oracle, s_cen=s_cen)
        e = run_streamed_exact(week_file, args.k, "week_streamed_exact")
        e.update(check_oracle(e.pop("_s_full"), s_oracle))
        log(json.dumps(e))
        entries.append(e)
        merge_into_bench_extended([e])

    if args.month_dmd:
        month_file = workdir / "month.h5"
        if not month_file.exists():
            s_m, _ = synthesize_packed(month_file, args.rows, 744)
            np.savez(
                workdir / f"month_oracle_{args.rows}_744.npz", s_raw=s_m
            )
        e = run_dmd_holdout(
            month_file, args.k, rank=16, holdout=48,
            svd_route="exact", tag="month_dmd_holdout",
        )
        log(json.dumps(e))
        entries.append(e)
        merge_into_bench_extended([e])

    if args.dmd_holdout:
        week_file = workdir / "week.h5"
        if not week_file.exists():
            oracle_cache = (
                workdir / f"week_oracle_{args.rows}_{args.week_cols}.npz"
            )
            s_raw, s_cen = synthesize_packed(
                week_file, args.rows, args.week_cols
            )
            np.savez(oracle_cache, s_raw=s_raw, s_cen=s_cen)
        e = run_dmd_holdout(week_file, args.k, rank=16, holdout=24)
        log(json.dumps(e))
        entries.append(e)
        merge_into_bench_extended([e])

    # ---- year: T = 8760 long-time-axis, out-of-core exact ----
    if args.year:
        year = workdir / "year.h5"
        oracle_cache_y = workdir / f"year_oracle_{args.year_rows}_8760.npz"
        log(f"=== year: {args.year_rows} x 8760 ===")
        if year.exists() and oracle_cache_y.exists():
            s_oracle_y = np.load(oracle_cache_y)["s_true"]
            log("  reusing existing packed file + oracle")
        else:
            s_oracle_y = synthesize_year(year, args.year_rows)
            np.savez(oracle_cache_y, s_true=s_oracle_y)
        from dmd_era5_tpu.pipeline.streamed_fit import (
            streamed_exact_gram_svd,
        )
        from dmd_era5_tpu.snapmat.loader import packed_info

        (n_rows_y, t_cols_y), _, _ = packed_info(year)
        t0 = time.perf_counter()
        # ~300 MB blocks: the long time axis makes rows wide
        res = streamed_exact_gram_svd(year, args.k, block_rows=1 << 14)
        wall = time.perf_counter() - t0
        e = {
            "metric": "era5_year_T8760_exact_gram",
            "value": round(n_rows_y * t_cols_y / wall / 1e9, 4),
            "unit": "Gelements/s (end-to-end wall, 2 passes, exact)",
            "shape": [n_rows_y, t_cols_y, args.k],
            "wall_s": round(wall, 1),
            "disk_passes": 2,
            "peak_host_rss_gb": round(peak_rss_gb(), 2),
        }
        e.update(check_oracle(np.asarray(res.s), s_oracle_y))
        log(json.dumps(e))
        entries.append(e)
        merge_into_bench_extended([e])
        if not args.keep_files:
            year.unlink(missing_ok=True)

    # ---- month: S x 744, out-of-core (~23 GB packed) ----
    if args.month:
        month = workdir / "month.h5"
        log(f"=== month: {args.rows} x 744 ===")
        oracle_cache_m = workdir / f"month_oracle_{args.rows}_744.npz"
        if month.exists() and oracle_cache_m.exists():
            cached = np.load(oracle_cache_m)
            s_oracle_m = cached["s_raw"]
            log("  reusing existing packed file + oracle")
        else:
            s_oracle_m, _ = synthesize_packed(month, args.rows, 744)
            np.savez(oracle_cache_m, s_raw=s_oracle_m)
        # the 2-pass exact Gram route returns the exact spectrum the
        # oracle checks against
        e = run_streamed_exact(month, args.k, "month_streamed_exact")
        e.update(check_oracle(e.pop("_s_full"), s_oracle_m))
        log(json.dumps(e))
        entries.append(e)
        merge_into_bench_extended([e])  # record immediately, crash-safe
        if not args.keep_files:
            month.unlink(missing_ok=True)

    merge_into_bench_extended(entries)
    for e in entries:
        print(json.dumps(e))


def _run_week(args, workdir, week, entries):
    log(f"=== week: {args.rows} x {args.week_cols} ===")
    oracle_cache = workdir / f"week_oracle_{args.rows}_{args.week_cols}.npz"
    if week.exists() and oracle_cache.exists():
        cached = np.load(oracle_cache)
        s_oracle, s_oracle_cen = cached["s_raw"], cached["s_cen"]
        log("  reusing existing packed file + oracle")
    else:
        s_oracle, s_oracle_cen = synthesize_packed(
            week, args.rows, args.week_cols
        )
        np.savez(oracle_cache, s_raw=s_oracle, s_cen=s_oracle_cen)
    log(f"  oracle s[0..4]: {s_oracle[:5].round(2).tolist()}")

    if not args.skip_inmem:
        e = run_inmem(week, args.k, args.k + 28)
        # the fused fit CENTERS X, so compare against the centered oracle
        e.update(check_oracle(e.pop("_s_full"), s_oracle_cen))
        log(json.dumps(e))
        entries.append(e)
        merge_into_bench_extended([e])  # record immediately, crash-safe

    for onepass, tag in ((False, "week_streamed"), (True, "week_onepass")):
        e = run_streamed(week, args.k, onepass, tag)
        # oracle: top singular values against the exact f64 Gram of the
        # stored bytes (loose for onepass — one-pass trades accuracy)
        e.update(check_oracle(e.pop("_s_full"), s_oracle))
        e.pop("singular_values", None)
        log(json.dumps(e))
        entries.append(e)
        merge_into_bench_extended([e])  # record immediately, crash-safe

    # 2-pass exact Gram route at the same shape (3x fewer disk/h2d
    # passes than the 6-pass randomized schedule AND exact)
    e = run_streamed_exact(week, args.k, "week_streamed_exact")
    e.update(check_oracle(e.pop("_s_full"), s_oracle))
    log(json.dumps(e))
    entries.append(e)
    merge_into_bench_extended([e])

    if not args.keep_files:
        week.unlink(missing_ok=True)


if __name__ == "__main__":
    main()
