"""Times of the plain-XLA forms of the hot-path products on the GPU.

At the 0.25-degree ERA5 week shape (15,573,600 x 168, k = 100,
r = 128), synthetic data made on the card:

- the fused ingest pass (ops.matmul.sketch_center_gram_project, bf16),
  beside its one-read bound (X read once, Yc written once, at the
  published 3.35 TB/s) and a measured elementwise copy of X;
- the streamed sketch GEMM X @ Omega (bf16 in, f32 out);
- the T x T Gram at HIGHEST and in the bf16 hi/lo split (ops.qr_panel);
- the TSQR leaf on an S/4 x 168 panel: XLA's Householder QR against
  CholQR2 and its split-Gram variant, with orthogonality, residual and
  singular-value error of each.

Prints the card's name and power limit, one line per measurement, and
writes the same as JSON to ``chiprun_out/plain_kernel_times.json``.
Exits non-zero without a GPU.

Usage: python scripts/plain_kernel_times.py [--seed N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    smi = cs.nvidia_smi()
    import jax
    import jax.numpy as jnp

    from dmd_era5_tpu.core.paths import enable_compile_cache
    from dmd_era5_tpu.ops.matmul import sketch_center_gram_project
    from dmd_era5_tpu.ops.qr_panel import gram
    from dmd_era5_tpu.ops.tsqr import _local_factor

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's devices are {jax.devices()}")
    enable_compile_cache()
    rows, cols, r = cs.WEEK_ROWS, cs.WEEK_COLS, cs.SKETCH
    x = cs.synth_matrix(args.seed, rows, cols, dev)
    omega = jax.random.normal(jax.random.key(args.seed + 1), (cols, r), jnp.float32)
    om16 = omega.astype(jnp.bfloat16)
    hi = jax.lax.Precision.HIGHEST
    results = {"card": smi, "shape": [rows, cols], "sketch": r}

    def record(name, seconds, note=""):
        results[name] = seconds
        print(f"{name}: {seconds * 1e3:.3f} ms {note}", flush=True)

    ingest = jax.jit(lambda a, w: sketch_center_gram_project(
        a, w, out_dtype=jnp.bfloat16, scalar_stats=True))
    record("ingest_pass_bf16", cs.timed(ingest, x, om16),
           "(Yc, stats, G, C; median of 7)")
    bound = (rows * cols * 2 + rows * r * 2) / 3.35e12
    record("ingest_one_read_bound", bound, "(X read + Yc write at 3.35 TB/s)")
    copy = jax.jit(lambda a: a * jnp.bfloat16(2))
    t_copy = cs.timed(copy, x)
    record("copy_x_bf16", t_copy,
           f"(read + write of X: {2 * rows * cols * 2 / t_copy / 1e12:.2f} TB/s)")
    sketch = jax.jit(lambda a, w: jnp.matmul(a, w, preferred_element_type=jnp.float32))
    record("sketch_gemm_bf16", cs.timed(sketch, x, om16), "(X @ Omega, f32 out)")

    x32 = x.astype(jnp.float32)
    for prec in (hi, "bf16_split"):
        g = jax.jit(lambda a, p=prec: gram(a, precision=p))
        record(f"gram_f32_{getattr(prec, 'name', prec)}", cs.timed(g, x32), "(T x T)")
    del x32

    panel = x[: rows // 4].astype(jnp.float32)
    g64 = cs.host_gram(x[: rows // 4])
    s_ref = cs.gram_singular_values(g64)
    for method in ("householder", "cholqr2", "cholqr2_split"):
        leaf = jax.jit(lambda a, m=method: _local_factor(a, m))
        secs = cs.timed(leaf, panel, runs=5)
        q, rr = leaf(panel)
        qtq = jnp.matmul(q.T, q, precision=hi)
        orth = float(jnp.abs(qtq - jnp.eye(cols)).max())
        resid = float(jnp.linalg.norm(jnp.matmul(q, rr, precision=hi) - panel)
                      / jnp.linalg.norm(panel))
        s_e = cs.s_err(np.linalg.svd(np.asarray(rr, np.float64), compute_uv=False), s_ref)
        results[f"qr_leaf_{method}_errors"] = [orth, resid, s_e]
        record(f"qr_leaf_{method}", secs,
               f"({rows // 4} x {cols} f32; |Q^T Q - I| {orth:.2e}, "
               f"residual {resid:.2e}, s err {s_e:.2e})")
        del q, rr, qtq

    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "plain_kernel_times.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(f"card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
