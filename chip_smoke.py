"""Smoke test of the main path on one NVIDIA GPU, at the ERA5 week width.

Runs the system through the entry points a user calls, on the card, at
the 0.25-degree hourly week: 721 x 1440 grid x 3 variables x 5 levels =
15,573,600 rows, 168 columns, k = 100 components, sketch r = 128.  The
data is synthetic with a known spectrum, made on the card from
``--seed``.  Every phase compares with a plain reference that does not
share the code under test (numpy float64 on the host, or the repo's host
oracles), prints its error beside its tolerance and precision, and any
failure ends the run with a non-zero exit code.

Phases, in order:

1. device      nvidia-smi name and power limit, JAX version (no backend
               yet: the next phase needs the card to itself);
2. gpu tests   ``pytest -m gpu`` in a subprocess;
   device/jax  the JAX devices (platform must be ``gpu``), and no Pallas
               TPU backend or interpreter reachable from the package;
3. ingest      the fused ingest pass on a 2^20-row slice vs float64;
4. fit step    ``fit_step_fused`` at the week shape, bf16-resident X;
5. svd         ``truncated_svd`` (standard, randomized) as the stage's
               in-memory backend calls it, then the Hankel operator SVDs
               at d = 2;
6. dmd         optimized DMD + rollout on the phase-5 factors, and the
               planted-spectrum checks of optDMD, BOP-DMD, mrDMD, DMDc;
7. stages      mock ingest -> SVD -> optimized DMD with holdout scoring
               through the stage mains, the artifact store and the cache
               ladder, vs the mock-ERA5 host oracle.

``--four`` runs only the mesh paths on four cards (space-sharded fit
step, TSQR and Hankel SVD over ``space=4``, the BOP-DMD bag over
``data=4``) with their comparisons.

The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Usage: python chip_smoke.py [--four] [--seed N]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

WEEK_ROWS = 721 * 1440 * 15  # 15,573,600
WEEK_COLS = 168
K = 100
SKETCH = 128
R_TRUE = 128  # rank of the planted signal
NOISE = 0.02
INGEST_ROWS = 1 << 20
HOLDOUT_COLS = 8  # zero-padded trailing columns of the t_valid cases


def log(msg: str = "") -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    log(f"== phase {name}")
    t0 = time.perf_counter()
    yield
    log(f"== phase {name}: ok, {time.perf_counter() - t0:.1f} s wall")


def check(name: str, err: float, tol: float, precision: str) -> None:
    """Print ``err`` beside ``tol``; raise unless err <= tol (NaN fails)."""
    ok = bool(err <= tol)
    log(f"  {'ok  ' if ok else 'FAIL'} {name}: err {err:.3e} tol {tol:.0e} ({precision})")
    if not ok:
        raise AssertionError(f"{name}: error {err:.3e} above tolerance {tol:.0e}")


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in float64."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def s_err(got, want) -> float:
    """Singular-value error: max_i |s_i - s_ref_i| / s_ref_0."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)[: len(got)]
    return float(np.abs(got - want).max() / want[0])


def nvidia_smi() -> str:
    """``name, power.limit`` of the card(s), as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def timed(fn, *args, runs: int = 7, warmup: int = 2) -> float:
    """Median seconds of ``fn(*args)`` after warm-up, device-synchronized."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


# --------------------------------------------------------------- data


def synth_matrix(seed: int, rows: int, cols: int, device=None):
    """bf16 (rows, cols) X = U diag(sigma) V^T + noise, made on the card.

    sigma_j = j^-0.7 over a rank-min(128, cols) signal whose temporal
    factors V are orthonormalized damped oscillations (so X is a linear
    dynamical system DMD can fit); U and the noise are standard normal.
    """
    import jax
    import jax.numpy as jnp

    rank = min(R_TRUE, cols)

    @jax.jit
    def make(key):
        k1, k2, k3 = jax.random.split(key, 3)
        t = jnp.arange(cols, dtype=jnp.float32)[:, None]
        j = jnp.arange(rank, dtype=jnp.float32)[None, :]
        phase = jax.random.uniform(k2, (1, rank), jnp.float32, 0.0, 2 * jnp.pi)
        osc = jnp.exp(-0.2 * (j / rank) * t / cols) * jnp.cos(
            2 * jnp.pi * (j // 2 + 1) / cols * t + phase
        )
        v, _ = jnp.linalg.qr(osc)
        sigma = (1.0 + jnp.arange(rank, dtype=jnp.float32)) ** -0.7
        u = jax.random.normal(k1, (rows, rank), jnp.float32)
        x = jnp.matmul(
            u * sigma, v.T, precision=jax.lax.Precision.HIGHEST
        ) + NOISE * jax.random.normal(k3, (rows, cols), jnp.float32)
        return x.astype(jnp.bfloat16)

    with jax.default_device(device or jax.devices()[0]):
        return make(jax.random.key(seed))


def host_gram(x, block: int = 1 << 20) -> np.ndarray:
    """X^T X of the stored (bf16) values: f32 products per row block,
    float64 accumulation across blocks."""
    x_host = np.asarray(x)
    g = np.zeros((x_host.shape[1],) * 2, np.float64)
    for r0 in range(0, x_host.shape[0], block):
        xb = x_host[r0 : r0 + block].astype(np.float32)
        g += (xb.T @ xb).astype(np.float64)
    return g


def centered_gram(g: np.ndarray) -> np.ndarray:
    """(X - mu 1^T)^T (X - mu 1^T) from G = X^T X, mu the row means:
    G - g 1^T - 1 g^T + (1^T g / T) 1 1^T with g = G 1 / T."""
    t = g.shape[0]
    ones = np.ones(t)
    gm = g @ ones / t
    return g - np.outer(gm, ones) - np.outer(ones, gm) + (ones @ gm / t) * np.outer(ones, ones)


def gram_singular_values(g: np.ndarray) -> np.ndarray:
    return np.sqrt(np.maximum(np.linalg.eigvalsh(g)[::-1], 0.0))


def hankel_gram(g: np.ndarray, d: int) -> np.ndarray:
    """Gram of the delay embedding H_d(X) from the raw Gram (banded sum)."""
    t_out = g.shape[0] - d + 1
    return sum(g[b : b + t_out, b : b + t_out] for b in range(d))


def sketch_oracle(gc: np.ndarray, omega: np.ndarray, k: int):
    """Singular values and loss of the rank-k sketch fit Q Q^T Xc, with
    Q = orth(Xc Omega), from the centered Gram alone:
    Y^T Y = Omega^T Gc Omega = R^T R, B = Q^T Xc = R^-T Omega^T Gc."""
    om = omega.astype(np.float64)
    r = np.linalg.cholesky(om.T @ gc @ om).T
    b = np.linalg.solve(r.T, om.T @ gc)
    s = np.linalg.svd(b, compute_uv=False)[:k]
    total = np.trace(gc)
    return s, float(np.sqrt(max(total - np.sum(s**2), 0.0) / total))


# ------------------------------------------------------------- phases


def run_gpu_tests() -> None:
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    cmd = [
        sys.executable, "-m", "pytest", "-m", "gpu", "tests", "-q",
        "-p", "no:cacheprovider", "-p", "no:randomly",
    ]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=600)
    tail = (out.stdout.strip().splitlines() or [""])[-1]
    log(f"  {' '.join(cmd[1:])}: {tail}")
    if out.returncode != 0 or " passed" not in tail or "skipped" in tail:
        log(out.stdout[-4000:] + out.stderr[-4000:])
        raise AssertionError(f"pytest -m gpu failed (exit {out.returncode})")


def check_devices(n_expected: int):
    import jax

    import dmd_era5_tpu  # noqa: F401  (import the package before looking)

    devs = jax.devices()
    log(f"  jax {jax.__version__}: {devs}")
    if devs[0].platform != "gpu":
        raise RuntimeError(f"no GPU: JAX's devices are {devs}")
    if len(devs) < n_expected:
        raise RuntimeError(f"need {n_expected} GPUs, JAX sees {len(devs)}")
    def is_tpu_pallas(module: str) -> bool:
        parts = module.split(".")
        return parts[:3] == ["jax", "experimental", "pallas"] and parts[3:4] == ["tpu"]

    loaded = [m for m in sys.modules if is_tpu_pallas(m)]
    if loaded:
        raise AssertionError(f"the package imported {loaded}")
    import ast

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dmd_era5_tpu")
    for dirpath, _, files in os.walk(root):
        for f in (f for f in files if f.endswith(".py")):
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Call) and any(
                    kw.arg == "interpret" for kw in node.keywords
                ):
                    raise AssertionError(f"{f}: a call runs in the Pallas interpreter")
                if isinstance(node, ast.ImportFrom) and node.module and (
                    is_tpu_pallas(node.module)
                    or (node.module == "jax.experimental.pallas"
                        and any(a.name == "tpu" for a in node.names))
                ):
                    raise AssertionError(f"{f} imports the TPU Pallas backend")
    log("  no Pallas TPU backend or interpreter in the package")
    return devs


def phase_ingest(seed: int, rows: int = INGEST_ROWS, cols: int = WEEK_COLS) -> None:
    """The fused ingest pass vs float64, f32 and bf16 inputs."""
    import jax.numpy as jnp

    from dmd_era5_tpu.ops.matmul import sketch_center_gram_project

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, cols), dtype=np.float32)
    w = rng.standard_normal((cols, SKETCH), dtype=np.float32)
    t_valid = cols - HOLDOUT_COLS
    x_pad = x.copy()
    x_pad[:, t_valid:] = 0.0
    # bf16: Yc carries its own bf16 rounding (~4e-3); G, C and the stats
    # are f32 sums of exact products, to ~1e-5 over the row-block chains
    # of the tensor cores (ops.matmul.row_contract)
    for dtype, tol_y, tol, prec in (
        ("float32", 1e-5, 1e-5, "f32 inputs, Precision.HIGHEST"),
        ("bfloat16", 1e-2, 2e-5, "bf16 inputs, f32 accumulation, bf16 Yc"),
    ):
        dt = jnp.dtype(dtype)
        for opts in (
            {},
            {"stats_col": True, "scalar_stats": True, "t_valid": t_valid},
        ):
            xin = x_pad if "t_valid" in opts else x
            xq = jnp.asarray(xin).astype(dt)
            wq = jnp.asarray(w).astype(dt)
            yc, rs, ssq, g, c = sketch_center_gram_project(
                xq, wq, out_dtype=dt, **opts
            )
            x64 = np.asarray(xq.astype(jnp.float32), np.float64)
            w64 = np.asarray(wq.astype(jnp.float32), np.float64)
            if opts.get("stats_col"):
                w64[:, -1] = 1.0
                w64[t_valid:, -1] = 0.0
            t_true = opts.get("t_valid", cols)
            rs64 = x64.sum(axis=1)
            ssq64 = (x64 * x64).sum(axis=1)
            y64 = x64 @ w64 - np.outer(rs64 / t_true, w64.sum(axis=0))
            # G and C describe the STORED Yc
            yq = np.asarray(yc.astype(jnp.float32), np.float64)
            tag = f"{dtype} {opts or 'defaults'}"
            check(f"ingest Yc [{tag}]", rel_err(yc.astype(jnp.float32), y64), tol_y, prec)
            check(f"ingest G [{tag}]", rel_err(g, yq.T @ yq), tol, prec)
            check(f"ingest C [{tag}]", rel_err(c, yq.T @ x64), tol, prec)
            if opts.get("scalar_stats"):
                check(f"ingest sum rowsum^2 [{tag}]", rel_err(rs, np.sum(rs64**2)), tol, prec)
                check(f"ingest sum rowsumsq [{tag}]", rel_err(ssq, np.sum(ssq64)), tol, prec)
            else:
                check(f"ingest rowsum [{tag}]", rel_err(rs, rs64), tol, prec)
                check(f"ingest rowsumsq [{tag}]", rel_err(ssq, ssq64), tol, prec)


def phase_fit_step(x, g_raw: np.ndarray, seed: int, k: int = K) -> dict:
    """fit_step_fused on the bf16-resident X vs the host oracles."""
    import jax
    import jax.numpy as jnp

    from dmd_era5_tpu.pipeline.train_step import fit_ingest_pass, fit_step_fused

    rows, cols = x.shape
    omega = jax.random.normal(jax.random.key(seed + 1), (cols, SKETCH), jnp.float32)
    step = jax.jit(
        lambda x, om: fit_step_fused(x, om, n_components=k, gemm_dtype=jnp.bfloat16)
    )
    t0 = time.perf_counter()
    compiled = step.lower(x, omega).compile()
    log(f"  compile {time.perf_counter() - t0:.1f} s; memory_analysis: "
        f"{compiled.memory_analysis()}")
    out = jax.block_until_ready(compiled(x, omega))
    step_s = timed(compiled, x, omega)
    ingest = jax.jit(lambda x, om: fit_ingest_pass(x, om, gemm_dtype=jnp.bfloat16))
    ingest_s = timed(ingest, x, omega)
    # one read of X and one write of Yc (bf16), at 3.35 TB/s
    bound_s = (rows * cols * 2 + rows * SKETCH * 2) / 3.35e12
    log(f"  fit step {rows} x {cols} bf16, r={SKETCH}, k={k}: median "
        f"{step_s * 1e3:.3f} ms of 7 after 2 warm-up; ingest pass "
        f"{ingest_s * 1e3:.3f} ms (one-read bound {bound_s * 1e3:.3f} ms "
        f"at 3.35 TB/s)")

    gc = centered_gram(g_raw)
    s_exact = gram_singular_values(gc)
    s_sk, loss_sk = sketch_oracle(gc, np.asarray(omega), k)
    s = np.asarray(out.s)
    assert out.u.shape == (rows, k) and np.isfinite(s).all()
    check("fit-step loss vs same-sketch f64 oracle",
          abs(float(out.loss) - loss_sk), 1e-3, "bf16 X, f32 small algebra")
    check("fit-step s vs same-sketch f64 oracle", s_err(s, s_sk), 1e-3,
          "bf16 X, f32 small algebra")
    check("fit-step head-8 s vs exact centered SVD", s_err(s[:8], s_exact[:8]),
          1e-2, "single-pass sketch r=128 vs exact")
    return {"step_s": step_s, "ingest_s": ingest_s, "bound_s": bound_s}


def phase_svd(x, g_raw: np.ndarray, k: int = K):
    """The stage's in-memory SVD routes and the Hankel operator SVDs."""
    import jax
    import jax.numpy as jnp

    from dmd_era5_tpu.ops import truncated_svd
    from dmd_era5_tpu.ops.hankel import hankel_exact_svd, hankel_randomized_svd_fused
    from dmd_era5_tpu.parallel import AXIS_SPACE, make_mesh

    mesh = make_mesh(devices=[x.devices().pop()])
    s_exact = gram_singular_values(g_raw)
    x32 = x.astype(jnp.float32)
    factors = None
    for svd_type, tol in (("standard", 1e-3), ("randomized", 1e-2)):
        t0 = time.perf_counter()
        res = truncated_svd(
            x32, k, svd_type=svd_type, mesh=mesh, axis_name=AXIS_SPACE,
            gemm_dtype=jnp.float32,
        )
        jax.block_until_ready(res)
        log(f"  truncated_svd {svd_type}: {time.perf_counter() - t0:.1f} s (incl. compile)")
        check(f"svd {svd_type}: s vs exact f64 Gram", s_err(res.s, s_exact), tol,
              "f32 X")
        if svd_type == "standard":
            utu = jnp.matmul(res.U.T, res.U, precision=jax.lax.Precision.HIGHEST)
            check("svd standard: |U^T U - I|", rel_err(utu, np.eye(k)), 1e-3, "f32")
            factors = (np.asarray(res.U), np.asarray(res.s), np.asarray(res.V))
        del res
    del x32
    # the Hankel operators read the stored bf16 X itself (their U is
    # (2S, k): the f32 copy of X would not leave room for it)
    d = 2
    s_h = gram_singular_values(hankel_gram(g_raw, d))
    t0 = time.perf_counter()
    res = hankel_exact_svd(x, d, k)
    jax.block_until_ready(res)
    log(f"  hankel_exact_svd d={d}: {time.perf_counter() - t0:.1f} s (incl. compile)")
    assert res.U.shape == (d * x.shape[0], k)
    check("hankel exact d=2: s vs banded f64 Gram", s_err(res.s, s_h), 1e-3,
          "bf16 X, f32 products")
    del res
    t0 = time.perf_counter()
    res = hankel_randomized_svd_fused(x, d, k, gemm_dtype=jnp.bfloat16)
    jax.block_until_ready(res)
    log(f"  hankel_randomized_svd_fused d={d}: {time.perf_counter() - t0:.1f} s (incl. compile)")
    check("hankel randomized fused d=2: s vs banded f64 Gram", s_err(res.s, s_h), 1e-2,
          "bf16 GEMMs, f32 accumulation")
    del res
    return factors


def phase_dmd(factors, seed: int) -> None:
    """optDMD + rollout on the SVD factors, then the planted checks."""
    import jax.numpy as jnp

    from dmd_era5_tpu.models import fit_optdmd, optdmd_from_svd, rollout
    from dmd_era5_tpu.models.bopdmd import bopdmd_from_svd
    from dmd_era5_tpu.models.dmdc import dmdc_rollout, fit_dmdc
    from dmd_era5_tpu.models.mrdmd import fit_mrdmd, mrdmd_reconstruct

    u, s, v = factors
    t = np.arange(v.shape[1], dtype=np.float32)
    fit = optdmd_from_svd(jnp.asarray(u), jnp.asarray(s), jnp.asarray(v),
                          jnp.asarray(t), rank=16)
    resid = float(fit.residual)
    cols = np.asarray([0, 1, v.shape[1] // 2, v.shape[1] - 1])
    rec = np.asarray(rollout(fit, jnp.asarray(t[cols])), np.float64)
    # the same model lifted on the host in float64: modes * amplitudes
    # = U B^T, so x(t) = Re(U B^T e^{alpha t})
    dyn = np.asarray(fit.b_proj).T @ np.exp(np.outer(np.asarray(fit.alpha), t[cols]))
    want = (u.astype(np.float64) @ dyn).real
    log(f"  optDMD rank 16 on the {u.shape} factors: residual {resid:.4e}, "
        f"{int(fit.n_iters)} LM iterations")
    assert np.isfinite(resid) and resid < 1.0 and rec.shape == (u.shape[0], 4)
    check("optDMD rollout vs host f64 lift of the same model", rel_err(rec, want),
          1e-4, "f32 mode lift")

    rng = np.random.default_rng(seed)
    # ---- optDMD planted eigenvalue recovery
    alpha_true = np.array([-0.05 + 2.1j, -0.05 - 2.1j, -0.3 + 0.7j, -0.3 - 0.7j],
                          np.complex64)
    tt = (np.arange(64) * 0.1).astype(np.float32)
    base = rng.standard_normal((256, 2)) + 1j * rng.standard_normal((256, 2))
    modes = np.stack([base[:, 0], base[:, 0].conj(), base[:, 1], base[:, 1].conj()], 1)
    amps = np.array([1, 1, 0.5, 0.5], np.complex64)
    xd = ((modes * amps) @ np.exp(np.outer(alpha_true, tt))).real.astype(np.float32)
    f2 = fit_optdmd(jnp.asarray(xd), jnp.asarray(tt), rank=4)
    found = sorted(np.asarray(f2.alpha), key=lambda z: (round(z.imag, 1), z.real))
    true_sorted = sorted(alpha_true, key=lambda z: (round(z.imag, 1), z.real))
    check("optDMD planted eigenvalues", max(abs(a - b) for a, b in zip(found, true_sorted)),
          1e-2, "f32")
    check("optDMD planted residual", float(f2.residual), 1e-3, "f32")

    # ---- BOP-DMD bagged spectrum
    alpha_b = np.array([-0.02 + 1.3j, -0.02 - 1.3j], np.complex64)
    t_b = (np.arange(128) * 0.1).astype(np.float32)
    base_b = rng.standard_normal((512, 1)) + 1j * rng.standard_normal((512, 1))
    xb = (np.concatenate([base_b, base_b.conj()], 1) @ np.exp(np.outer(alpha_b, t_b))).real
    xb = (xb + 0.001 * rng.standard_normal(xb.shape)).astype(np.float32)
    ub, sb, vbt = np.linalg.svd(xb, full_matrices=False)
    bop = bopdmd_from_svd(jnp.asarray(ub[:, :4]), jnp.asarray(sb[:4]),
                          jnp.asarray(vbt[:4]), jnp.asarray(t_b), rank=2,
                          n_trials=8, max_iter=30)
    freq = np.sort(np.abs(np.asarray(bop.eigenvalues).imag))
    check("BOP-DMD planted frequency", float(np.abs(freq - 1.3).max()), 1e-2, "f32")
    check("BOP-DMD trial std", float(np.abs(np.asarray(bop.eigenvalues_std)).max()),
          0.05, "f32")

    # ---- mrDMD identity and residual decay on a two-scale signal
    t_m = np.arange(128, dtype=np.float64)
    q_m, _ = np.linalg.qr(rng.standard_normal((256, 4)))
    xm = (np.outer(q_m[:, 0], np.cos(0.05 * t_m)) + np.outer(q_m[:, 1], np.sin(0.05 * t_m))
          + 0.5 * np.outer(q_m[:, 2], np.cos(1.1 * t_m))
          + 0.5 * np.outer(q_m[:, 3], np.sin(1.1 * t_m))).astype(np.float32)
    mr = fit_mrdmd(jnp.asarray(xm), rank=4, max_levels=3, max_cycles=2.0)
    used = xm[:, : mr.t_used]
    ident = np.linalg.norm(mrdmd_reconstruct(mr) + mr.residual - used) / np.linalg.norm(used)
    check("mrDMD reconstruction identity", float(ident), 1e-4, "f32")
    check("mrDMD residual fraction",
          float(np.linalg.norm(mr.residual) / np.linalg.norm(xm)), 0.1, "f32")

    # ---- DMDc forced-trajectory recovery
    u_true, _ = np.linalg.qr(rng.standard_normal((512, 4)))
    a0 = np.zeros((4, 4))
    for i0, (th, gm) in enumerate(((0.3, 0.98), (1.1, 0.9))):
        c_, s_ = np.cos(th) * gm, np.sin(th) * gm
        a0[2 * i0 : 2 * i0 + 2, 2 * i0 : 2 * i0 + 2] = [[c_, -s_], [s_, c_]]
    b0 = rng.standard_normal((4, 2))
    u_seq = rng.standard_normal((2, 119)).astype(np.float32)
    xdc = np.zeros((512, 120), np.float32)
    z = rng.standard_normal(4)
    xdc[:, 0] = u_true @ z
    for kk in range(119):
        z = a0 @ z + b0 @ u_seq[:, kk]
        xdc[:, kk + 1] = u_true @ z
    resc = fit_dmdc(jnp.asarray(xdc), jnp.asarray(u_seq), rank=4)
    lam_err = np.abs(np.sort_complex(resc.eigenvalues.astype(np.complex128))
                     - np.sort_complex(np.linalg.eigvals(a0))).max()
    xr = np.asarray(dmdc_rollout(resc, xdc[:, 0], jnp.asarray(u_seq)))
    check("DMDc planted eigenvalues", float(lam_err), 5e-3, "f32")
    check("DMDc forced rollout", float(np.linalg.norm(xr - xdc) / np.linalg.norm(xdc)),
          5e-3, "f32")


STAGE_CONFIG = {
    "source_path": "mock_data",
    "start_datetime": "2019-01-01T00",
    "end_datetime": "2019-01-03T00",
    "delta_time": "1h",
    "variables": "temperature,u_component_of_wind",
    "levels": "1000,850",
    "svd_type": "standard",
    "delay_embedding": 2,
    "mean_center": True,
    "scale": False,
    "n_components": 16,
    "save_data_matrix": False,
    "dmd_rank": 10,
    "optimized": True,
    "forecast_steps": 12,
    "forecast_holdout": 6,
    "lm_max_iter": 40,
}


def stage_oracle_svd(cfg: dict) -> np.ndarray:
    """Singular values by the mock-ERA5 host oracle chain (standardize ->
    flatten -> delay-embed -> numpy float64 SVD) on the stored slice,
    trained on the columns the stage keeps (holdout removed)."""
    from dmd_era5_tpu.core import config_parser
    from dmd_era5_tpu.snapmat import (
        apply_delay_embedding,
        flatten_era5_variables,
        slice_era5_dataset,
        standardize_data,
    )
    from dmd_era5_tpu.utils.io_h5 import load_fieldset

    parsed = config_parser(cfg, "era5-svd")
    fs = load_fieldset(parsed["era5_slice_path"])
    fs = slice_era5_dataset(fs[parsed["variables"]], levels=parsed["levels"])
    n_time = len(fs.coord("time").values)
    fs = fs.isel(time=slice(0, n_time - int(cfg["forecast_holdout"])))
    fs, _, _ = standardize_data(fs, scale=bool(cfg["scale"]))
    da = apply_delay_embedding(flatten_era5_variables(fs), cfg["delay_embedding"])
    s = np.linalg.svd(np.asarray(da.data, np.float64), compute_uv=False)
    return s[: cfg["n_components"]]


def phase_stages(workdir: str, cfg: dict = STAGE_CONFIG) -> None:
    """Mock ingest -> era5_dmd (which runs era5_svd) on the card."""
    os.environ["DMD_ERA5_TPU_ROOT"] = workdir
    from dmd_era5_tpu.pipeline import era5_dmd, era5_download, era5_svd

    added, retrieved = era5_download.main(cfg, use_mock_data=True, use_store=True)
    if not (added or retrieved):
        raise RuntimeError("era5_download did not produce a versioned slice")
    res, _, _ = era5_dmd.main(cfg, write_artifact=True, use_store=True)
    eig = np.asarray(res["eigenvalues"].values)
    assert eig.shape == (cfg["dmd_rank"],) and np.isfinite(eig).all()
    rmse = np.asarray(res.attrs["forecast_rmse"])
    assert len(rmse) == cfg["forecast_holdout"] and np.isfinite(rmse).all()
    log(f"  era5_dmd: residual {float(res.attrs['dmd_residual']):.4e}, holdout RMSE "
        f"{rmse[0]:.4f} -> {rmse[-1]:.4f} (persistence "
        f"{res.attrs['persistence_rmse'][0]:.4f} -> {res.attrs['persistence_rmse'][-1]:.4f})")
    # the SVD artifact, served back by the cache ladder
    svd, _, _ = era5_svd.main(cfg, use_store=True)
    check("stages: SVD artifact s vs mock-ERA5 host oracle",
          s_err(np.asarray(svd["s"].data), stage_oracle_svd(cfg)), 1e-3, "f32")


# ------------------------------------------------------- four cards


def phase_four(x, g_raw: np.ndarray, seed: int, k: int = K) -> None:
    """The mesh paths over four cards with their comparisons."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dmd_era5_tpu.models.bopdmd import bopdmd_from_svd
    from dmd_era5_tpu.ops.hankel import hankel_exact_svd
    from dmd_era5_tpu.ops.svd import exact_truncated_svd
    from dmd_era5_tpu.parallel import make_mesh
    from dmd_era5_tpu.pipeline.train_step import fit_step_fused, make_fit_step

    devs = jax.devices()[:4]
    rows, cols = x.shape
    gc = centered_gram(g_raw)
    s_exact_c = gram_singular_values(gc)
    omega = jax.random.normal(jax.random.key(seed + 1), (cols, SKETCH), jnp.float32)
    s_sk, loss_sk = sketch_oracle(gc, np.asarray(omega), k)

    # one-card reference on the first card
    one = jax.jit(lambda x, om: fit_step_fused(x, om, n_components=k,
                                               gemm_dtype=jnp.bfloat16))(x, omega)
    mesh = make_mesh("space=4", devices=devs)
    xb = jax.device_put(x[None], NamedSharding(mesh, P("data", "space", None)))
    step = make_fit_step(mesh, n_components=k, gemm_dtype=jnp.bfloat16)
    out = jax.block_until_ready(step(xb, omega))
    step_s = timed(step, xb, omega)
    log(f"  make_fit_step space=4, {rows // 4} rows per card: median {step_s * 1e3:.3f} ms")
    s4 = np.asarray(out.s[0])
    check("four-card fit step: loss vs same-sketch f64 oracle",
          abs(float(out.loss) - loss_sk), 1e-3, "bf16 X, f32 small algebra")
    check("four-card fit step: s vs same-sketch f64 oracle", s_err(s4, s_sk), 1e-3,
          "bf16 X, f32 small algebra")
    check("four-card fit step: head-8 s vs exact centered SVD",
          s_err(s4[:8], s_exact_c[:8]), 1e-2, "single-pass sketch r=128 vs exact")
    check("four-card fit step: s vs one-card fit step", s_err(s4, one.s), 1e-3,
          "bf16 X, f32 small algebra")
    del out, one, xb

    s_exact = gram_singular_values(g_raw)
    xs = jax.device_put(x, NamedSharding(mesh, P("space", None))).astype(jnp.float32)
    t0 = time.perf_counter()
    res = jax.block_until_ready(exact_truncated_svd(xs, k, mesh=mesh))
    log(f"  TSQR exact_truncated_svd space=4: {time.perf_counter() - t0:.1f} s (incl. compile)")
    check("four-card TSQR: s vs exact f64 Gram", s_err(res.s, s_exact), 1e-3, "f32 X")
    del res
    d = 2
    t0 = time.perf_counter()
    res = jax.block_until_ready(hankel_exact_svd(xs, d, k, mesh=mesh, axis_name="space"))
    log(f"  hankel_exact_svd space=4: {time.perf_counter() - t0:.1f} s (incl. compile)")
    check("four-card Hankel exact d=2: s vs banded f64 Gram",
          s_err(res.s, gram_singular_values(hankel_gram(g_raw, d))), 1e-3, "f32 X")
    del res, xs

    rng = np.random.default_rng(seed)
    alpha_b = np.array([-0.02 + 1.3j, -0.02 - 1.3j], np.complex64)
    t_b = (np.arange(128) * 0.1).astype(np.float32)
    base_b = rng.standard_normal((512, 1)) + 1j * rng.standard_normal((512, 1))
    xe = (np.concatenate([base_b, base_b.conj()], 1) @ np.exp(np.outer(alpha_b, t_b))).real
    xe = (xe + 0.001 * rng.standard_normal(xe.shape)).astype(np.float32)
    ue, se, vte = np.linalg.svd(xe, full_matrices=False)
    args = (jnp.asarray(ue[:, :4]), jnp.asarray(se[:4]), jnp.asarray(vte[:4]),
            jnp.asarray(t_b))
    kw = dict(rank=2, n_trials=8, max_iter=30)
    bag = bopdmd_from_svd(*args, mesh=make_mesh("data=4", devices=devs), **kw)
    ref = bopdmd_from_svd(*args, **kw)
    freq = np.sort(np.abs(np.asarray(bag.eigenvalues).imag))
    check("four-card BOP-DMD data=4: planted frequency",
          float(np.abs(freq - 1.3).max()), 1e-2, "f32")
    check("four-card BOP-DMD data=4 vs one card: eigenvalues",
          float(np.abs(np.sort_complex(np.asarray(bag.eigenvalues))
                       - np.sort_complex(np.asarray(ref.eigenvalues))).max()), 1e-4, "f32")


# --------------------------------------------------------------- main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh paths")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    n_cards = 4 if args.four else 1

    with phase("device"):
        smi = nvidia_smi()
        log(f"  nvidia-smi: {smi}")
        import jax

        log(f"  jax {jax.__version__} (backend not started yet)")
    if not args.four:
        with phase("gpu tests"):
            run_gpu_tests()
    # the one process that holds the card: room for the week's factors
    os.environ.setdefault("XLA_PYTHON_CLIENT_MEM_FRACTION", "0.92")
    with phase("device/jax"):
        devs = check_devices(n_cards)
        from dmd_era5_tpu.core.paths import enable_compile_cache

        enable_compile_cache()

    with phase("synthesize week"):
        x = synth_matrix(args.seed, WEEK_ROWS, WEEK_COLS, devs[0])
        jax.block_until_ready(x)
        g_raw = host_gram(x)
        log(f"  X {x.shape} {x.dtype} on {devs[0]}; host f64 Gram of the stored bytes")

    if args.four:
        with phase("four cards"):
            phase_four(x, g_raw, args.seed)
    else:
        with phase("ingest"):
            phase_ingest(args.seed)
        with phase("fit step"):
            phase_fit_step(x, g_raw, args.seed)
        with phase("svd"):
            factors = phase_svd(x, g_raw)
        del x
        with phase("dmd"):
            phase_dmd(factors, args.seed)
        del factors
        import tempfile

        with phase("stages"), tempfile.TemporaryDirectory() as work:
            phase_stages(work)

    log(f"card: {smi}")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
