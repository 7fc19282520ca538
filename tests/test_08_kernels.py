"""The fused ingest pass, Gram/QR panels and Hankel operators:
correctness against numpy float64.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dmd_era5_tpu.ops.hankel import (
    delay_embed_time_sharded,
    hankel_project,
    hankel_sketch,
    hankel_sketch_time_sharded,
)
from dmd_era5_tpu.ops.matmul import sketch_center_gram_project
from dmd_era5_tpu.ops.qr_panel import cholqr, cholqr2, gram
from dmd_era5_tpu.parallel import make_mesh
from dmd_era5_tpu.snapmat import delay_embed_np

# ------------------------------------------------------- fused ingest pass


def _ingest_oracle(x, w, center, stats_col, t_valid, out_dtype):
    """numpy float64 form of sketch_center_gram_project."""
    x64 = np.asarray(x, np.float64)
    w64 = np.asarray(w, np.float64).copy()
    if stats_col:
        w64[:, -1] = 1.0
        if t_valid is not None:
            w64[t_valid:, -1] = 0.0
    t_true = t_valid if t_valid is not None else x.shape[1]
    rs, ssq = x64.sum(axis=1), (x64 * x64).sum(axis=1)
    y = x64 @ w64
    if center:
        y = y - np.outer(rs / t_true, w64.sum(axis=0))
    # G and C come from the STORED Yc: quantize like the pass does
    yq = np.asarray(jnp.asarray(y.astype(np.float32)).astype(out_dtype), np.float64)
    return yq, rs, ssq, yq.T @ yq, yq.T @ x64


# (rows, T, N, dtype, center, stats_col, scalar_stats, t_valid, emit_yc)
_INGEST_CASES = [
    (1024, 256, 128, "float32", True, False, False, None, True),
    (648, 24, 8, "float32", True, False, False, None, True),  # ragged rows
    (512, 512, 64, "float32", True, False, False, None, True),  # long T
    (1000, 96, 32, "float32", False, False, False, None, True),
    (1000, 96, 32, "float32", True, True, False, None, True),
    (1000, 96, 32, "float32", True, False, True, None, True),
    (1000, 96, 32, "float32", True, False, True, None, False),
    (777, 64, 16, "float32", True, False, False, 40, True),
    (777, 64, 16, "float32", True, True, True, 40, False),
    (2048, 168, 128, "bfloat16", True, False, False, None, True),
    (2048, 168, 128, "bfloat16", True, True, True, None, True),
    (1500, 168, 128, "bfloat16", False, False, False, None, True),
]


@pytest.mark.parametrize(
    "m,t,n,dtype,center,stats_col,scalar_stats,t_valid,emit_yc", _INGEST_CASES
)
def test_sketch_center_gram_project_matches_f64(
    rng, m, t, n, dtype, center, stats_col, scalar_stats, t_valid, emit_yc
):
    dt = jnp.dtype(dtype)
    x = rng.standard_normal((m, t)).astype(np.float32)
    if t_valid is not None:
        x[:, t_valid:] = 0.0  # zero time padding
    w = rng.standard_normal((t, n)).astype(np.float32)
    xq = np.asarray(jnp.asarray(x).astype(dt), np.float32)  # stored values
    wq = np.asarray(jnp.asarray(w).astype(dt), np.float32)
    yc, rs, ssq, g, c = sketch_center_gram_project(
        jnp.asarray(xq).astype(dt), jnp.asarray(wq).astype(dt),
        out_dtype=dt, center=center, stats_col=stats_col,
        scalar_stats=scalar_stats, t_valid=t_valid, emit_yc=emit_yc,
    )
    y_o, rs_o, ssq_o, g_o, c_o = _ingest_oracle(
        xq, wq, center, stats_col, t_valid, dt
    )
    # f32 products at HIGHEST are ~1e-6 relative; bf16 inputs with f32
    # accumulation add a bf16 rounding of the stored Yc (~4e-3)
    tol = 1e-5 if dtype == "float32" else 2e-2

    def close(got, want):
        got = np.asarray(got, np.float64)
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got - want).max() <= tol * scale, (
            np.abs(got - want).max() / scale
        )

    if emit_yc:
        assert yc.shape == (m, n) and yc.dtype == dt
        close(yc, y_o)
    else:
        assert yc is None
    if scalar_stats:
        close(rs, np.sum(rs_o**2))
        close(ssq, np.sum(ssq_o))
    else:
        assert rs.shape == (m,) and ssq.shape == (m,)
        close(rs, rs_o)
        close(ssq, ssq_o)
    assert g.shape == (n, n) and c.shape == (n, t)
    close(g, g_o)
    close(c, c_o)


@pytest.mark.parametrize("m", [768, 1009, 100])  # divisor / padded / one GEMM
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_row_contract_blocked_matches_f64(rng, monkeypatch, m, dtype):
    """Row contractions summed over row-block partials (a divisor block
    where one exists, else zero padding) equal the one-shot product."""
    from dmd_era5_tpu.ops import matmul

    monkeypatch.setattr(matmul, "_ROW_BLOCK", 64)
    assert matmul._row_block(768) == 64 and matmul._row_block(1009) == 64
    assert matmul._row_block(1000) == 50
    assert matmul._row_block(100) == 100
    a = jnp.asarray(rng.standard_normal((m, 24)), dtype)
    b = jnp.asarray(rng.standard_normal((m, 9)), dtype)
    want = np.asarray(a, np.float64).T @ np.asarray(b, np.float64)
    got = np.asarray(matmul.row_contract(a, b), np.float64)
    assert got.dtype == np.float64 and got.shape == (24, 9)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


# --------------------------------------------------------------- qr panel


def test_gram_kernel(rng):
    a = rng.standard_normal((2048, 64)).astype(np.float32)
    g = np.asarray(gram(jnp.asarray(a)))
    np.testing.assert_allclose(g, a.T @ a, rtol=1e-4, atol=1e-2)


def test_cholqr_reconstructs(rng):
    a = rng.standard_normal((1024, 32)).astype(np.float32)
    q, r = cholqr(jnp.asarray(a))
    np.testing.assert_allclose(np.asarray(q) @ np.asarray(r), a, atol=1e-3)


def test_cholqr2_orthonormal(rng):
    # moderately ill-conditioned panel
    a = rng.standard_normal((2048, 48)).astype(np.float32)
    a[:, :8] *= 1e3
    q, r = cholqr2(jnp.asarray(a))
    qtq = np.asarray(q).T @ np.asarray(q)
    np.testing.assert_allclose(qtq, np.eye(48), atol=5e-4)
    np.testing.assert_allclose(np.asarray(q) @ np.asarray(r), a, rtol=2e-3, atol=2e-2)
    # R upper triangular
    np.testing.assert_allclose(
        np.tril(np.asarray(r), -1), 0.0, atol=1e-2
    )


# ----------------------------------------------------------------- hankel


@pytest.mark.parametrize("d", [1, 2, 4])
def test_hankel_sketch_matches_materialized(rng, d):
    s, t, r = 64, 40, 8
    x = rng.standard_normal((s, t)).astype(np.float32)
    omega = rng.standard_normal((t - d + 1, r)).astype(np.float32)
    h = delay_embed_np(x, d)
    expected = h @ omega
    out = np.asarray(hankel_sketch(jnp.asarray(x), jnp.asarray(omega), d))
    np.testing.assert_allclose(out, expected, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("d", [2, 3])
def test_hankel_project_matches_materialized(rng, d):
    s, t, r = 48, 32, 6
    x = rng.standard_normal((s, t)).astype(np.float32)
    q = rng.standard_normal((s * d, r)).astype(np.float32)
    h = delay_embed_np(x, d)
    expected = q.T @ h
    out = np.asarray(hankel_project(jnp.asarray(q), jnp.asarray(x), d))
    np.testing.assert_allclose(out, expected, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("d", [2, 3])
def test_hankel_sketch_time_sharded(rng, d):
    mesh = make_mesh("time=8")
    s, t, r = 32, 48, 4  # t divisible by 8
    x = rng.standard_normal((s, t)).astype(np.float32)
    omega = rng.standard_normal((t - d + 1, r)).astype(np.float32)
    expected = delay_embed_np(x, d) @ omega
    out = np.asarray(
        hankel_sketch_time_sharded(
            jnp.asarray(x), jnp.asarray(omega), d, mesh
        )
    )
    np.testing.assert_allclose(out, expected, rtol=1e-4, atol=1e-3)


def test_delay_embed_time_sharded(rng):
    mesh = make_mesh("time=4")
    s, t, d = 8, 32, 3
    x = rng.standard_normal((s, t)).astype(np.float32)
    out = np.asarray(delay_embed_time_sharded(jnp.asarray(x), d, mesh))
    assert out.shape == (s * d, t)
    # columns from d-1 on match the host embedding
    expected = delay_embed_np(x, d)
    np.testing.assert_allclose(out[:, d - 1 :], expected, atol=1e-6)


@pytest.mark.parametrize("d", [2, 3])
def test_hankel_randomized_svd_matches_materialized(rng, d):
    """Operator-form randomized SVD == randomized SVD of the embedded
    matrix, exactly (same seed -> same sketch -> same iterates)."""
    import jax.numpy as jnp

    from dmd_era5_tpu.ops.hankel import hankel_randomized_svd
    from dmd_era5_tpu.ops.svd import randomized_svd

    s, t, k = 96, 64, 8
    x = rng.standard_normal((s, t)).astype(np.float32)
    h = delay_embed_np(x, d)
    res_op = hankel_randomized_svd(jnp.asarray(x), d, k, seed=5)
    res_mat = randomized_svd(jnp.asarray(h), k, seed=5)
    np.testing.assert_allclose(
        np.asarray(res_op.s), np.asarray(res_mat.s), rtol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(res_op.U), np.asarray(res_mat.U), atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(res_op.V), np.asarray(res_mat.V), atol=1e-3
    )


def test_hankel_randomized_svd_sharded_matches_single(rng):
    """Space-sharded operator SVD == single-device operator SVD (same
    seed), after undoing the per-shard interleaved row layout."""
    import jax.numpy as jnp

    from dmd_era5_tpu.ops.hankel import (
        hankel_randomized_svd,
        hankel_randomized_svd_sharded,
    )
    from dmd_era5_tpu.parallel import shard_rows

    mesh = make_mesh()
    d, s, t, k = 3, 512, 48, 6
    x = rng.standard_normal((s, t)).astype(np.float32)
    xs, _ = shard_rows(x, mesh)
    # classic body pinned: this test checks TSQR-path parity; the
    # fused body has its own test below
    res_sh = hankel_randomized_svd_sharded(xs, d, k, mesh, seed=7, fused=False)
    res_1 = hankel_randomized_svd(jnp.asarray(x), d, k, seed=7)
    np.testing.assert_allclose(
        np.asarray(res_sh.s), np.asarray(res_1.s), rtol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(res_sh.U), np.asarray(res_1.U), atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(res_sh.V), np.asarray(res_1.V), atol=2e-3
    )


@pytest.mark.parametrize("d", [2, 3])
def test_hankel_randomized_svd_2d_matches_single(rng, d):
    """Grid-sharded (space x time) operator SVD == single-device operator
    SVD (same seed -> same sketch), after undoing the per-space-shard
    interleaved row layout."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dmd_era5_tpu.ops.hankel import (
        hankel_randomized_svd,
        hankel_randomized_svd_2d,
    )

    mesh = make_mesh("space=2,time=4")
    s, t, k = 64, 48, 6
    x = rng.standard_normal((s, t)).astype(np.float32)
    xs = jax.device_put(x, NamedSharding(mesh, P("space", "time")))
    res2 = hankel_randomized_svd_2d(xs, d, k, mesh, seed=7)
    res1 = hankel_randomized_svd(jnp.asarray(x), d, k, seed=7)
    np.testing.assert_allclose(
        np.asarray(res2.s), np.asarray(res1.s), rtol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(res2.U), np.asarray(res1.U), atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(res2.V), np.asarray(res1.V), atol=2e-3
    )


def test_hankel_randomized_svd_2d_column_padding(rng):
    """Zero-padded time columns (mesh divisibility) must not perturb the
    factors: padded windows are excluded via t_valid."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dmd_era5_tpu.ops.hankel import (
        hankel_randomized_svd,
        hankel_randomized_svd_2d,
    )

    mesh = make_mesh("space=2,time=4")
    s, t, d, k = 64, 45, 3, 6  # t=45 pads to 48 on the 4-way time axis
    x = rng.standard_normal((s, t)).astype(np.float32)
    x_pad = np.pad(x, ((0, 0), (0, 3)))
    xs = jax.device_put(x_pad, NamedSharding(mesh, P("space", "time")))
    res2 = hankel_randomized_svd_2d(xs, d, k, mesh, t_valid=t, seed=3)
    res1 = hankel_randomized_svd(jnp.asarray(x), d, k, seed=3)
    assert res2.V.shape == (k, t - d + 1)
    np.testing.assert_allclose(
        np.asarray(res2.s), np.asarray(res1.s), rtol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(res2.U), np.asarray(res1.U), atol=2e-3
    )
    np.testing.assert_allclose(
        np.asarray(res2.V), np.asarray(res1.V), atol=2e-3
    )


def test_householder_leaf_matches_lapack(rng):
    """The TSQR "householder" leaf (XLA QR: cuSOLVER geqrf on the GPU)."""
    from dmd_era5_tpu.ops.tsqr import _local_factor

    a = rng.standard_normal((512, 32)).astype(np.float32)
    q, r = _local_factor(jnp.asarray(a), "householder")
    q_ref, r_ref = np.linalg.qr(a.astype(np.float64))
    signs = np.sign(np.diag(r_ref))
    q_ref, r_ref = q_ref * signs, r_ref * signs[:, None]
    np.testing.assert_allclose(np.asarray(r), r_ref, atol=2e-3)
    np.testing.assert_allclose(np.asarray(q), q_ref, atol=2e-3)
    qtq = np.asarray(q).T @ np.asarray(q)
    np.testing.assert_allclose(qtq, np.eye(32), atol=1e-4)
    assert np.all(np.diag(np.asarray(r)) >= 0)


def test_householder_leaf_ill_conditioned(rng):
    """Householder stays stable where single-pass CholQR would not."""
    from dmd_era5_tpu.ops.tsqr import _local_factor

    a = rng.standard_normal((256, 16)).astype(np.float32)
    a[:, 0] *= 1e5
    a[:, 1] = a[:, 0] + 1e-2 * rng.standard_normal(256).astype(np.float32)
    q, r = _local_factor(jnp.asarray(a), "householder")
    qtq = np.asarray(q).T @ np.asarray(q)
    np.testing.assert_allclose(qtq, np.eye(16), atol=1e-3)
    np.testing.assert_allclose(
        np.asarray(q) @ np.asarray(r), a, rtol=1e-3, atol=1.0
    )


def test_local_factor_rejects_unknown_method(rng):
    from dmd_era5_tpu.ops.tsqr import _local_factor, default_qr_method

    assert default_qr_method() in ("householder", "cholqr2", "cholqr2_split")
    with pytest.raises(ValueError, match="qr_method"):
        _local_factor(jnp.ones((8, 2)), "xla")


@pytest.mark.parametrize("d", [1, 3])
def test_hankel_randomized_svd_fused_matches_oracle(rng, d):
    """Fused one-pass-per-iteration Hankel SVD vs the exact SVD of the
    materialized embedding (f32 mode; its own Gaussian sketch, so the
    comparison is to the truth, not to a shared iterate)."""
    import jax.numpy as jnp

    from dmd_era5_tpu.ops.hankel import hankel_randomized_svd_fused

    s, t, k = 96, 64, 6
    # decaying spectrum so the randomized range finder is accurate
    x = (
        rng.standard_normal((s, 10))
        * (np.arange(10, 0, -1) ** 2)
        @ rng.standard_normal((10, t))
    ).astype(np.float32)
    x += 0.01 * rng.standard_normal((s, t)).astype(np.float32)
    h = delay_embed_np(x, d)
    u_ref, s_ref, vt_ref = np.linalg.svd(h, full_matrices=False)
    res = hankel_randomized_svd_fused(
        jnp.asarray(x), d, k, gemm_dtype=jnp.float32, seed=7
    )
    np.testing.assert_allclose(np.asarray(res.s), s_ref[:k], rtol=2e-3)
    # subspace agreement (signs/rotations resolved by projector check)
    u = np.asarray(res.U)
    proj = u_ref[:, :k] @ (u_ref[:, :k].T @ u)
    np.testing.assert_allclose(proj, u, atol=2e-3)
    # orthonormal basis out of the implicit whitening
    np.testing.assert_allclose(u.T @ u, np.eye(k), atol=2e-3)
    # U S V matches the oracle's own rank-k truncation (the full H has
    # rank-10 signal past k that NO rank-k factorization reconstructs)
    recon = u @ (np.asarray(res.s)[:, None] * np.asarray(res.V))
    recon_ref = u_ref[:, :k] @ (s_ref[:k, None] * vt_ref[:k])
    rel = np.linalg.norm(recon - recon_ref) / np.linalg.norm(recon_ref)
    assert rel < 5e-3


def test_hankel_randomized_svd_fused_bf16(rng):
    """bf16 fused path: singular values within quantization order."""
    import jax.numpy as jnp

    from dmd_era5_tpu.ops.hankel import hankel_randomized_svd_fused

    s, t, k, d = 128, 64, 4, 2
    x = (
        rng.standard_normal((s, 8))
        * (np.arange(8, 0, -1) ** 2)
        @ rng.standard_normal((8, t))
    ).astype(np.float32)
    h = delay_embed_np(x, d)
    s_ref = np.linalg.svd(h, compute_uv=False)[:k]
    res = hankel_randomized_svd_fused(
        jnp.asarray(x), d, k, gemm_dtype=jnp.bfloat16, seed=3
    )
    np.testing.assert_allclose(np.asarray(res.s), s_ref, rtol=2e-2)
    u = np.asarray(res.U)
    np.testing.assert_allclose(u.T @ u, np.eye(k), atol=2e-2)


def test_hankel_randomized_svd_sharded_fused_matches_single_fused(rng):
    """Fused space-sharded body == single-device fused path (same seed,
    same algorithm — only the Gram/projection psums differ), after
    undoing the per-shard interleaved row layout."""
    import jax.numpy as jnp

    from dmd_era5_tpu.ops.hankel import (
        hankel_randomized_svd_fused,
        hankel_randomized_svd_sharded,
    )
    from dmd_era5_tpu.parallel import shard_rows

    mesh = make_mesh()
    d, s, t, k = 3, 512, 48, 6
    x = (
        rng.standard_normal((s, 8)) * (np.arange(8, 0, -1) ** 2)
        @ rng.standard_normal((8, t))
    ).astype(np.float32)
    x += 0.05 * rng.standard_normal((s, t)).astype(np.float32)
    xs, _ = shard_rows(x, mesh)
    res_sh = hankel_randomized_svd_sharded(
        xs, d, k, mesh, seed=7, n_oversamples=28, fused=True
    )
    res_1 = hankel_randomized_svd_fused(
        jnp.asarray(x), d, k, gemm_dtype=jnp.float32, seed=7
    )
    np.testing.assert_allclose(
        np.asarray(res_sh.s), np.asarray(res_1.s), rtol=1e-4
    )
    # caller already de-interleaves U to global delay-major layout
    np.testing.assert_allclose(
        np.asarray(res_sh.U), np.asarray(res_1.U), atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(res_sh.V), np.asarray(res_1.V), atol=1e-3
    )


@pytest.mark.parametrize("d", [1, 2, 4])
def test_hankel_exact_svd_matches_materialized(rng, d):
    """Exact Hankel-operator SVD (banded raw-Gram identity) == exact
    SVD of the materialized embedding, to f32 accuracy — deterministic,
    so the tolerance is tight."""
    import jax.numpy as jnp

    from dmd_era5_tpu.ops.hankel import hankel_exact_svd

    s, t, k = 300, 64, 8
    # decaying spectrum (the standardized-ERA5 regime)
    a = rng.standard_normal((s, 16))
    b = rng.standard_normal((16, t))
    x = (
        (a * np.logspace(0, -2, 16)) @ b
        + 1e-4 * rng.standard_normal((s, t))
    ).astype(np.float32)
    h = delay_embed_np(x, d)
    u0, s0, vt0 = np.linalg.svd(h.astype(np.float64), full_matrices=False)
    res = hankel_exact_svd(jnp.asarray(x), d, k)
    np.testing.assert_allclose(np.asarray(res.s), s0[:k], rtol=1e-5)
    qa, _ = np.linalg.qr(np.asarray(res.U, np.float64))
    qb, _ = np.linalg.qr(u0[:, :k])
    assert np.linalg.svd(qa.T @ qb, compute_uv=False).min() > 1 - 1e-8
    u = np.asarray(res.U)
    np.testing.assert_allclose(u.T @ u, np.eye(k), atol=1e-5)


def test_hankel_exact_svd_sharded_matches_single(rng):
    """Space-sharded exact Hankel SVD == single-device, after undoing
    the interleaved row layout (handled inside the wrapper)."""
    import jax.numpy as jnp

    from dmd_era5_tpu.ops.hankel import hankel_exact_svd
    from dmd_era5_tpu.parallel import shard_rows

    mesh = make_mesh()
    d, s, t, k = 3, 512, 48, 6
    x = rng.standard_normal((s, t)).astype(np.float32)
    xs, _ = shard_rows(x, mesh)
    res_sh = hankel_exact_svd(xs, d, k, mesh=mesh, axis_name="space")
    res_1 = hankel_exact_svd(jnp.asarray(x), d, k)
    np.testing.assert_allclose(
        np.asarray(res_sh.s), np.asarray(res_1.s), rtol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(res_sh.U), np.asarray(res_1.U), atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(res_sh.V), np.asarray(res_1.V), atol=2e-4
    )


def test_cholqr2_split_accuracy():
    """The split-Gram CholQR2 leaf: orthogonality and factorization
    residual at ~1e-6, R upper-triangular with positive diagonal."""
    import numpy as np

    from dmd_era5_tpu.ops.qr_panel import cholqr2_split

    rng = np.random.default_rng(0)
    # moderately conditioned panel (cond ~1e3)
    u, _ = np.linalg.qr(rng.standard_normal((2048, 96)))
    v, _ = np.linalg.qr(rng.standard_normal((96, 96)))
    sig = np.logspace(0, -3, 96)
    a = (u * sig) @ v.T
    a = jnp.asarray(a.astype(np.float32))

    q, r = cholqr2_split(a)
    q, r = np.asarray(q), np.asarray(r)
    assert np.abs(q.T @ q - np.eye(96)).max() < 5e-6
    assert np.linalg.norm(a - q @ r) / np.linalg.norm(np.asarray(a)) < 5e-6
    assert np.all(np.diag(r) > 0)
    # head singular values through R match the panel's
    s_ref = np.linalg.svd(np.asarray(a), compute_uv=False)
    s_got = np.linalg.svd(r, compute_uv=False)
    np.testing.assert_allclose(s_got[:8], s_ref[:8], rtol=1e-5)
