"""Streaming sketch (PP ingest) + incremental SVD updates."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from dmd_era5_tpu.ops import exact_truncated_svd
from dmd_era5_tpu.ops.streaming import StreamingSketch, svd_rank_update


def test_streaming_sketch_matches_one_shot(rng):
    s, t, r = 256, 96, 16
    x = rng.standard_normal((s, t)).astype(np.float32)
    omega = rng.standard_normal((t, r)).astype(np.float32)
    sketch = StreamingSketch(s, jnp.asarray(omega))
    for c0 in range(0, t, 16):
        sketch.update(x[:, c0 : c0 + 16])
    assert sketch.columns_seen == t
    np.testing.assert_allclose(
        np.asarray(sketch.result()), x @ omega, rtol=1e-4, atol=1e-3
    )


def test_streaming_sketch_uneven_blocks(rng):
    s, t, r = 64, 50, 8
    x = rng.standard_normal((s, t)).astype(np.float32)
    omega = rng.standard_normal((t, r)).astype(np.float32)
    sketch = StreamingSketch(s, jnp.asarray(omega))
    bounds = [0, 7, 19, 33, 50]
    sketch.run(x[:, a:b] for a, b in zip(bounds, bounds[1:]))
    np.testing.assert_allclose(
        np.asarray(sketch.result()), x @ omega, rtol=1e-4, atol=1e-3
    )


def test_streaming_sketch_empty_raises():
    sketch = StreamingSketch(8, jnp.zeros((4, 2)))
    with pytest.raises(ValueError, match="No blocks"):
        sketch.result()


def test_svd_rank_update_appends_columns(rng):
    s, t0, c, k = 384, 48, 16, 12
    # low-rank base + new columns from the same subspace family
    basis = rng.standard_normal((s, k))
    x0 = (basis @ rng.standard_normal((k, t0))).astype(np.float32)
    xc = (basis @ rng.standard_normal((k, c))).astype(np.float32)

    svd0 = exact_truncated_svd(jnp.asarray(x0), k)
    updated = svd_rank_update(svd0, jnp.asarray(xc))

    full = np.concatenate([x0, xc], axis=1)
    s_host = np.linalg.svd(full, compute_uv=False)[:k]
    np.testing.assert_allclose(np.asarray(updated.s), s_host, rtol=1e-3)
    assert updated.V.shape == (k, t0 + c)
    # factorization reconstructs the full matrix (rank-k exact here)
    recon = (
        np.asarray(updated.U)
        @ np.diag(np.asarray(updated.s))
        @ np.asarray(updated.V)
    )
    np.testing.assert_allclose(recon, full, atol=2e-2)


def test_svd_rank_update_truncates_noise(rng):
    s, t0, c, k = 256, 40, 8, 6
    basis = rng.standard_normal((s, k))
    x0 = (basis @ rng.standard_normal((k, t0))).astype(np.float32)
    xc = (
        basis @ rng.standard_normal((k, c))
        + 1e-3 * rng.standard_normal((s, c))
    ).astype(np.float32)
    svd0 = exact_truncated_svd(jnp.asarray(x0), k)
    updated = svd_rank_update(svd0, jnp.asarray(xc), n_components=k)
    assert updated.s.shape == (k,)
    # U stays orthonormal after the update
    u = np.asarray(updated.U)
    np.testing.assert_allclose(u.T @ u, np.eye(k), atol=1e-3)


def test_streaming_pipeline_to_incremental_svd(rng):
    """Config-5 composition: stream a day, factor, then append a day."""
    s, t_day, k = 512, 24, 8
    day1 = (
        rng.standard_normal((s, k)) @ rng.standard_normal((k, t_day))
    ).astype(np.float32)
    day2 = (
        day1[:, :k] @ rng.standard_normal((k, t_day))
    ).astype(np.float32)
    svd1 = exact_truncated_svd(jnp.asarray(day1), k)
    svd2 = svd_rank_update(svd1, jnp.asarray(day2))
    full = np.concatenate([day1, day2], axis=1)
    s_host = np.linalg.svd(full, compute_uv=False)[:k]
    np.testing.assert_allclose(np.asarray(svd2.s), s_host, rtol=2e-3)


def test_streamed_randomized_svd_out_of_core(tmp_path, rng):
    """Packed-file streaming SVD == in-memory randomized SVD (same seed)."""
    from dmd_era5_tpu.ops.svd import randomized_svd
    from dmd_era5_tpu.pipeline.streamed_fit import streamed_randomized_svd
    from dmd_era5_tpu.snapmat import create_mock_era5
    from dmd_era5_tpu.snapmat.loader import build_snapshot_matrix, save_packed_snapshot

    s, t, k = 1000, 64, 6
    x = (
        rng.standard_normal((s, 10)) @ rng.standard_normal((10, t))
        + 1e-3 * rng.standard_normal((s, t))
    ).astype(np.float32)
    fs = create_mock_era5("2020-01-01", "2020-01-02", ["temperature"], [1000], seed=0)
    _, meta = build_snapshot_matrix(fs)
    path = tmp_path / "packed.h5"
    save_packed_snapshot(path, x, meta)

    res = streamed_randomized_svd(path, k, block_rows=128, seed=4)
    ref = randomized_svd(jnp.asarray(x), k, seed=4)
    np.testing.assert_allclose(
        np.asarray(res.s), np.asarray(ref.s), rtol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(res.U), np.asarray(ref.U), atol=2e-3
    )


@pytest.mark.parametrize("n_iter", [0, 1, 3])
def test_streamed_power_iteration_pass_count(tmp_path, rng, n_iter, monkeypatch):
    """The fused schedule's contract: n_iter + 2 disk passes, counted by
    instrumenting prefetched_row_blocks (the only disk entry point)."""
    from dmd_era5_tpu.pipeline import streamed_fit
    from dmd_era5_tpu.snapmat import create_mock_era5
    from dmd_era5_tpu.snapmat.loader import build_snapshot_matrix, save_packed_snapshot

    x = rng.standard_normal((512, 32)).astype(np.float32)
    fs = create_mock_era5("2020-01-01", "2020-01-02", ["temperature"], [1000], seed=0)
    _, meta = build_snapshot_matrix(fs)
    path = tmp_path / "pc.h5"
    save_packed_snapshot(path, x, meta)

    passes = []
    orig = streamed_fit.prefetched_row_blocks

    def counting(p, n_rows, block_rows, depth=2):
        passes.append(1)
        return orig(p, n_rows, block_rows, depth)

    monkeypatch.setattr(streamed_fit, "prefetched_row_blocks", counting)
    streamed_fit.streamed_randomized_svd(
        path, 4, block_rows=128, seed=1, n_iter=n_iter
    )
    assert len(passes) == n_iter + 2, (
        f"expected {n_iter + 2} disk passes, counted {len(passes)}"
    )


def test_streamed_bf16_blocks(tmp_path, rng):
    """bf16-packed artifacts stream as bf16 blocks (no host upcast) and
    still agree with the f32 in-memory factorization."""
    from dmd_era5_tpu.ops.svd import randomized_svd
    from dmd_era5_tpu.pipeline.streamed_fit import streamed_randomized_svd
    from dmd_era5_tpu.snapmat.loader import save_packed_matrix

    s, t, k = 1024, 48, 5
    x = (
        rng.standard_normal((s, 8)) @ rng.standard_normal((8, t))
        + 1e-3 * rng.standard_normal((s, t))
    ).astype(np.float32)
    path = tmp_path / "bf16.h5"
    save_packed_matrix(path, x, d=1, bf16=True)
    res = streamed_randomized_svd(path, k, block_rows=256, seed=2)
    ref = randomized_svd(jnp.asarray(x), k, seed=2)
    np.testing.assert_allclose(
        np.asarray(res.s), np.asarray(ref.s), rtol=2e-2
    )
    # bf16 quantization bounds factor agreement; subspace must survive
    ua, ub = np.asarray(res.U), np.asarray(ref.U)
    sv = np.linalg.svd(ua.T @ ub, compute_uv=False)
    assert sv.min() > 0.99


def test_streamed_u_wire_dtype_and_u_out(tmp_path, rng):
    """The U stream-back options (review r4 item 9): bf16 wire on
    bf16-packed files by default, forced f32 wire on request, and
    blockwise writes into a caller-supplied ``u_out`` buffer (memmap /
    h5py dataset) with no (S, k) host allocation inside."""
    import h5py

    from dmd_era5_tpu.pipeline.streamed_fit import streamed_randomized_svd
    from dmd_era5_tpu.snapmat.loader import save_packed_matrix

    s, t, k = 1024, 48, 5
    x = (
        rng.standard_normal((s, 8)) @ rng.standard_normal((8, t))
        + 1e-3 * rng.standard_normal((s, t))
    ).astype(np.float32)
    path = tmp_path / "bf16.h5"
    save_packed_matrix(path, x, d=1, bf16=True)

    res_auto = streamed_randomized_svd(path, k, block_rows=256, seed=2)
    res_f32 = streamed_randomized_svd(
        path, k, block_rows=256, seed=2, u_dtype="float32"
    )
    u_auto, u_f32 = np.asarray(res_auto.U), np.asarray(res_f32.U)
    assert u_auto.dtype == np.float32 and u_f32.dtype == np.float32
    # the bf16 wire only quantizes the values of the SAME U: columns are
    # unit vectors, so the elementwise delta is bounded by bf16 eps
    assert np.max(np.abs(u_auto - u_f32)) < 1e-2
    sv = np.linalg.svd(u_auto.T @ u_f32, compute_uv=False)
    assert sv.min() > 0.995  # bf16 eps ~4e-3 bounds the column cosines

    # u_out: stream straight into an h5py dataset
    with h5py.File(tmp_path / "u.h5", "w") as f:
        dset = f.create_dataset("U", shape=(s, k), dtype=np.float32)
        res_out = streamed_randomized_svd(
            path, k, block_rows=256, seed=2, u_out=dset
        )
        assert res_out.U is dset
        np.testing.assert_allclose(dset[:], u_auto, atol=1e-6)

    with pytest.raises(ValueError, match="u_dtype"):
        streamed_randomized_svd(path, k, block_rows=256, u_dtype="int8")


def test_streamed_col_limit_matches_sliced_matrix(tmp_path, rng):
    """col_limit decomposes exactly X[:, :limit] (the holdout-train
    split of the out-of-core DMD leg)."""
    from dmd_era5_tpu.ops.svd import randomized_svd
    from dmd_era5_tpu.pipeline.streamed_fit import streamed_randomized_svd
    from dmd_era5_tpu.snapmat.loader import save_packed_matrix

    s, t, k, lim = 800, 60, 5, 44
    x = (
        rng.standard_normal((s, 8)) @ rng.standard_normal((8, t))
        + 1e-3 * rng.standard_normal((s, t))
    ).astype(np.float32)
    path = tmp_path / "cl.h5"
    save_packed_matrix(path, x, d=1)
    res = streamed_randomized_svd(path, k, block_rows=128, seed=3, col_limit=lim)
    ref = randomized_svd(jnp.asarray(x[:, :lim]), k, seed=3)
    assert res.V.shape == (k, lim)
    np.testing.assert_allclose(np.asarray(res.s), np.asarray(ref.s), rtol=1e-3)
    np.testing.assert_allclose(np.asarray(res.U), np.asarray(ref.U), atol=2e-3)
    with pytest.raises(ValueError, match="col_limit"):
        streamed_randomized_svd(path, k, col_limit=0)


def test_streamed_exact_gram_svd_matches_numpy(tmp_path, rng):
    """The 2-pass out-of-core exact route == numpy truncated SVD (f64
    Gram accumulation makes it deterministic and oracle-grade; two
    passes where the randomized schedule needs n_iter + 2)."""
    from dmd_era5_tpu.pipeline.streamed_fit import streamed_exact_gram_svd
    from dmd_era5_tpu.snapmat.loader import save_packed_matrix

    s, t, k = 900, 56, 7
    # data rank 6 < k: the truncation captures everything, so the
    # factorization must reconstruct X to the noise floor
    x = (
        rng.standard_normal((s, 6)) @ rng.standard_normal((6, t))
        + 1e-4 * rng.standard_normal((s, t))
    ).astype(np.float32)
    path = tmp_path / "g.h5"
    save_packed_matrix(path, x, d=1)

    res = streamed_exact_gram_svd(path, k, block_rows=128)
    u_np, s_np, vt_np = np.linalg.svd(x, full_matrices=False)
    # resolved components (above the Gram noise floor ~eps_f32 * s0)
    # are oracle-exact; the noise-floor tail sits AT the floor
    np.testing.assert_allclose(np.asarray(res.s)[:6], s_np[:6], rtol=1e-5)
    # tail stays at/below the route's floor sqrt(eps_f32) * s0 (the
    # per-block f32 GEMM bounds G's accuracy; f64 only accumulates)
    assert float(res.s[6]) < 3e-4 * float(res.s[0])  # floor, not junk
    u, v = np.asarray(res.U), np.asarray(res.V)
    np.testing.assert_allclose(
        np.abs(u[:, :6]), np.abs(u_np[:, :6]), atol=1e-4
    )
    np.testing.assert_allclose(
        np.abs(v[:6]), np.abs(vt_np[:6]), atol=1e-4
    )
    # factorization reconstructs
    np.testing.assert_allclose((u * res.s[None, :]) @ v, x, atol=2e-2)

    # sklearn-parity signs: max-|.| entry of each right vector positive
    mx = np.argmax(np.abs(v), axis=1)
    assert (v[np.arange(k), mx] > 0).all()

    # bf16 file + u_out + col_limit combinations
    path2 = tmp_path / "g16.h5"
    save_packed_matrix(path2, x, d=1, bf16=True)
    lim = 40
    u_buf = np.zeros((s, k), np.float32)
    res2 = streamed_exact_gram_svd(
        path2, k, block_rows=256, col_limit=lim, u_out=u_buf
    )
    assert res2.U is u_buf and res2.V.shape == (k, lim)
    s_ref = np.linalg.svd(
        x[:, :lim].astype(jnp.bfloat16).astype(np.float32),
        compute_uv=False,
    )[:k]
    # head only: component 7 is the bf16-quantization noise floor
    np.testing.assert_allclose(np.asarray(res2.s)[:6], s_ref[:6], rtol=2e-2)


def test_streamed_exact_gram_wide_time_axis(tmp_path, rng):
    """T past the host-accumulation cutoff (T^2 * 4 > 8 MB): the Gram
    accumulates on DEVICE in f32 with one final fetch — the long-time-
    axis regime (a T=8760 hourly year's 307 MB partial Gram cannot be
    fetched per block through a slow d2h path)."""
    from dmd_era5_tpu.pipeline.streamed_fit import streamed_exact_gram_svd
    from dmd_era5_tpu.snapmat.loader import save_packed_matrix

    s, t, k = 384, 1500, 5  # t^2 * 4 = 9 MB > 8 MB cutoff
    x = (
        rng.standard_normal((s, 4)) @ rng.standard_normal((4, t))
        + 1e-4 * rng.standard_normal((s, t))
    ).astype(np.float32)
    path = tmp_path / "wide.h5"
    save_packed_matrix(path, x, d=1)
    res = streamed_exact_gram_svd(path, k, block_rows=96)
    s_np = np.linalg.svd(x, compute_uv=False)
    np.testing.assert_allclose(np.asarray(res.s)[:4], s_np[:4], rtol=1e-4)
    assert res.V.shape == (k, t)


def test_prefetched_row_blocks_order(tmp_path, rng):
    from dmd_era5_tpu.pipeline.streamed_fit import prefetched_row_blocks
    from dmd_era5_tpu.snapmat import create_mock_era5
    from dmd_era5_tpu.snapmat.loader import build_snapshot_matrix, save_packed_snapshot

    x = rng.standard_normal((100, 8)).astype(np.float32)
    fs = create_mock_era5("2020-01-01", "2020-01-01T05", ["temperature"], [1000], seed=0)
    _, meta = build_snapshot_matrix(fs)
    path = tmp_path / "p.h5"
    save_packed_snapshot(path, x, meta)
    blocks = list(prefetched_row_blocks(path, 100, 32))
    starts = [b[0] for b in blocks]
    assert starts == [0, 32, 64, 96]
    np.testing.assert_array_equal(
        np.concatenate([b[1] for b in blocks]), x
    )
