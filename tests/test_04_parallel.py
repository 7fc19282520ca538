"""Mesh construction, sharding helpers, and collective building blocks."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from dmd_era5_tpu.parallel import (
    AXIS_SPACE,
    AXIS_TIME,
    make_mesh,
    parse_mesh_shape,
    shard_rows,
)
from dmd_era5_tpu.parallel.collectives import halo_exchange_left, ring_permute


def test_parse_mesh_shape():
    assert parse_mesh_shape(None) is None
    assert parse_mesh_shape("auto") is None
    assert parse_mesh_shape("space=4,time=2") == {"space": 4, "time": 2}
    with pytest.raises(ValueError, match="Unknown mesh axis"):
        parse_mesh_shape("bogus=2")
    with pytest.raises(ValueError, match=">= 1"):
        parse_mesh_shape("space=0")


def test_make_mesh_auto():
    mesh = make_mesh()
    assert mesh.shape[AXIS_SPACE] == len(jax.devices())
    assert mesh.shape["data"] == 1


def test_make_mesh_explicit():
    mesh = make_mesh("space=4,time=2")
    assert mesh.shape[AXIS_SPACE] == 4
    assert mesh.shape[AXIS_TIME] == 2


def test_make_mesh_bad_shape():
    with pytest.raises(ValueError, match="incompatible|does not cover"):
        make_mesh("space=3")


def test_shard_rows_places_data():
    mesh = make_mesh()
    x = np.arange(64, dtype=np.float32).reshape(16, 4)
    xs, rows = shard_rows(x, mesh)
    assert rows == 16
    np.testing.assert_array_equal(np.asarray(xs), x)
    assert xs.sharding.spec == P(AXIS_SPACE, None)


def test_ring_permute():
    mesh = make_mesh("time=8")
    n = mesh.shape[AXIS_TIME]

    def body(x):
        return ring_permute(x, AXIS_TIME, shift=1)

    x = jnp.arange(n, dtype=jnp.float32).reshape(n, 1)
    out = jax.shard_map(
        body, mesh=mesh, in_specs=P(AXIS_TIME, None), out_specs=P(AXIS_TIME, None)
    )(x)
    # block i receives block i-1's value
    expected = np.roll(np.arange(n, dtype=np.float32), 1).reshape(n, 1)
    np.testing.assert_array_equal(np.asarray(out), expected)


def test_all_to_all_reshard_space_to_time():
    """Ulysses-style reshard: row-sharded (space) -> column-sharded
    (time) via one all-to-all inside shard_map."""
    from dmd_era5_tpu.parallel.collectives import all_to_all

    mesh = make_mesh("space=8")
    n = 8
    s, t = 16, 24  # divisible by 8
    x = jnp.arange(s * t, dtype=jnp.float32).reshape(s, t)

    def body(x_loc):  # (s/n, t) -> (s, t/n)
        return all_to_all(x_loc, AXIS_SPACE, split_axis=1, concat_axis=0)

    out = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=P(AXIS_SPACE, None),
        out_specs=P(None, AXIS_SPACE),
    )(x)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(x))
    assert out.sharding.spec == P(None, AXIS_SPACE)


def test_reshard_helper_moves_layout():
    from dmd_era5_tpu.parallel import col_sharded, row_sharded, reshard

    mesh = make_mesh()
    x = jnp.arange(64 * 8, dtype=jnp.float32).reshape(64, 8)
    xr = jax.device_put(x, row_sharded(mesh))
    xc = reshard(xr, col_sharded(mesh, axis=AXIS_SPACE))
    np.testing.assert_array_equal(np.asarray(xc), np.asarray(x))
    assert xc.sharding.spec == P(None, AXIS_SPACE)


def test_halo_exchange_left():
    """Each time-shard prepends the left neighbor's last `halo` columns —
    the delay-embedding boundary exchange (SURVEY.md section 5,
    long-context parallelism)."""
    mesh = make_mesh("time=4")
    n = 4
    t_local = 3
    halo = 2

    def body(x):
        return halo_exchange_left(x, AXIS_TIME, halo=halo, axis=1)

    # global (1, 12) row: 0..11 split into 4 time shards of 3 columns
    x = jnp.arange(n * t_local, dtype=jnp.float32).reshape(1, n * t_local)
    out = jax.shard_map(
        body, mesh=mesh, in_specs=P(None, AXIS_TIME), out_specs=P(None, AXIS_TIME)
    )(x)
    out = np.asarray(out).reshape(n, -1, order="A")
    blocks = np.asarray(out).reshape(1, n, t_local + halo)[0]
    # shard 0: zero halo then [0,1,2]
    np.testing.assert_array_equal(blocks[0], [0, 0, 0, 1, 2])
    # shard 1: halo = last 2 of shard 0 => [1,2] then [3,4,5]
    np.testing.assert_array_equal(blocks[1], [1, 2, 3, 4, 5])
    np.testing.assert_array_equal(blocks[3], [7, 8, 9, 10, 11])


def test_initialize_distributed_is_safe_single_process(monkeypatch):
    """Autodetect gating (review r2 weak #7): no cluster markers means
    a strict no-op, and a *stale* marker (e.g. SLURM_JOB_ID on a 1-task
    allocation with no coordinator) must degrade to single-process with
    a warning instead of raising."""
    from dmd_era5_tpu.parallel.mesh import (
        _CLUSTER_ENV_MARKERS,
        initialize_distributed,
    )

    for var in ("JAX_COORDINATOR_ADDRESS", *_CLUSTER_ENV_MARKERS):
        monkeypatch.delenv(var, raising=False)
    initialize_distributed()  # no markers: nothing to do
    assert jax.process_count() == 1

    # stale marker without the rest of the launcher env: autodetect
    # fails inside jax.distributed and is swallowed with a warning
    monkeypatch.setenv("SLURM_JOB_ID", "12345")
    monkeypatch.delenv("SLURM_PROCID", raising=False)
    initialize_distributed()
    assert jax.process_count() == 1


class TestHybridMesh:
    """Multislice (ICI x DCN) mesh construction on the virtual mesh."""

    def test_layout_and_slice_locality(self):
        from dmd_era5_tpu.parallel import make_hybrid_mesh

        devices = jax.devices()
        assert len(devices) == 8
        mesh = make_hybrid_mesh(dcn_shape="data=2", n_slices=2)
        assert dict(mesh.shape) == {"data": 2, "space": 4, "time": 1}
        # every space-axis group must live inside ONE slice: collectives
        # along the GEMM/TSQR workhorse axis never cross DCN
        grid = mesh.devices
        for di in range(2):
            slice_devs = set(devices[di * 4 : (di + 1) * 4])
            assert set(grid[di, :, 0].ravel()) == slice_devs

    def test_dcn_major_ordering_with_mixed_axis(self):
        from dmd_era5_tpu.parallel import make_hybrid_mesh

        # space combines DCN(2, outer) x ICI(2, inner): shard s of 4
        # maps to slice s // 2, device s % 2 within it
        mesh = make_hybrid_mesh(
            ici_shape="space=2,data=2", dcn_shape="space=2", n_slices=2
        )
        assert dict(mesh.shape) == {"data": 2, "space": 4, "time": 1}
        devices = jax.devices()
        grid = mesh.devices
        for s in range(4):
            owner = {d for d in grid[:, s, 0].ravel()}
            expected_slice = set(devices[(s // 2) * 4 : (s // 2) * 4 + 4])
            assert owner <= expected_slice

    def test_fit_step_on_hybrid_mesh(self):
        from dmd_era5_tpu.parallel import make_hybrid_mesh
        from dmd_era5_tpu.pipeline.train_step import example_batch, fit_step

        mesh = make_hybrid_mesh(dcn_shape="data=2", n_slices=2)
        # full-width sketch (r = T): the randomized range finder is then
        # exact, so singular values match the numpy oracle tightly even
        # on a flat random spectrum
        x, omega = example_batch(2, 256, 64, 64)
        state = fit_step(x, omega, mesh, n_components=8)
        # oracle: single-device numpy SVD of the centered matrices
        xc = np.asarray(x) - np.asarray(x).mean(axis=2, keepdims=True)
        for b in range(2):
            s_ref = np.linalg.svd(xc[b], compute_uv=False)[:8]
            np.testing.assert_allclose(
                np.asarray(state.s)[b], s_ref, rtol=2e-4
            )

    def test_mesh_from_config_routes(self):
        from dmd_era5_tpu.parallel import mesh_from_config

        flat = mesh_from_config({"mesh_shape": "auto"})
        assert dict(flat.shape)["space"] == 8
        with pytest.raises(ValueError):
            # dcn factors cannot exceed the (single) detected slice count
            mesh_from_config(
                {"mesh_shape": "auto", "dcn_mesh_shape": "data=2"}
            )

    def test_uneven_slices_rejected(self):
        from dmd_era5_tpu.parallel import make_hybrid_mesh

        with pytest.raises(ValueError, match="not divisible"):
            make_hybrid_mesh(n_slices=3)
