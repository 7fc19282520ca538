"""Config-reachable SVD execution backends of the era5_svd stage.

The scale paths (Hankel operators, grid2d space x time sharding,
streamed / one-pass out-of-core) dispatch from the ``svd_backend``
config field inside ``svd_on_era5`` — extending the reference's
two-branch svd_type switch
(/root/reference/src/dmd_era5/era5_svd/era5_svd.py:230-263).
Each backend is checked for factor agreement against the inmem path.
"""

from __future__ import annotations

import numpy as np
import pytest

from dmd_era5_tpu.core.config_parser import config_parser
from dmd_era5_tpu.pipeline import era5_download, era5_svd
from dmd_era5_tpu.snapmat import create_mock_era5
from dmd_era5_tpu.utils.io_h5 import save_fieldset

BASE = {
    "source_path": "gs://mock",
    "delta_time": "1h",
    "variables": "temperature",
    "levels": "1000",
    "svd_type": "randomized",
    "delay_embedding": 2,
    "mean_center": True,
    "scale": False,
    "n_components": 8,
    "save_data_matrix": False,
}

# distinct time ranges per backend: the workdir cache matcher
# intentionally ignores svd_type/backend (reference era5_svd.py:178-188)
_RANGES = {
    "inmem": ("2021-01-01T00", "2021-01-02T00"),
    "hankel": ("2021-02-01T00", "2021-02-02T00"),
    "grid2d": ("2021-03-01T00", "2021-03-02T00"),
    "streamed": ("2021-04-01T00", "2021-04-02T00"),
    "onepass": ("2021-05-01T00", "2021-05-02T00"),
    "auto": ("2021-06-01T00", "2021-06-02T00"),
    "standard": ("2021-08-01T00", "2021-08-02T00"),
}


def _config(backend: str, **overrides) -> dict:
    start, end = _RANGES[backend]
    cfg = {
        **BASE,
        "start_datetime": start,
        "end_datetime": end,
        "svd_backend": backend,
        **overrides,
    }
    return cfg


def _stage_slice(cfg: dict) -> None:
    parsed = config_parser(cfg, "era5-svd")
    fs = create_mock_era5(
        parsed["start_datetime"],
        parsed["end_datetime"],
        parsed["variables"],
        parsed["levels"],
        seed=7,
    )
    fs = era5_download.add_config_attributes(fs, parsed)
    save_fieldset(fs, parsed["era5_slice_path"])


def _run(cfg: dict):
    _stage_slice(cfg)
    results, _, _ = era5_svd.main(cfg, write_artifact=False)
    return results


def _principal_angle(u_a: np.ndarray, u_b: np.ndarray) -> float:
    """Largest principal angle (rad) between the column spans."""
    qa, _ = np.linalg.qr(u_a)
    qb, _ = np.linalg.qr(u_b)
    sv = np.linalg.svd(qa.T @ qb, compute_uv=False)
    return float(np.arccos(np.clip(sv.min(), -1.0, 1.0)))


@pytest.fixture(scope="module")
def inmem_results():
    cfg = _config("inmem")
    _stage_slice(cfg)
    results, _, _ = era5_svd.main(cfg, write_artifact=False)
    return results


N_SPACE = 36 * 72
D = BASE["delay_embedding"]
K = BASE["n_components"]


class TestBackendParity:
    def test_inmem_baseline(self, inmem_results):
        r = inmem_results
        assert r["U"].shape == (N_SPACE * D, K)
        u = r["U"].values
        np.testing.assert_allclose(u.T @ u, np.eye(K), atol=1e-3)
        assert r.attrs["svd_backend"] == "inmem"
        assert r.attrs["svd_seconds"] > 0
        assert r.attrs["svd_gelem_per_s"] > 0

    @pytest.mark.parametrize("backend", ["hankel", "streamed", "grid2d"])
    def test_backend_matches_inmem(self, backend, inmem_results):
        overrides = {}
        if backend == "grid2d":
            overrides["mesh_shape"] = "space=4,time=2"
        r = _run(_config(backend, **overrides))
        # explicit grid2d with d > 1 reroutes to the Hankel grid path
        # (no host H_d(X) materialization) and records what actually ran
        expected = "hankel" if backend == "grid2d" else backend
        assert r.attrs["svd_backend"] == expected
        assert r["U"].shape == (N_SPACE * D, K)
        assert "X" not in r  # host Hankel not materialized / not saved
        # same seed -> same Gaussian sketch -> near-identical factors
        np.testing.assert_allclose(
            r["s"].values, inmem_results["s"].values, rtol=2e-3
        )
        angle = _principal_angle(r["U"].values, inmem_results["U"].values)
        assert angle < 5e-2, f"{backend}: subspace angle {angle}"
        u = r["U"].values
        np.testing.assert_allclose(u.T @ u, np.eye(K), atol=1e-3)

    def test_hankel_standard_matches_inmem_exact(self):
        """svd_type=standard + d > 1 on the hankel backend: the exact
        banded-Gram operator path agrees with the host-embedding inmem
        exact SVD to f32 accuracy — both are deterministic, so the
        tolerance is tight (no sketch variance)."""
        base = _config("standard", svd_type="standard")
        r_in = _run({**base, "svd_backend": "inmem"})
        assert r_in.attrs["svd_backend"] == "inmem"
        r_h = era5_svd.main(
            {**base, "svd_backend": "hankel"}, write_artifact=False
        )[0]
        assert r_h.attrs["svd_backend"] == "hankel"
        assert "X" not in r_h  # embedded matrix never on host
        np.testing.assert_allclose(
            r_h["s"].values, r_in["s"].values, rtol=1e-4
        )
        # T=25 mock snapshots have near-degenerate trailing values:
        # subspace sensitivity ~ eps/gap, so the angle tolerance is
        # looser than the value tolerance
        angle = _principal_angle(r_h["U"].values, r_in["U"].values)
        assert angle < 5e-3, f"hankel-exact: subspace angle {angle}"
        u = r_h["U"].values
        np.testing.assert_allclose(u.T @ u, np.eye(K), atol=1e-4)

    def test_hankel_standard_space_sharded(self):
        """Exact Hankel path on a space-sharded mesh matches the
        single-device result."""
        base = _config(
            "standard", svd_type="standard", svd_backend="hankel"
        )
        _stage_slice(base)
        r1 = era5_svd.main(base, write_artifact=False)[0]
        r8 = era5_svd.main(
            {**base, "svd_backend": "hankel", "mesh_shape": "space=8"},
            write_artifact=False,
        )[0]
        np.testing.assert_allclose(
            r8["s"].values, r1["s"].values, rtol=1e-4
        )
        angle = _principal_angle(r8["U"].values, r1["U"].values)
        assert angle < 5e-3, f"hankel-exact sharded: angle {angle}"

    def test_hankel_time_sharded_matches_inmem(self, inmem_results):
        """The hankel backend on a (space x time) grid mesh: the SP
        production path — no host embedding, factors match inmem."""
        r = _run(_config("hankel", mesh_shape="space=2,time=4"))
        assert r.attrs["svd_backend"] == "hankel"
        assert r["U"].shape == (N_SPACE * D, K)
        assert "X" not in r
        np.testing.assert_allclose(
            r["s"].values, inmem_results["s"].values, rtol=2e-3
        )
        angle = _principal_angle(r["U"].values, inmem_results["U"].values)
        assert angle < 5e-2, f"hankel-2d: subspace angle {angle}"
        u = r["U"].values
        np.testing.assert_allclose(u.T @ u, np.eye(K), atol=1e-3)

    def test_streamed_standard_exact_gram(self):
        """svd_type=standard + svd_backend=streamed: the 2-pass
        out-of-core exact Gram route (streamed_exact_gram_svd) —
        deterministic, so it must match the inmem exact factorization
        tightly: two disk passes where the randomized schedule needs
        n_iter + 2."""
        base = _config("streamed", svd_type="standard")
        r_in = _run({**base, "svd_backend": "inmem"})
        r_g = era5_svd.main(
            {**base, "svd_backend": "streamed"}, write_artifact=False
        )[0]
        assert r_g.attrs["svd_backend"] == "streamed"
        np.testing.assert_allclose(
            r_g["s"].values, r_in["s"].values, rtol=1e-4
        )
        angle = _principal_angle(r_g["U"].values, r_in["U"].values)
        assert angle < 5e-3, f"streamed-exact: subspace angle {angle}"
        u = r_g["U"].values
        np.testing.assert_allclose(u.T @ u, np.eye(K), atol=1e-4)

    def test_onepass_backend(self):
        """One-pass is a sketch-and-solve estimate: assert the HMT-style
        reconstruction bound (as ops tests do), not factor parity — the
        mock data's flat spectrum is its worst case."""
        from dmd_era5_tpu.snapmat import (
            apply_delay_embedding,
            flatten_era5_variables,
            standardize_data,
        )

        cfg = _config("onepass")
        r = _run(cfg)
        assert r.attrs["svd_backend"] == "onepass"
        assert r["U"].shape == (N_SPACE * D, K)

        parsed = config_parser(cfg, "era5-svd")
        fs = create_mock_era5(
            parsed["start_datetime"], parsed["end_datetime"],
            parsed["variables"], parsed["levels"], seed=7,
        )
        fs, _, _ = standardize_data(fs, scale=False)
        x = np.asarray(
            apply_delay_embedding(flatten_era5_variables(fs), D).data
        )
        u = r["U"].values
        err = np.linalg.norm(x - u @ (u.T @ x))
        s_full = np.linalg.svd(x, compute_uv=False)
        optimal = np.linalg.norm(s_full[K:])
        assert err <= 1.6 * optimal, (err, optimal)

    def test_embedded_coords_without_materialization(self):
        """delay/space coords are attached even when H is never built."""
        r = _run(_config("hankel", start_datetime="2021-07-01T00",
                         end_datetime="2021-07-02T00"))
        delay = r["U"].coords["delay"].values
        assert delay.shape == (N_SPACE * D,)
        np.testing.assert_array_equal(delay[:N_SPACE], 1)
        np.testing.assert_array_equal(delay[N_SPACE:], 0)
        # time coord dropped the first d-1 entries: 25 - 1 = 24
        assert r["V"].shape == (K, 24)


class TestBackendResolution:
    def test_auto_prefers_hankel_for_delay(self):
        from dmd_era5_tpu.parallel import make_mesh

        cfg = _config("auto")
        parsed = config_parser(cfg, "era5-svd")
        mesh = make_mesh("auto")
        assert era5_svd.resolve_svd_backend(parsed, mesh) == "hankel"
        assert (
            era5_svd.resolve_svd_backend(parsed, mesh, have_flat=False)
            == "inmem"
        )

    def test_auto_prefers_grid2d_on_time_mesh(self):
        from dmd_era5_tpu.parallel import make_mesh

        cfg = _config("auto", mesh_shape="space=2,time=4", delay_embedding=1)
        parsed = config_parser(cfg, "era5-svd")
        mesh = make_mesh(parsed["mesh_shape"])
        assert era5_svd.resolve_svd_backend(parsed, mesh) == "grid2d"

    def test_auto_prefers_hankel_on_time_mesh_with_delay(self):
        """d > 1 on a time-sharded mesh resolves to the grid-sharded
        Hankel-operator path — never the host-embedding grid2d route."""
        from dmd_era5_tpu.parallel import make_mesh

        cfg = _config("auto", mesh_shape="space=2,time=4")
        parsed = config_parser(cfg, "era5-svd")
        mesh = make_mesh(parsed["mesh_shape"])
        assert era5_svd.resolve_svd_backend(parsed, mesh) == "hankel"

    def test_auto_standard_with_delay_resolves_hankel(self, caplog):
        """standard + d > 1 takes the exact Hankel-operator path (no
        host embedding); a time-sharded mesh still warns (replicated
        time work on the exact path)."""
        from dmd_era5_tpu.parallel import make_mesh

        cfg = _config("auto", svd_type="standard", mesh_shape="time=8")
        parsed = config_parser(cfg, "era5-svd")
        mesh = make_mesh(parsed["mesh_shape"])
        assert era5_svd.resolve_svd_backend(parsed, mesh) == "hankel"

    def test_explicit_grid2d_with_delay_routes_hankel(self, caplog):
        """Explicit svd_backend=grid2d with d > 1 must NOT host-embed:
        it reroutes to the Hankel grid path (review r3 weak #3 — the
        d-fold H_d(X) RAM blowup of reference slice_tools.py:207-211)."""
        from dmd_era5_tpu.parallel import make_mesh

        cfg = _config("grid2d", mesh_shape="space=2,time=4")
        parsed = config_parser(cfg, "era5-svd")
        mesh = make_mesh(parsed["mesh_shape"])
        assert parsed["delay_embedding"] > 1
        assert era5_svd.resolve_svd_backend(parsed, mesh) == "hankel"
        # without the flat matrix (already-embedded artifact) grid2d
        # stands — the embedding is already materialized
        assert (
            era5_svd.resolve_svd_backend(parsed, mesh, have_flat=False)
            == "grid2d"
        )

    def test_explicit_grid2d_no_delay_executes_grid2d(self):
        """d == 1 grid2d actually runs the grid-sharded factorization
        (no embedding to avoid), and matches inmem factors."""
        cfg = _config(
            "grid2d", mesh_shape="space=4,time=2", delay_embedding=1
        )
        r = _run(cfg)
        assert r.attrs["svd_backend"] == "grid2d"
        assert r["U"].shape == (N_SPACE, K)
        u = r["U"].values
        np.testing.assert_allclose(u.T @ u, np.eye(K), atol=1e-3)

    def test_explicit_grid2d_no_delay_stays_grid2d(self):
        from dmd_era5_tpu.parallel import make_mesh

        cfg = _config("grid2d", mesh_shape="space=2,time=4", delay_embedding=1)
        parsed = config_parser(cfg, "era5-svd")
        mesh = make_mesh(parsed["mesh_shape"])
        assert era5_svd.resolve_svd_backend(parsed, mesh) == "grid2d"

    def test_auto_standard_no_delay_stays_inmem(self):
        from dmd_era5_tpu.parallel import make_mesh

        cfg = _config("auto", svd_type="standard", delay_embedding=1)
        parsed = config_parser(cfg, "era5-svd")
        mesh = make_mesh(parsed.get("mesh_shape", "space=1"))
        assert era5_svd.resolve_svd_backend(parsed, mesh) == "inmem"

    def test_parser_rejects_unknown_backend(self):
        cfg = _config("inmem", svd_backend="magic")
        with pytest.raises(ValueError, match="Invalid svd_backend"):
            config_parser(cfg, "era5-svd")

    def test_parser_rejects_backend_for_standard(self):
        cfg = _config("grid2d", svd_type="standard")
        with pytest.raises(ValueError, match="requires svd_type"):
            config_parser(cfg, "era5-svd")

    def test_parser_accepts_hankel_for_standard(self):
        cfg = _config("hankel", svd_type="standard")
        parsed = config_parser(cfg, "era5-svd")
        assert parsed["svd_backend"] == "hankel"

    def test_default_backend_is_auto(self):
        cfg = _config("inmem")
        del cfg["svd_backend"]
        parsed = config_parser(cfg, "era5-svd")
        assert parsed["svd_backend"] == "auto"


class TestAutoScaleRouting:
    def test_auto_routes_oversized_matrix_to_streamed(self, monkeypatch):
        """A matrix whose in-memory footprint exceeds the per-device
        HBM budget routes svd_backend=auto to the out-of-core streamed
        backend — the real 0.25-degree ERA5 configs must work from
        config.ini without manual backend selection."""
        from dmd_era5_tpu.parallel import make_mesh

        cfg = _config("auto", delay_embedding=1)
        parsed = config_parser(cfg, "era5-svd")
        mesh = make_mesh("space=1")
        # one week of 0.25-degree at 15 fields
        parsed["_matrix_rows"] = 721 * 1440 * 15
        parsed["_matrix_cols"] = 168
        # the CPU reports no memory limit: no budget, stays in memory
        monkeypatch.delenv("DMD_ERA5_TPU_HBM_BUDGET_GB", raising=False)
        assert era5_svd.resolve_svd_backend(parsed, mesh) == "inmem"
        # a 12 GB device cannot hold it
        monkeypatch.setenv("DMD_ERA5_TPU_HBM_BUDGET_GB", "12")
        assert era5_svd.resolve_svd_backend(parsed, mesh) == "streamed"
        # small matrices stay in memory
        parsed["_matrix_rows"] = 1 << 19
        parsed["_matrix_cols"] = 512
        assert era5_svd.resolve_svd_backend(parsed, mesh) == "inmem"
        # a large enough space-sharded mesh brings it back in memory
        parsed["_matrix_rows"] = 721 * 1440 * 15
        parsed["_matrix_cols"] = 168
        mesh8 = make_mesh("space=8")
        assert era5_svd.resolve_svd_backend(parsed, mesh8) == "inmem"
        # budget is env-overridable
        monkeypatch.setenv("DMD_ERA5_TPU_HBM_BUDGET_GB", "0.001")
        assert era5_svd.resolve_svd_backend(parsed, mesh8) == "streamed"

        # svd_type=standard over budget ALSO goes out-of-core (round-5:
        # the streamed backend serves it via the 2-pass exact Gram
        # route); under budget it stays inmem
        monkeypatch.setenv("DMD_ERA5_TPU_HBM_BUDGET_GB", "12")
        cfg_std = _config("auto", delay_embedding=1, svd_type="standard")
        parsed_std = config_parser(cfg_std, "era5-svd")
        parsed_std["_matrix_rows"] = 721 * 1440 * 15
        parsed_std["_matrix_cols"] = 168
        assert (
            era5_svd.resolve_svd_backend(parsed_std, mesh) == "streamed"
        )
        parsed_std["_matrix_rows"] = 1 << 19
        assert era5_svd.resolve_svd_backend(parsed_std, mesh) == "inmem"
