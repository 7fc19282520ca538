"""DMD pipeline stage: end-to-end over the SVD stage + forecast artifact."""

from __future__ import annotations

import numpy as np
import pytest

from dmd_era5_tpu.core.config_parser import config_parser
from dmd_era5_tpu.pipeline import era5_dmd, era5_download, era5_svd
from dmd_era5_tpu.snapmat import create_mock_era5
from dmd_era5_tpu.utils.io_h5 import load_fieldset, save_fieldset


@pytest.fixture()
def dmd_config():
    return {
        "source_path": "gs://mock-bucket/era5.zarr",
        "start_datetime": "2019-05-01T00",
        "end_datetime": "2019-05-02T00",
        "delta_time": "1h",
        "variables": "temperature",
        "levels": "1000",
        "svd_type": "standard",
        "delay_embedding": 2,
        "mean_center": True,
        "scale": False,
        "n_components": 8,
        "save_data_matrix": True,
        "dmd_rank": 6,
        "optimized": True,
        "forecast_steps": 6,
        "lm_max_iter": 30,
    }


def _stage_slice(cfg) -> None:
    parsed = config_parser(cfg, "era5-svd")
    fs = create_mock_era5(
        parsed["start_datetime"],
        parsed["end_datetime"],
        parsed["variables"],
        parsed["levels"],
        seed=21,
    )
    fs = era5_download.add_config_attributes(fs, parsed)
    save_fieldset(fs, parsed["era5_slice_path"])


def test_dmd_stage_end_to_end(dmd_config):
    _stage_slice(dmd_config)
    results, added, retrieved = era5_dmd.main(
        dmd_config, write_artifact=True, use_store=False
    )
    assert not added and not retrieved
    n_space = 36 * 72
    d = dmd_config["delay_embedding"]
    r = dmd_config["dmd_rank"]
    assert results["modes"].shape == (n_space * d, r)
    assert results["eigenvalues"].shape == (r,)
    assert np.iscomplexobj(results["eigenvalues"].values)
    assert results["amplitudes"].shape == (r,)
    # forecast: undelayed rows, training window + 6 extra steps
    assert results["forecast"].shape == (n_space, 24 + 6)
    assert results.attrs["dmd_rank"] == r
    assert results.attrs["optimized"] == 1
    assert np.isfinite(results.attrs["dmd_residual"])
    # forecast carries an extended time coordinate
    times = results["forecast"].coords["time_out"].values
    assert len(times) == 30
    assert (times[1] - times[0]) == np.timedelta64(1, "h")


def test_dmd_stage_workdir_cache(dmd_config):
    _stage_slice(dmd_config)
    first, _, _ = era5_dmd.main(dmd_config, write_artifact=True)
    second, added, retrieved = era5_dmd.main(dmd_config, write_artifact=True)
    assert not added and not retrieved
    np.testing.assert_allclose(
        np.abs(second["eigenvalues"].values),
        np.abs(first["eigenvalues"].values),
        rtol=1e-5,
    )


def test_dmd_artifact_roundtrip(dmd_config):
    dmd_config["start_datetime"] = "2019-06-01T00"
    dmd_config["end_datetime"] = "2019-06-01T18"
    dmd_config["forecast_steps"] = 0
    _stage_slice(dmd_config)
    results, added, _ = era5_dmd.main(
        dmd_config, write_artifact=True, use_store=True
    )
    assert added
    assert "forecast" not in results
    parsed = config_parser(dmd_config, "era5-dmd")
    back = load_fieldset(parsed["save_path"])
    np.testing.assert_allclose(
        back["modes"].values, results["modes"].values, atol=1e-6
    )
    assert back.attrs["optimized"] == 1


def test_dmd_exact_mode(dmd_config):
    dmd_config["start_datetime"] = "2019-07-01T00"
    dmd_config["end_datetime"] = "2019-07-01T20"
    dmd_config["optimized"] = False
    _stage_slice(dmd_config)
    results, _, _ = era5_dmd.main(dmd_config, write_artifact=False)
    assert results.attrs["optimized"] == 0
    assert results.attrs["lm_iterations"] == 0


def test_dmd_forecast_reconstructs_training_window(dmd_config):
    """The rollout over the training window should approximate the raw
    (unstandardized) mock data — full-chain inverse-transform check."""
    dmd_config["start_datetime"] = "2019-08-01T00"
    dmd_config["end_datetime"] = "2019-08-02T00"
    dmd_config["n_components"] = 8
    dmd_config["dmd_rank"] = 8
    _stage_slice(dmd_config)
    results, _, _ = era5_dmd.main(dmd_config, write_artifact=False)
    parsed = config_parser(dmd_config, "era5-svd")
    raw = load_fieldset(parsed["era5_slice_path"])
    t_raw = raw["temperature"].transpose(
        "level", "latitude", "longitude", "time"
    ).values.reshape(-1, 25)
    d = dmd_config["delay_embedding"]
    window = t_raw[:, d - 1 :]  # forecast rows align with times[d-1:]
    fc = results["forecast"].values[:, : 25 - d + 1]
    rel = np.linalg.norm(fc - window) / np.linalg.norm(window)
    # mock data is mostly white noise in time; the rank-8 DMD captures
    # the mean structure, so the error must at least be bounded well
    # below the raw norm and the fit must be finite/sane
    assert np.isfinite(rel)
    assert rel < 0.2


def test_dmd_stage_bagged(dmd_config):
    """BOP-DMD through the stage: uncertainty fields + cache keying."""
    dmd_config["bagging_trials"] = 6
    dmd_config["bagging_fraction"] = 0.75
    _stage_slice(dmd_config)
    results, _, _ = era5_dmd.main(dmd_config, write_artifact=True)
    r = dmd_config["dmd_rank"]
    n_rows = 36 * 72 * dmd_config["delay_embedding"]
    assert results.attrs["bagging_trials"] == 6
    assert results["eigenvalues_std"].shape == (r,)
    assert results["amplitudes_std"].shape == (r,)
    assert results["modes_std"].shape == (n_rows, r)
    assert np.all(results["eigenvalues_std"].values >= 0)
    assert np.all(np.isfinite(results["modes_std"].values))
    # forecast still produced from the bagged point estimate
    assert "forecast" in results

    # a plain-optDMD config must NOT hit the bagged artifact's cache
    plain = dict(dmd_config, bagging_trials=0)
    plain_results, _, retrieved = era5_dmd.main(plain, write_artifact=False)
    assert not retrieved
    assert "eigenvalues_std" not in plain_results


def test_dmd_stage_bagged_on_mesh(dmd_config):
    """Bagged stage fit with a data-sharded mesh: the bag EP-shards."""
    from dmd_era5_tpu.parallel import make_mesh

    dmd_config["bagging_trials"] = 8
    _stage_slice(dmd_config)
    mesh = make_mesh("data=4,space=2")
    results, _, _ = era5_dmd.main(dmd_config, mesh=mesh)
    assert results.attrs["bagging_trials"] == 8
    assert results.attrs["bagging_trials_used"] >= 1
    assert np.all(np.isfinite(results["eigenvalues_std"].values))


def test_dmd_stage_multiresolution(dmd_config):
    """multiresolution_levels > 0 adds per-level mrDMD fields."""
    dmd_config["multiresolution_levels"] = 2
    dmd_config["mr_max_cycles"] = 1.5
    _stage_slice(dmd_config)
    results, _, _ = era5_dmd.main(dmd_config, write_artifact=True)

    n_space = 36 * 72 * dmd_config["delay_embedding"]
    r = dmd_config["dmd_rank"]
    # level 0: one window; level 1: two windows
    assert results["mr_eigenvalues_L0"].shape == (1, r)
    assert results["mr_eigenvalues_L1"].shape == (2, r)
    assert results["mr_modes_L0"].shape == (1, n_space, r)
    assert results["mr_modes_L1"].shape == (2, n_space, r)
    assert results["mr_amplitudes_L1"].shape == (2, r)
    assert results["mr_slow_mask_L0"].shape == (1, r)
    assert np.iscomplexobj(results["mr_eigenvalues_L0"].values)
    # lifted modes are unit columns
    norms = np.linalg.norm(results["mr_modes_L0"].values[0], axis=0)
    live = norms > 1e-6
    np.testing.assert_allclose(norms[live], 1.0, rtol=1e-4)

    assert results.attrs["multiresolution_levels"] == 2
    # 25 hourly snapshots inclusive, delay 2 -> T=24, even: all used
    assert results.attrs["mr_t_used"] == 24
    res_rel = results.attrs["multiresolution_residual"]
    assert np.isfinite(res_rel) and 0.0 <= res_rel < 1.0

    # the artifact round-trips and the cache check keys on mr levels
    parsed = config_parser(dmd_config, "era5-dmd")
    reloaded = load_fieldset(parsed["save_path"])
    np.testing.assert_allclose(
        reloaded["mr_eigenvalues_L1"].values,
        results["mr_eigenvalues_L1"].values,
        atol=1e-6,
    )
    assert era5_dmd.check_dmd_results(reloaded, parsed)
    plain_cfg = config_parser(
        dict(dmd_config, multiresolution_levels=0), "era5-dmd"
    )
    assert not era5_dmd.check_dmd_results(reloaded, plain_cfg)


def test_dmd_corrupt_cached_artifact_is_recomputed(dmd_config):
    """A cached fit with non-finite amplitudes must not be served.

    Regression: an artifact written by a build with a bf16-Gram lstsq
    bug carried nan amplitudes; the config matched, so the stage
    returned it forever.  check_dmd_results now also validates
    finiteness (as does check_svd_results for singular values).
    """
    _stage_slice(dmd_config)
    first, _, _ = era5_dmd.main(dmd_config, write_artifact=True)
    parsed = config_parser(dmd_config, "era5-dmd")

    corrupt = load_fieldset(parsed["save_path"])
    corrupt["amplitudes"].data = np.full_like(
        np.asarray(corrupt["amplitudes"].data), np.nan
    )
    save_fieldset(corrupt, parsed["save_path"])
    assert not era5_dmd.check_dmd_results(corrupt, parsed)

    results, added, retrieved = era5_dmd.main(
        dmd_config, write_artifact=True
    )
    assert not retrieved
    assert np.isfinite(results["amplitudes"].values).all()
    np.testing.assert_allclose(
        np.abs(results["eigenvalues"].values),
        np.abs(first["eigenvalues"].values),
        atol=1e-5,
    )


def test_svd_corrupt_cached_artifact_is_recomputed(dmd_config):
    _stage_slice(dmd_config)
    svd_first, _, _ = era5_svd.main(dmd_config, write_artifact=True)
    parsed = config_parser(dmd_config, "era5-svd")
    corrupt = load_fieldset(parsed["save_path"])
    corrupt["s"].data = np.full_like(
        np.asarray(corrupt["s"].data), np.inf
    )
    save_fieldset(corrupt, parsed["save_path"])
    assert not era5_svd.check_svd_results(corrupt, parsed)
    results, _, retrieved = era5_svd.main(dmd_config, write_artifact=True)
    assert not retrieved
    assert np.isfinite(results["s"].values).all()


def _stage_slice_dynamic(cfg, n_lat=36, n_lon=72) -> None:
    """Stage a slice whose fields follow KNOWN coherent dynamics:
    damped traveling waves (exactly rank-4 + small noise), so a correct
    DMD fit must out-forecast persistence on a withheld tail."""
    parsed = config_parser(cfg, "era5-svd")
    fs = create_mock_era5(
        parsed["start_datetime"],
        parsed["end_datetime"],
        parsed["variables"],
        parsed["levels"],
        seed=7,
    )
    times = fs.coord("time").values
    t = np.arange(len(times), dtype=np.float64)
    lat = np.deg2rad(fs.coord("latitude").values.astype(np.float64))
    lon = np.deg2rad(fs.coord("longitude").values.astype(np.float64))
    ll_lat = lat[:, None] + 0 * lon[None, :]
    ll_lon = 0 * lat[:, None] + lon[None, :]
    rng = np.random.default_rng(3)
    for name in fs.variables:
        field = fs[name]
        # (time, level, lat, lon)
        shape = field.shape
        sig = np.zeros((len(t),) + shape[1:], dtype=np.float64)
        for freq, damp, klon in ((0.35, 0.005, 1), (0.8, 0.02, 3)):
            phase = freq * t[:, None, None] - klon * ll_lon[None]
            pattern = np.cos(ll_lat)[None] * np.cos(phase) + np.sin(
                2 * ll_lat
            )[None] * np.sin(phase)
            sig += np.exp(-damp * t)[:, None, None, None] * pattern[
                :, None, :, :
            ]
        noise = 0.01 * rng.standard_normal(sig.shape)
        field.data = (250.0 + 10.0 * sig + noise).astype(np.float32)
    fs = era5_download.add_config_attributes(fs, parsed)
    save_fieldset(fs, parsed["era5_slice_path"])


def test_dmd_forecast_holdout_scores_beat_persistence(dmd_config):
    """review r3 item 2: fit on train, score on withheld truth.

    The stage must stamp per-lead latitude-weighted RMSE/ACC/bias into
    the artifact attrs, and on coherent wave dynamics the DMD forecast
    must clearly beat the persistence baseline at the final lead."""
    holdout = 8
    cfg = dict(
        dmd_config,
        start_datetime="2019-06-01T00",
        end_datetime="2019-06-03T00",  # 49 snapshots
        forecast_holdout=holdout,
        forecast_steps=0,
        n_components=8,
        dmd_rank=8,
    )
    _stage_slice_dynamic(cfg)
    results, _, _ = era5_dmd.main(cfg, write_artifact=True)

    assert results.attrs["forecast_holdout"] == holdout
    rmse = results.attrs["forecast_rmse"]
    acc = results.attrs["forecast_acc"]
    bias = results.attrs["forecast_bias"]
    p_rmse = results.attrs["persistence_rmse"]
    assert len(rmse) == len(acc) == len(bias) == holdout
    assert all(np.isfinite(rmse)) and all(np.isfinite(acc))
    # known dynamics: DMD must beat the no-skill baseline at the final
    # lead by a wide margin, with near-perfect anomaly correlation
    assert rmse[-1] < 0.5 * p_rmse[-1], (rmse, p_rmse)
    assert acc[-1] > 0.9, acc

    # the SVD artifact carried the raw truth and was fit on train only
    svd_parsed = config_parser(cfg, "era5-svd")
    svd_fs = load_fieldset(svd_parsed["era5_svd_path"])
    assert svd_fs["holdout_truth"].shape[1] == holdout
    assert svd_fs["V"].shape[1] == 49 - holdout - (
        cfg["delay_embedding"] - 1
    )
    assert svd_fs.attrs["forecast_holdout"] == holdout

    # cache key: a different holdout must not reuse this artifact
    other = config_parser(dict(cfg, forecast_holdout=4), "era5-dmd")
    assert not era5_dmd.check_dmd_results(results, other)


def _stage_slice_forced(cfg) -> np.ndarray:
    """Stage a slice driven by a KNOWN diurnal forcing: internal damped
    dynamics plus a strong B*u(t) term with u = [cos, sin](2 pi t/24).
    Returns the control series the generator used (absolute phase)."""
    parsed = config_parser(cfg, "era5-svd")
    fs = create_mock_era5(
        parsed["start_datetime"],
        parsed["end_datetime"],
        parsed["variables"],
        parsed["levels"],
        seed=11,
    )
    times = fs.coord("time").values
    t64 = times.astype("datetime64[ns]").astype(np.int64)
    abs_hours = (t64 / 3.6e12).astype(np.float64)
    ang = 2.0 * np.pi * abs_hours / 24.0
    u_ctrl = np.stack([np.cos(ang), np.sin(ang)])  # (2, T)

    lat = np.deg2rad(fs.coord("latitude").values.astype(np.float64))
    lon = np.deg2rad(fs.coord("longitude").values.astype(np.float64))
    p1 = np.cos(lat)[:, None] * np.cos(lon)[None, :]
    p2 = np.sin(lat)[:, None] * np.sin(2 * lon)[None, :]
    p3 = np.cos(2 * lat)[:, None] * np.cos(3 * lon)[None, :]
    rng = np.random.default_rng(5)
    t = np.arange(len(times), dtype=np.float64)
    internal = np.exp(-0.02 * t)[:, None, None] * (
        np.cos(0.5 * t)[:, None, None] * p1[None]
    )
    forced = (
        u_ctrl[0][:, None, None] * p2[None]
        + u_ctrl[1][:, None, None] * p3[None]
    )
    for name in fs.variables:
        field = fs[name]
        sig = internal + 3.0 * forced
        noise = 0.01 * rng.standard_normal(
            (len(times),) + field.shape[1:]
        )
        field.data = (
            260.0 + 8.0 * sig[:, None, :, :] + noise
        ).astype(np.float32)
    fs = era5_download.add_config_attributes(fs, parsed)
    save_fieldset(fs, parsed["era5_slice_path"])
    return u_ctrl


def test_dmd_stage_dmdc(dmd_config):
    """review r3 item 6: python -m ...era5_dmd produces a DMDc
    artifact when control_input is configured."""
    cfg = dict(
        dmd_config,
        start_datetime="2019-07-01T00",
        end_datetime="2019-07-03T00",
        control_input="diurnal",
        forecast_steps=0,
        n_components=8,
        dmd_rank=6,
    )
    u_gen = _stage_slice_forced(cfg)
    results, _, _ = era5_dmd.main(cfg, write_artifact=True)

    r = cfg["dmd_rank"]
    n_space = 36 * 72 * cfg["delay_embedding"]
    assert results["dmdc_eigenvalues"].shape == (r,)
    assert results["dmdc_modes"].shape == (n_space, r)
    assert results["dmdc_a_red"].shape == (r, r)
    assert results["dmdc_b_red"].shape == (r, 2)
    assert results.attrs["control_input"] == "diurnal"
    # the stage's diurnal series must equal the generator's (absolute
    # phase, transition-aligned): delay d=2 drops the first snapshot
    d = cfg["delay_embedding"]
    np.testing.assert_allclose(
        results["dmdc_control"].values,
        u_gen[:, d - 1 : -1],
        atol=1e-5,
    )
    # strong known forcing: the forced one-step model must explain the
    # transitions far better than chance
    assert results.attrs["dmdc_residual"] < 0.2, results.attrs[
        "dmdc_residual"
    ]
    # the control input participates in the cache key
    other = config_parser(dict(cfg, control_input="none"), "era5-dmd")
    assert not era5_dmd.check_dmd_results(results, other)


def test_dmd_stage_dmdc_from_file(dmd_config, tmp_path):
    cfg = dict(
        dmd_config,
        start_datetime="2019-08-01T00",
        end_datetime="2019-08-02T00",
        forecast_steps=0,
        n_components=8,
        dmd_rank=6,
    )
    _stage_slice(cfg)
    rng = np.random.default_rng(0)
    # the series aligns with the ARTIFACT time axis: delay embedding
    # drops the first d-1 snapshots, so T = 25 - (d-1) = 24 here
    d = cfg["delay_embedding"]
    t_emb = 25 - (d - 1)
    series = rng.standard_normal((3, t_emb)).astype(np.float32)
    path = tmp_path / "ctrl.npy"
    np.save(path, series)
    cfg["control_input"] = str(path)
    results, _, _ = era5_dmd.main(cfg, write_artifact=False)
    assert results["dmdc_b_red"].shape == (6, 3)
    assert results["dmdc_control"].shape == (3, t_emb - 1)
    np.testing.assert_allclose(
        results["dmdc_control"].values, series[:, :-1], atol=0
    )


def test_dmd_stage_multiresolution_refit(dmd_config):
    """mr_refit_rank: the stage fits classic per-window mrDMD on the
    raw embedded matrix instead of inside the POD subspace."""
    cfg = dict(
        dmd_config,
        start_datetime="2019-09-01T00",
        end_datetime="2019-09-02T00",
        multiresolution_levels=2,
        mr_refit_rank=4,
        save_data_matrix=True,
        forecast_steps=0,
    )
    _stage_slice(cfg)
    results, _, _ = era5_dmd.main(cfg, write_artifact=True)
    assert results.attrs["mr_refit_rank"] == 4
    # per-window rank follows mr_refit_rank, not dmd_rank
    assert results["mr_eigenvalues_L1"].shape == (2, 4)
    n_space = 36 * 72 * cfg["delay_embedding"]
    assert results["mr_modes_L0"].shape == (1, n_space, 4)
    res_rel = results.attrs["multiresolution_residual"]
    assert np.isfinite(res_rel) and 0.0 <= res_rel < 1.0
    # cache key: subspace vs refit hierarchies are different artifacts
    parsed_sub = config_parser(dict(cfg, mr_refit_rank=0), "era5-dmd")
    assert not era5_dmd.check_dmd_results(results, parsed_sub)


def test_mr_refit_streams_without_data_matrix(dmd_config):
    """mr_refit_rank WITHOUT save_data_matrix (review r4 item 7): the
    stage streams the raw refit out-of-core from the slice artifact —
    one Gram pass, no X in the SVD artifact, spectra matching the
    in-memory refit route."""
    cfg = dict(
        dmd_config,
        start_datetime="2019-09-03T00",  # own range: no artifact-cache
        end_datetime="2019-09-04T00",    # hit from the previous test
        multiresolution_levels=2,
        mr_refit_rank=4,
        save_data_matrix=False,
        forecast_steps=0,
    )
    _stage_slice(cfg)
    results, _, _ = era5_dmd.main(cfg, write_artifact=False)
    assert results.attrs["mr_refit_rank"] == 4
    assert results["mr_eigenvalues_L1"].shape == (2, 4)
    # compact time-side mode factors always present on the Gram route
    t_used = results.attrs["mr_t_used"]
    assert results["mr_mode_map_L0"].shape == (1, t_used, 4)
    res_rel = results.attrs["multiresolution_residual"]
    assert np.isfinite(res_rel) and 0.0 <= res_rel < 1.0

    # parity with the in-memory refit (save_data_matrix=True) route
    cfg_mem = dict(cfg, save_data_matrix=True)
    ref, _, _ = era5_dmd.main(cfg_mem, write_artifact=False)
    for lvl in (0, 1):
        om_got = np.sort_complex(
            np.asarray(results[f"mr_eigenvalues_L{lvl}"].data).ravel()
        )
        om_ref = np.sort_complex(
            np.asarray(ref[f"mr_eigenvalues_L{lvl}"].data).ravel()
        )
        np.testing.assert_allclose(om_got, om_ref, rtol=0, atol=2e-2)
    np.testing.assert_allclose(
        results.attrs["multiresolution_residual"],
        ref.attrs["multiresolution_residual"],
        atol=2e-2,
    )
