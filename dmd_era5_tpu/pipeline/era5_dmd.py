"""DMD stage: optimized (or exact) DMD + forecast from SVD artifacts.

The third pipeline stage — the decomposition the reference cites but
never implements (/root/reference/README.md:85,139; SURVEY.md fact 2).
Consumes the SVD stage's artifacts (cascading through its cache ladder),
fits continuous-time eigenvalues/modes/amplitudes with the
variable-projection solver (models/optdmd.py) or a plain exact-DMD
solve, optionally rolls out a forecast beyond the training window, and
versions the result like every other stage.

Run as ``python -m dmd_era5_tpu.pipeline.era5_dmd``.
"""

from __future__ import annotations

from datetime import datetime

import jax.numpy as jnp
import numpy as np

from dmd_era5_tpu.core import config_parser, config_reader, log_and_print, setup_logger
from dmd_era5_tpu.models import (
    bopdmd_from_svd,
    optdmd_from_svd,
)
from dmd_era5_tpu.pipeline import era5_svd
from dmd_era5_tpu.pipeline.artifacts import add_data_to_store
from dmd_era5_tpu.utils.io_h5 import save_fieldset
from dmd_era5_tpu.utils.labels import Coord, Field, FieldSet

logger = setup_logger("ERA5-DMD", "era5_dmd.log")

__all__ = ["fit_dmd_from_svd_results", "retrieve_dmd_results", "main"]


def check_dmd_results(fs: FieldSet, parsed_config: dict) -> bool:
    attrs = fs.attrs
    # reject numerically corrupt cached fits (nan amplitudes/eigenvalues
    # — e.g. written by an older build with a precision bug) so the
    # stage recomputes instead of serving garbage
    for key in ("amplitudes", "eigenvalues"):
        if key in fs.data_vars and not np.isfinite(
            np.asarray(fs[key].data)
        ).all():
            return False
    return (
        era5_svd.check_svd_results(fs, parsed_config)
        and parsed_config["dmd_rank"] == attrs.get("dmd_rank")
        and int(parsed_config["optimized"]) == attrs.get("optimized")
        and parsed_config.get("bagging_trials", 0)
        == attrs.get("bagging_trials", 0)
        and parsed_config.get("forecast_steps", 0)
        == attrs.get("forecast_steps", 0)
        and parsed_config.get("control_input", "none")
        == attrs.get("control_input", "none")
        and parsed_config.get("multiresolution_levels", 0)
        == attrs.get("multiresolution_levels", 0)
        and (
            parsed_config.get("multiresolution_levels", 0) == 0
            or (
                parsed_config.get("mr_max_cycles", 1.0)
                == attrs.get("mr_max_cycles", 1.0)
                and parsed_config.get("mr_refit_rank", 0)
                == attrs.get("mr_refit_rank", 0)
            )
        )
    )


def retrieve_dmd_results(
    parsed_config: dict, use_store: bool = False
) -> tuple[FieldSet | None, bool]:
    return era5_svd._retrieve(
        parsed_config,
        use_store,
        "era5_dmd_path",
        "era5_dmd",
        check_dmd_results,
        "DMD results",
    )


def _mr_refit_streamed(
    parsed_config: dict,
    dt_hours: float,
    mr_levels: int,
    mr_refit: int,
    use_store: bool = False,
):
    """Raw-data mrDMD refit WITHOUT X in the SVD artifact (out-of-core).

    Re-runs the slice preprocessing chain (same ordering as the SVD
    stage, era5_svd.py — including the forecast-holdout withholding so
    the refit never sees scored truth), packs the embedded matrix to
    disk as d delay slabs (the d-fold Hankel copy never exists in host
    RAM), and fits the hierarchy from ONE streamed Gram pass
    (models.mrdmd.fit_mrdmd_streamed).  S-sized modes are materialized
    only when they fit a 2 GB budget; the compact time-side mode maps
    are always available.
    """
    from pathlib import Path

    from dmd_era5_tpu.models.mrdmd import fit_mrdmd_streamed
    from dmd_era5_tpu.snapmat import (
        flatten_era5_variables,
        resample_era5_dataset,
        slice_era5_dataset,
        standardize_data,
    )
    from dmd_era5_tpu.snapmat.loader import save_packed_matrix

    ds, _ = era5_svd.retrieve_era5_slice(parsed_config, use_store)
    if ds is None:
        raise ValueError(
            "mr_refit_rank needs either the data matrix in the SVD "
            "artifact (save_data_matrix = True) or the ERA5 slice "
            "artifact in the working directory for the streamed refit."
        )
    ds = ds[parsed_config["variables"]]
    ds = slice_era5_dataset(ds, levels=parsed_config["levels"])
    ds = resample_era5_dataset(ds, parsed_config["delta_time"])
    holdout = int(parsed_config.get("forecast_holdout", 0))
    if holdout > 0:
        n_time = len(ds.coord("time").values)
        ds = ds.isel(time=slice(0, n_time - holdout))
    if parsed_config["mean_center"] and parsed_config["scale"]:
        ds, _, _ = standardize_data(ds)
    elif parsed_config["mean_center"]:
        ds, _, _ = standardize_data(ds, scale=False)
    da_flat = flatten_era5_variables(ds)
    x = np.asarray(da_flat.data, dtype=np.float32)
    d = int(parsed_config["delay_embedding"])
    packed = Path(str(parsed_config["save_path"]) + ".mr.packed.h5")
    save_packed_matrix(packed, x, d=d)
    try:
        n_rows = x.shape[0] * d
        n_windows = 2**mr_levels - 1
        modes_bytes = n_rows * mr_refit * 8 * n_windows
        mr = fit_mrdmd_streamed(
            packed,
            dt=dt_hours,
            rank=mr_refit,
            max_levels=mr_levels,
            max_cycles=parsed_config.get("mr_max_cycles", 1.0),
            block_rows=int(parsed_config.get("stream_block_rows", 1 << 16)),
            return_modes=modes_bytes <= (2 << 30),
        )
    finally:
        packed.unlink(missing_ok=True)
    return mr


def _control_series(control_input: str, times: np.ndarray) -> np.ndarray:
    """Build/load the (q, T-1) control series for DMDc.

    Named synthetic forcings are harmonic pairs at the solar periods,
    evaluated at the TRANSITION times (u_k acts on x_k -> x_{k+1}):
    ``diurnal`` = [cos, sin](2 pi t / 24 h), ``seasonal`` the same at
    the tropical-year period.  A path loads a saved series: ``.npy`` or
    ``.h5``/``.hdf5`` with a ``control`` dataset, shaped (q, T-1) or
    (q, T) (the trailing column is dropped) or 1-D of either length.
    """
    t_hours = _hours_since_start(times)[:-1]  # (T-1,)
    if control_input in ("diurnal", "seasonal"):
        period = 24.0 if control_input == "diurnal" else 24.0 * 365.2422
        # absolute phase: hours since epoch so the forcing is a real
        # clock, not relative to the window start
        t64 = times.astype("datetime64[ns]").astype(np.int64)
        abs_hours = (t64[:-1] / 3.6e12).astype(np.float64)
        ang = 2.0 * np.pi * abs_hours / period
        return np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)
    if control_input.endswith(".npy"):
        series = np.load(control_input)
    else:
        import h5py

        with h5py.File(control_input, "r") as f:
            if "control" not in f:
                raise ValueError(
                    f"control file {control_input} has no 'control' dataset"
                )
            series = f["control"][:]
    series = np.asarray(series, dtype=np.float32)
    if series.ndim == 1:
        series = series[None, :]
    n_expected = len(t_hours)
    if series.shape[1] == n_expected + 1:
        series = series[:, :-1]
    if series.shape[1] != n_expected:
        raise ValueError(
            f"control series has {series.shape[1]} columns; need "
            f"{n_expected} (= T-1) or {n_expected + 1} (= T)"
        )
    return series


def _hours_since_start(times: np.ndarray) -> np.ndarray:
    t64 = times.astype("datetime64[ns]").astype(np.int64)
    return ((t64 - t64[0]) / 3.6e12).astype(np.float32)


def fit_dmd_from_svd_results(
    svd_results: FieldSet, parsed_config: dict, mesh=None
) -> FieldSet:
    """Fit (opt)DMD on the SVD factors and package the results."""
    u_field = svd_results["U"]
    u = jnp.asarray(np.asarray(u_field.data, dtype=np.float32))
    s = jnp.asarray(np.asarray(svd_results["s"].data, dtype=np.float32))
    v = jnp.asarray(np.asarray(svd_results["V"].data, dtype=np.float32))
    times = np.asarray(svd_results["V"].coords["time"].values)
    t_hours = _hours_since_start(times)

    rank = parsed_config["dmd_rank"]
    max_iter = parsed_config["lm_max_iter"] if parsed_config["optimized"] else 0
    n_trials = int(parsed_config.get("bagging_trials", 0))
    kind = (
        f"bagged optimized ({n_trials} trials)"
        if n_trials
        else ("optimized" if parsed_config["optimized"] else "exact")
    )
    log_and_print(logger, f"Fitting {kind} DMD at rank {rank}...")
    import time as _time

    t_start = _time.perf_counter()
    bop = None
    if n_trials:
        bop = bopdmd_from_svd(
            u,
            s,
            v,
            jnp.asarray(t_hours),
            rank=rank,
            n_trials=n_trials,
            trial_fraction=parsed_config.get("bagging_fraction", 0.8),
            max_iter=max_iter,
            mesh=mesh,  # EP-shards the bag over the data axis if sharded
        )
        # point estimates for packaging/rollout: the trial means; the
        # full-data fit provides residual/iteration diagnostics
        result = bop.full._replace(
            alpha=bop.eigenvalues,
            modes=bop.modes,
            amplitudes=bop.amplitudes,
        )
    else:
        result = optdmd_from_svd(
            u, s, v, jnp.asarray(t_hours), rank=rank, max_iter=max_iter
        )
    fit_seconds = _time.perf_counter() - t_start
    log_and_print(
        logger,
        f"DMD fit complete: rel residual {float(result.residual):.3e}, "
        f"{int(result.n_iters)} LM iterations, {fit_seconds:.2f}s.",
    )

    rank_coord = Coord("rank", np.arange(rank))
    space_coords = {
        "space": Coord("space", u_field.coords["space"].values),
        "rank": rank_coord,
    }
    for extra in ("original_variable", "delay", "level", "latitude", "longitude"):
        if extra in u_field.coords:
            space_coords[extra] = u_field.coords[extra]

    data_vars: dict[str, Field] = {
        "modes": Field(
            np.asarray(result.modes), ("space", "rank"), space_coords, name="modes"
        ),
        "eigenvalues": Field(
            np.asarray(result.alpha),
            ("rank",),
            {"rank": rank_coord},
            {"units": "1/hour (continuous time)"},
            name="eigenvalues",
        ),
        "amplitudes": Field(
            np.asarray(result.amplitudes),
            ("rank",),
            {"rank": rank_coord},
            name="amplitudes",
        ),
    }
    if bop is not None:
        # bagging uncertainties: per-quantity trial standard deviations
        data_vars["eigenvalues_std"] = Field(
            np.asarray(bop.eigenvalues_std),
            ("rank",),
            {"rank": rank_coord},
            {"units": "1/hour (trial std)"},
            name="eigenvalues_std",
        )
        data_vars["amplitudes_std"] = Field(
            np.asarray(bop.amplitudes_std),
            ("rank",),
            {"rank": rank_coord},
            name="amplitudes_std",
        )
        data_vars["modes_std"] = Field(
            np.asarray(bop.modes_std),
            ("space", "rank"),
            space_coords,
            name="modes_std",
        )

    # ---- optional multiresolution hierarchy (mrDMD) alongside the
    # main fit: per-window fits in the POD subspace (k-sized solves),
    # modes lifted with one batched GEMM against U per level ----
    mr_levels = int(parsed_config.get("multiresolution_levels", 0))
    mr_refit = int(parsed_config.get("mr_refit_rank", 0))
    mr_attrs: dict = {}
    if mr_levels > 0:
        from dmd_era5_tpu.models.mrdmd import fit_mrdmd, mrdmd_from_svd

        dt_hours = float(t_hours[1] - t_hours[0]) if len(t_hours) > 1 else 1.0
        if mr_refit > 0 and "X" in svd_results.data_vars:
            # classic mrDMD: per-window bases refit on the RAW embedded
            # matrix — catches transients outside the global top-k POD
            # subspace (see mrdmd_from_svd's approximation note)
            log_and_print(
                logger,
                f"Fitting {mr_levels}-level multiresolution DMD "
                f"(raw-data refit at rank {mr_refit})...",
            )
            x_raw = jnp.asarray(
                np.asarray(svd_results["X"].data, dtype=np.float32)
            )
            mr = fit_mrdmd(
                x_raw,
                dt=dt_hours,
                rank=mr_refit,
                max_levels=mr_levels,
                max_cycles=parsed_config.get("mr_max_cycles", 1.0),
            )
        elif mr_refit > 0:
            # no X in the artifact: stream the raw refit out-of-core —
            # the embedded matrix is re-packed from the slice artifact
            # to disk (d delay slabs, no host-RAM embedding) and the
            # whole hierarchy comes from ONE streamed Gram pass
            # (models.mrdmd.fit_mrdmd_streamed; review r4 item 7 —
            # save_data_matrix=True is no longer required)
            log_and_print(
                logger,
                f"Fitting {mr_levels}-level multiresolution DMD "
                f"(streamed raw refit at rank {mr_refit}; no X in "
                "artifact)...",
            )
            mr = _mr_refit_streamed(
                parsed_config, dt_hours, mr_levels, mr_refit
            )
        else:
            log_and_print(
                logger, f"Fitting {mr_levels}-level multiresolution DMD..."
            )
            mr = mrdmd_from_svd(
                u,
                s,
                v,
                dt=dt_hours,
                rank=rank,
                max_levels=mr_levels,
                max_cycles=parsed_config.get("mr_max_cycles", 1.0),
            )
        # per-window rank: dmd_rank for the subspace fit, mr_refit_rank
        # for the raw refit — its own dim so the two never conflate
        mr_rank_coord = Coord(
            "mr_rank", np.arange(mr.levels[0].omega.shape[1])
        )
        for lv in mr.levels:
            n_win = lv.omega.shape[0]
            win_coord = Coord(f"window_L{lv.level}", np.arange(n_win))
            lvl_coords = {
                f"window_L{lv.level}": win_coord,
                "mr_rank": mr_rank_coord,
            }
            data_vars[f"mr_eigenvalues_L{lv.level}"] = Field(
                lv.omega,
                (f"window_L{lv.level}", "mr_rank"),
                lvl_coords,
                {"units": "1/hour (continuous time)"},
                name=f"mr_eigenvalues_L{lv.level}",
            )
            data_vars[f"mr_amplitudes_L{lv.level}"] = Field(
                lv.amplitudes,
                (f"window_L{lv.level}", "mr_rank"),
                lvl_coords,
                name=f"mr_amplitudes_L{lv.level}",
            )
            data_vars[f"mr_slow_mask_L{lv.level}"] = Field(
                lv.slow_mask.astype(np.int8),
                (f"window_L{lv.level}", "mr_rank"),
                lvl_coords,
                {"description": "true |omega|<=rho criterion per level"},
                name=f"mr_slow_mask_L{lv.level}",
            )
            data_vars[f"mr_kept_mask_L{lv.level}"] = Field(
                (
                    lv.kept_mask
                    if lv.kept_mask is not None
                    else lv.slow_mask
                ).astype(np.int8),
                (f"window_L{lv.level}", "mr_rank"),
                lvl_coords,
                {
                    "description": "modes with amplitudes kept (all-True"
                    " at the finest level, which absorbs the remainder)"
                },
                name=f"mr_kept_mask_L{lv.level}",
            )
            if lv.modes is not None:
                data_vars[f"mr_modes_L{lv.level}"] = Field(
                    lv.modes,
                    (f"window_L{lv.level}", "space", "mr_rank"),
                    {**lvl_coords, "space": space_coords["space"]},
                    name=f"mr_modes_L{lv.level}",
                )
            if lv.mode_map is not None:
                # Gram-route compact mode factors: Phi_w = X @ map[w]
                # (unit columns) — S-free, lets consumers materialize
                # any window's modes blockwise from the raw snapshots
                map_time = Coord("mr_map_time", np.arange(mr.t_used))
                data_vars[f"mr_mode_map_L{lv.level}"] = Field(
                    lv.mode_map,
                    (f"window_L{lv.level}", "mr_map_time", "mr_rank"),
                    {**lvl_coords, "mr_map_time": map_time},
                    {
                        "description": "time-side mode factors: "
                        "modes = X[:, :mr_t_used] @ map (unit columns)"
                    },
                    name=f"mr_mode_map_L{lv.level}",
                )
        if mr_refit > 0 and mr.x_fro is not None:
            ref_norm = float(mr.x_fro)  # Gram-route: sqrt(tr(Gx)), no X
        elif mr_refit > 0:
            ref_norm = float(
                np.linalg.norm(np.asarray(x_raw)[:, : mr.t_used])
            )
        else:
            ref_norm = float(
                np.linalg.norm(
                    np.asarray(s)[:, None] * np.asarray(v)[:, : mr.t_used]
                )
            )
        res_fro = (
            mr.residual_fro
            if mr.residual_fro is not None
            else float(np.linalg.norm(mr.residual))
        )
        mr_attrs["multiresolution_residual"] = float(
            res_fro / max(ref_norm, 1e-30)
        )
        mr_attrs["mr_refit_rank"] = mr_refit
        mr_attrs["mr_max_cycles"] = float(
            parsed_config.get("mr_max_cycles", 1.0)
        )
        mr_attrs["mr_t_used"] = int(mr.t_used)

    # ---- optional DMD-with-control fit (Proctor/Brunton/Kutz DMDc)
    # alongside the main decomposition: disambiguates internal dynamics
    # A from the effect of a measured forcing B u (models/dmdc.py; an
    # extension beyond /root/reference/README.md:85,139) ----
    control_input = parsed_config.get("control_input", "none")
    if control_input != "none":
        from dmd_era5_tpu.models.dmdc import dmdc_from_svd

        u_ctrl = _control_series(control_input, times)  # (q, T-1)
        q_ctrl = u_ctrl.shape[0]
        dt_hours = (
            float(t_hours[1] - t_hours[0]) if len(t_hours) > 1 else 1.0
        )
        log_and_print(
            logger,
            f"Fitting DMDc (control='{control_input}', q={q_ctrl}) "
            f"at rank {rank}...",
        )
        dmdc_res = dmdc_from_svd(
            u,
            s,
            v,
            jnp.asarray(u_ctrl),
            rank=rank,
            rank_omega=parsed_config.get("dmdc_rank_omega"),
            dt=dt_hours,
            mesh=mesh,
        )
        ctrl_coord = Coord("control", np.arange(q_ctrl))
        rank_in_coord = Coord("rank_in", np.arange(rank))
        data_vars["dmdc_eigenvalues"] = Field(
            dmdc_res.omega,
            ("rank",),
            {"rank": rank_coord},
            {"units": "1/hour (continuous time)"},
            name="dmdc_eigenvalues",
        )
        data_vars["dmdc_modes"] = Field(
            np.asarray(dmdc_res.modes),
            ("space", "rank"),
            space_coords,
            name="dmdc_modes",
        )
        data_vars["dmdc_a_red"] = Field(
            np.asarray(dmdc_res.a_red),
            ("rank", "rank_in"),
            {"rank": rank_coord, "rank_in": rank_in_coord},
            {"description": "reduced unforced operator U^T A U"},
            name="dmdc_a_red",
        )
        data_vars["dmdc_b_red"] = Field(
            np.asarray(dmdc_res.b_red),
            ("rank", "control"),
            {"rank": rank_coord, "control": ctrl_coord},
            {"description": "reduced input map U^T B"},
            name="dmdc_b_red",
        )
        data_vars["dmdc_control"] = Field(
            u_ctrl,
            ("control", "time_ctrl"),
            {
                "control": ctrl_coord,
                "time_ctrl": Coord("time_ctrl", times[:-1]),
            },
            {"description": f"control series used ({control_input})"},
            name="dmdc_control",
        )
        mr_attrs["control_input"] = control_input
        mr_attrs["dmdc_residual"] = float(dmdc_res.residual)
        log_and_print(
            logger,
            f"DMDc fit complete: one-step residual "
            f"{dmdc_res.residual:.3e}.",
        )

    # ---- forecast verification on the withheld holdout window ----
    # Fit used only the train columns (the SVD stage withheld the tail,
    # including from the standardization statistics); here the modes
    # roll PAST the train window and the physical-unit fields are
    # scored against the raw withheld truth — latitude-weighted RMSE /
    # ACC / bias per lead time, plus the persistence no-skill baseline.
    holdout = int(parsed_config.get("forecast_holdout", 0))
    if holdout > 0 and "holdout_truth" in svd_results.data_vars:
        from dmd_era5_tpu.models.forecast import streamed_forecast_scores
        from dmd_era5_tpu.models.verification import (
            ScoreAccumulator,
            _space_weights,
        )

        truth_field = svd_results["holdout_truth"]
        truth = np.asarray(truth_field.data, dtype=np.float32)  # (S, h)
        persist = np.asarray(
            svd_results["holdout_persistence"].data, dtype=np.float32
        )  # (S,)
        dt_hours = (
            float(t_hours[1] - t_hours[0]) if len(t_hours) > 1 else 1.0
        )
        # lead times only: the rollout columns are independent, so the
        # scorer never evaluates (or stores) the training-window
        # reconstruction — and the model/undo/score chain streams in
        # row blocks (O(block) device + O(S*h) host residency; the
        # previous one-shot path materialized the dense (S*d, T+h)
        # rollout, ~12 GB at the 0.25-degree-week shape)
        t_lead = (
            t_hours[-1] + dt_hours * np.arange(1, holdout + 1)
        ).astype(np.float32)
        mean_h = std_h = None
        if "X_mean" in svd_results:
            mean_h = np.asarray(svd_results["X_mean"].data, dtype=np.float32)
        if "X_std" in svd_results:
            std_h = np.asarray(svd_results["X_std"].data, dtype=np.float32)
        d_embed = int(parsed_config["delay_embedding"])
        lat_rows = truth_field.coords["latitude_out"].values
        scores = streamed_forecast_scores(
            result, t_lead, truth, latitudes=lat_rows,
            mean=mean_h, std=std_h, delay=d_embed,
        )
        # persistence baseline: same blockwise-exact accumulators
        w_rows = np.asarray(_space_weights(lat_rows, truth.shape[0]))
        acc_p = ScoreAccumulator()
        blk_p = max(4096, (1 << 26) // max(holdout, 1))
        for s0 in range(0, truth.shape[0], blk_p):
            s1 = min(s0 + blk_p, truth.shape[0])
            acc_p.update(
                np.repeat(persist[s0:s1, None], holdout, axis=1),
                truth[s0:s1],
                w_rows[s0:s1],
            )
        persist_scores = acc_p.finalize()
        mr_attrs["forecast_holdout"] = holdout
        for key in ("rmse", "acc", "bias"):
            mr_attrs[f"forecast_{key}"] = [
                float(x) for x in scores[key]
            ]
            mr_attrs[f"persistence_{key}"] = [
                float(x) for x in persist_scores[key]
            ]
        log_and_print(
            logger,
            "Holdout verification over "
            f"{holdout} leads: RMSE {scores['rmse'][0]:.3f} -> "
            f"{scores['rmse'][-1]:.3f} (persistence "
            f"{persist_scores['rmse'][0]:.3f} -> "
            f"{persist_scores['rmse'][-1]:.3f}), "
            f"ACC {scores['acc'][0]:.3f} -> {scores['acc'][-1]:.3f}.",
        )

    # ---- optional forecast rollout beyond the training window ----
    n_future = parsed_config["forecast_steps"]
    if n_future > 0:
        from dmd_era5_tpu.models.forecast import iter_forecast_blocks

        dt_hours = float(t_hours[1] - t_hours[0]) if len(t_hours) > 1 else 1.0
        t_all = np.concatenate(
            [t_hours, t_hours[-1] + dt_hours * np.arange(1, n_future + 1)]
        ).astype(np.float32)

        mean = std = None
        if "X_mean" in svd_results:
            mean = np.asarray(svd_results["X_mean"].data, dtype=np.float32)
        if "X_std" in svd_results:
            std = np.asarray(svd_results["X_std"].data, dtype=np.float32)
        d = int(parsed_config["delay_embedding"])
        # blockwise rollout straight into the output array: the dense
        # (S*d, T+F) embedded reconstruction never materializes — host
        # residency is the (S, T+F) artifact payload itself
        n_space = (
            np.asarray(result.modes).shape[0] // d
            if d > 1
            else np.asarray(result.modes).shape[0]
        )
        fields = np.empty((n_space, len(t_all)), np.float32)
        for s0, blk in iter_forecast_blocks(
            result, t_all, mean, std, delay=d
        ):
            fields[s0 : s0 + blk.shape[0]] = blk
        delta = times[1] - times[0] if len(times) > 1 else np.timedelta64(1, "h")
        times_all = np.concatenate(
            [times, times[-1] + delta * np.arange(1, n_future + 1)]
        )
        # dim/coords are named space_out: the forecast covers only the
        # undelayed rows (delay-0 block), a different size than the
        # embedded space axis of the modes
        forecast_coords = {
            "space_out": Coord(
                "space_out", u_field.coords["space"].values[-n_space:]
            ),
            "time_out": Coord("time_out", times_all),
        }
        for extra in ("original_variable", "level", "latitude", "longitude"):
            if extra in u_field.coords:
                forecast_coords[f"{extra}_out"] = Coord(
                    "space_out", u_field.coords[extra].values[-n_space:]
                )
        data_vars["forecast"] = Field(
            np.asarray(fields),
            ("space_out", "time_out"),
            forecast_coords,
            name="forecast",
        )

    out = FieldSet(data_vars, attrs=dict(svd_results.attrs))
    out.attrs["dmd_rank"] = rank
    out.attrs["optimized"] = int(parsed_config["optimized"])
    out.attrs["bagging_trials"] = n_trials
    out.attrs["multiresolution_levels"] = mr_levels
    out.attrs["control_input"] = control_input
    out.attrs.update(mr_attrs)
    if bop is not None:
        # diverged trials are dropped by the bag; record the survivors
        out.attrs["bagging_trials_used"] = int(len(bop.trial_eigenvalues))
    out.attrs["forecast_steps"] = n_future
    out.attrs["dmd_residual"] = float(result.residual)
    out.attrs["lm_iterations"] = int(result.n_iters)
    out.attrs["dmd_seconds"] = round(fit_seconds, 4)
    out.attrs["date_processed"] = datetime.now().isoformat()
    return out


def main(
    config: dict | None = None,
    write_artifact: bool = False,
    use_store: bool = False,
    mesh=None,
) -> tuple[FieldSet, bool, bool]:
    """DMD stage orchestration: cache ladder -> SVD stage -> fit."""
    if config is None:
        config = config_reader("era5-dmd")
    added_to_store = False
    parsed_config = config_parser(config, "era5-dmd")

    try:
        dmd_results, retrieved_from_store = retrieve_dmd_results(
            parsed_config, use_store
        )
    except Exception as err:
        msg = f"Error retrieving DMD results: {err}"
        log_and_print(logger, msg, "error")
        raise Exception(msg) from err

    if dmd_results is None:
        try:
            svd_results, _, _ = era5_svd.main(
                config, write_artifact=write_artifact, use_store=use_store,
                mesh=mesh,
            )
        except Exception as err:
            msg = f"Error obtaining SVD results for DMD: {err}"
            log_and_print(logger, msg, "error")
            raise Exception(msg) from err

        try:
            dmd_results = fit_dmd_from_svd_results(
                svd_results, parsed_config, mesh=mesh
            )
        except Exception as err:
            msg = f"Error in the DMD fit: {err}"
            log_and_print(logger, msg, "error")
            raise Exception(msg) from err

        if write_artifact:
            try:
                save_fieldset(dmd_results, parsed_config["save_path"])
                log_and_print(
                    logger, f"DMD results written to {parsed_config['save_path']}"
                )
            except Exception as err:
                msg = f"Error writing DMD results: {err}"
                log_and_print(logger, msg, "error")
                raise Exception(msg) from err
            if use_store:
                try:
                    add_data_to_store(parsed_config["save_path"], dmd_results.attrs)
                    added_to_store = True
                except Exception as err:
                    msg = f"Error versioning DMD results: {err}"
                    log_and_print(logger, msg, "error")
                    raise Exception(msg) from err

    return dmd_results, added_to_store, retrieved_from_store


if __name__ == "__main__":
    main(write_artifact=True, use_store=True)
