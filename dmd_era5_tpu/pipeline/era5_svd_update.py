"""Incremental decomposition stage: extend an SVD artifact in place.

North-star config 5 (BASELINE.json): "streaming/updating rank-k SVD
with versioned incremental snapshots" — the pipeline form of
``pipeline.incremental.update_svd_results``.  Config-driven like the
other stages (reads the ``era5-svd`` section; run as
``python -m dmd_era5_tpu.pipeline.era5_svd_update``):

1. retrieve the existing SVD artifact (workdir -> store ladder, same
   matchers as pipeline.era5_svd);
2. retrieve the ERA5 slice covering the extended window;
3. select the strictly-new snapshots PLUS the d-1 boundary columns the
   delay embedding needs (handled here — callers never reason about
   the overlap), preprocessed with the ORIGINAL window's statistics
   from the artifact;
4. rank-update the factorization (ops.streaming.svd_rank_update — the
   history is never refactorized) and write/version the result.

The reference has no incremental path at all — its era5_svd stage
recomputes from scratch for every window (/root/reference/src/
dmd_era5/era5_svd/era5_svd.py:336-452); this stage is the
extension that makes rolling ERA5 updates O(new columns).
"""

from __future__ import annotations

import numpy as np

from dmd_era5_tpu.core import config_parser, config_reader, log_and_print, setup_logger
from dmd_era5_tpu.pipeline.artifacts import (
    add_data_to_store,
    retrieve_latest_from_store,
)
from dmd_era5_tpu.pipeline.era5_svd import (
    retrieve_era5_slice,
    retrieve_svd_results,
)
from dmd_era5_tpu.utils.io_h5 import load_fieldset
from dmd_era5_tpu.pipeline.incremental import update_svd_results
from dmd_era5_tpu.snapmat import resample_era5_dataset, slice_era5_dataset
from dmd_era5_tpu.utils.io_h5 import save_fieldset
from dmd_era5_tpu.utils.labels import FieldSet

logger = setup_logger("ERA5-SVD-Update", "era5_svd_update.log")

__all__ = ["select_new_snapshots", "main"]


def select_new_snapshots(
    era5_slice: FieldSet, svd_results: FieldSet
) -> FieldSet | None:
    """Columns of the slice not yet in the artifact, plus the d-1
    boundary snapshots the delay embedding needs.

    The artifact's V carries the embedded-window timestamps; a window
    straddling the old boundary ends strictly after it, so the raw
    columns required start d-1 samples BEFORE the first new one.
    Returns None when the slice adds nothing.
    """
    d = int(svd_results.attrs["delay_embedding"])
    covered = np.asarray(
        svd_results["V"].coords["time"].values, dtype="datetime64[ns]"
    )
    times = np.asarray(
        era5_slice.coord("time").values, dtype="datetime64[ns]"
    )
    n_new = int(np.sum(times > covered[-1]))
    if n_new == 0:
        return None
    first = len(times) - n_new - (d - 1)
    if first < 0:
        raise ValueError(
            "ERA5 slice does not contain the d-1 boundary snapshots "
            f"before {times[len(times) - n_new]} (need {d - 1})."
        )
    return era5_slice.isel(time=np.arange(first, len(times)))


def main(
    config: dict | None = None,
    write_artifact: bool = False,
    use_store: bool = False,
) -> tuple[FieldSet, bool, bool]:
    """Incremental-update orchestration.

    Returns (svd_results, added_to_store, updated) — ``updated`` False
    means the artifact already covered the requested window.
    """
    if config is None:
        config = config_reader("era5-svd")
    parsed_config = config_parser(config, "era5-svd")
    added_to_store = False

    svd_results, _ = retrieve_svd_results(parsed_config, use_store)
    if svd_results is None and use_store:
        # the extended window's derived filename differs from the base
        # window's, so the per-path ladder misses — scan the store for
        # the newest artifact of the same (source, variables, levels,
        # preprocessing) regardless of time range
        try:
            path = retrieve_latest_from_store(parsed_config, "era5_svd")
            svd_results = load_fieldset(path)
            log_and_print(
                logger, f"Base artifact for the update: {path}"
            )
        except (ValueError, FileNotFoundError) as err:
            log_and_print(
                logger, f"Store scan found no base artifact: {err}",
                "warning",
            )
    if svd_results is None:
        msg = (
            "No existing SVD artifact to update — run pipeline.era5_svd "
            "first (incremental updates extend a previous window)."
        )
        log_and_print(logger, msg, "error")
        raise FileNotFoundError(msg)

    era5_slice, _ = retrieve_era5_slice(parsed_config, use_store)
    if era5_slice is None:
        msg = "Could not retrieve the ERA5 slice for the extended window."
        log_and_print(logger, msg, "error")
        raise FileNotFoundError(msg)

    # same preprocessing chain as the fit stage, EXCEPT standardization:
    # the new columns must use the original window's statistics, which
    # update_svd_results applies from the artifact's X_mean/X_std
    ds = era5_slice[parsed_config["variables"]]
    ds = slice_era5_dataset(ds, levels=parsed_config["levels"])
    ds = resample_era5_dataset(ds, parsed_config["delta_time"])

    new_slice = select_new_snapshots(ds, svd_results)
    if new_slice is None:
        log_and_print(
            logger,
            "Artifact already covers the requested window; nothing to do.",
        )
        return svd_results, False, False

    updated = update_svd_results(
        svd_results, new_slice, n_components=parsed_config["n_components"]
    )

    if write_artifact:
        save_fieldset(updated, parsed_config["save_path"])
        log_and_print(
            logger,
            f"Updated SVD results written to {parsed_config['save_path']}",
        )
        if use_store:
            add_data_to_store(parsed_config["save_path"], updated.attrs)
            added_to_store = True
            log_and_print(logger, "Updated SVD results versioned.")

    return updated, added_to_store, True


if __name__ == "__main__":
    main(write_artifact=True, use_store=True)
