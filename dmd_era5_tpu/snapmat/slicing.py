"""Time/level slicing and resampling of ERA5-like FieldSets.

Capability parity with the reference slice tools
(/root/reference/src/dmd_era5/slice_tools/slice_tools.py:20-141):
``slice_era5_dataset`` selects a time range and pressure levels with
bounds validation; ``resample_era5_dataset`` performs nearest-neighbor
time resampling.  These run on host metadata + cheap indexing — the heavy
array work downstream is device-side.
"""

from __future__ import annotations

from datetime import datetime, timedelta

import numpy as np

from dmd_era5_tpu.core.logging import log_and_print, setup_logger
from dmd_era5_tpu.utils.labels import FieldSet

logger = setup_logger("ERA5Processing", "era5_processing.log")


def _to_datetime(value: datetime | str | None) -> datetime | None:
    if isinstance(value, str):
        return datetime.fromisoformat(value)
    return value


def _times_of(fs: FieldSet) -> np.ndarray:
    return np.asarray(fs.coord("time").values)


def dataset_time_bounds(fs: FieldSet) -> tuple[datetime, datetime]:
    """First/last timestamps of the FieldSet as python datetimes."""
    times = _times_of(fs).astype("datetime64[us]")
    return times[0].item(), times[-1].item()


def slice_era5_dataset(
    fs: FieldSet,
    start_datetime: datetime | str | None = None,
    end_datetime: datetime | str | None = None,
    levels: list[int] | None = None,
) -> FieldSet:
    """Select a time range (inclusive) and a set of pressure levels.

    Raises ValueError if the requested range is outside the data bounds,
    if start >= end, or if a requested level is absent — matching the
    reference validation (slice_tools.py:60-103).
    """
    start_dt = _to_datetime(start_datetime)
    end_dt = _to_datetime(end_datetime)
    first, last = dataset_time_bounds(fs)
    start_dt = start_dt or first
    end_dt = end_dt or last

    if start_dt < first or end_dt > last:
        msg = (
            f"Time range ({start_dt} to {end_dt}) is outside dataset "
            f"bounds ({first} to {last})."
        )
        log_and_print(logger, msg, "error")
        raise ValueError(msg)
    if start_dt >= end_dt:
        msg = "Start datetime must be before end datetime."
        log_and_print(logger, msg, "error")
        raise ValueError(msg)

    times = _times_of(fs)
    t64_start = np.datetime64(start_dt)
    t64_end = np.datetime64(end_dt)
    time_mask = (times >= t64_start) & (times <= t64_end)
    time_idx = np.nonzero(time_mask)[0]

    out = fs.isel(time=time_idx)

    level_values = np.asarray(fs.coord("level").values)
    if levels is None:
        levels = [int(v) for v in level_values]
    level_idx = []
    for lev in levels:
        hits = np.nonzero(level_values == lev)[0]
        if hits.size == 0:
            msg = (
                "Requested level is not available in the dataset. "
                f"Available levels: {[int(v) for v in level_values]}"
            )
            log_and_print(logger, msg, "error")
            raise ValueError(msg)
        level_idx.append(int(hits[0]))
    out = out.isel(level=np.asarray(level_idx))

    log_and_print(
        logger,
        f"Dataset slicing completed successfully using {start_dt} "
        f"to {end_dt} and levels {levels}",
    )
    return out


def resample_era5_dataset(fs: FieldSet, delta_time: timedelta) -> FieldSet:
    """Nearest-neighbor resampling along time at a fixed stride.

    Matches the behavior of the reference's
    ``ds.resample(time=delta).nearest()`` for regularly sampled inputs
    (slice_tools.py:126-141): target timestamps are laid out from the
    first sample at ``delta_time`` intervals and each is mapped to the
    nearest source snapshot.
    """
    times = _times_of(fs)
    src = times.astype("datetime64[ns]").astype(np.int64)
    step = np.timedelta64(delta_time).astype("timedelta64[ns]").astype(np.int64)
    tgt = np.arange(src[0], src[-1] + 1, step)  # end inclusive
    pos = np.searchsorted(src, tgt)
    pos = np.clip(pos, 0, len(src) - 1)
    left = np.clip(pos - 1, 0, len(src) - 1)
    choose_left = np.abs(tgt - src[left]) <= np.abs(src[pos] - tgt)
    idx = np.where(choose_left, left, pos)

    out = fs.isel(time=idx)
    log_and_print(logger, f"Resampled the dataset with time delta: {delta_time}")
    return out
