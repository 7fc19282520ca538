"""ERA5 ingest from a Zarr v2 store (local path or gs:// URL).

Replaces the reference's xarray/dask lazy-open of ARCO-ERA5
(/root/reference/src/dmd_era5/era5_download/era5_download.py:81-101)
with explicit **slice pushdown**: the requested time range and pressure
levels are converted to index ranges against the (small, eagerly read)
coordinate arrays, and only the covering chunks of each requested
variable are fetched and decoded — the reader never touches the rest of
the multi-TB store.  Two consumers:

- :func:`read_era5_zarr_slice` materializes the slice as a FieldSet for
  the standard ingest stage (the ``to_netcdf`` moment in the reference,
  era5_download.py:114, where dask lazily-downloaded data lands in RAM);
- :func:`zarr_to_packed` streams time-chunk blocks straight through the
  native packer into the row-chunked packed snapshot artifact
  (snapmat/loader.py) without ever holding the full slice in host RAM —
  the scalable path feeding the streamed/out-of-core SVD backends.
"""

from __future__ import annotations

from datetime import datetime
from pathlib import Path

import numpy as np

from dmd_era5_tpu.core.logging import log_and_print, setup_logger
from dmd_era5_tpu.snapmat.zarr_reader import (
    ZarrGroup,
    decode_cf_time,
    open_zarr_group,
)
from dmd_era5_tpu.utils.labels import Coord, Field, FieldSet

logger = setup_logger("ERA5Zarr", "era5_zarr.log")

__all__ = ["read_era5_zarr_slice", "zarr_to_packed", "open_era5_zarr"]

_DIMS = ("time", "level", "latitude", "longitude")


def open_era5_zarr(source: str | Path) -> ZarrGroup:
    return open_zarr_group(source)


def _read_time_coord(group: ZarrGroup) -> np.ndarray:
    arr = group["time"]
    values = arr[:]
    units = arr.attrs.get("units")
    if values.dtype.kind == "M":
        return values.astype("datetime64[ns]")
    if units is None:
        raise ValueError(
            "Zarr time coordinate has no CF 'units' attribute and is not "
            "datetime-typed."
        )
    return decode_cf_time(values, units)


def _index_bounds(
    times: np.ndarray, start: datetime, end: datetime
) -> tuple[int, int]:
    """[t0, t1) index range covering the inclusive [start, end] window."""
    t64 = times.astype("datetime64[ns]")
    s64 = np.datetime64(start, "ns")
    e64 = np.datetime64(end, "ns")
    if s64 < t64[0] or e64 > t64[-1]:
        raise ValueError(
            f"Time range ({start} to {end}) is outside dataset bounds "
            f"({t64[0]} to {t64[-1]})."
        )
    t0 = int(np.searchsorted(t64, s64, side="left"))
    t1 = int(np.searchsorted(t64, e64, side="right"))
    if t1 <= t0:
        raise ValueError(f"Empty time selection for {start}..{end}")
    return t0, t1


def _level_indices(level_values: np.ndarray, levels: list[int]) -> np.ndarray:
    idx = []
    for lev in levels:
        hits = np.nonzero(level_values == lev)[0]
        if hits.size == 0:
            raise ValueError(
                "Requested level is not available in the dataset. "
                f"Available levels: {[int(v) for v in level_values]}"
            )
        idx.append(int(hits[0]))
    return np.asarray(idx)


def _var_axis_order(arr) -> list[int]:
    """Map the on-store dim order to the canonical (_DIMS) order."""
    dims = arr.dims
    if dims is None:
        if arr.ndim != 4:
            raise ValueError(
                f"Variable {arr.path!r} has no _ARRAY_DIMENSIONS and is "
                f"{arr.ndim}-D; cannot infer layout."
            )
        return list(range(4))
    if sorted(dims) != sorted(_DIMS):
        raise ValueError(
            f"Variable {arr.path!r} has dims {dims}, expected {_DIMS}"
        )
    return [dims.index(d) for d in _DIMS]


def read_era5_zarr_slice(
    source: str | Path,
    variables: list[str],
    start_datetime: datetime,
    end_datetime: datetime,
    levels: list[int] | None = None,
) -> FieldSet:
    """Materialize an ERA5 slice from a Zarr store as a FieldSet.

    Only the chunks covering [start, end] x levels are read.  The result
    carries the same (time, level, latitude, longitude) layout as the
    mock backend, so the downstream slice/resample/flatten chain is
    source-agnostic.
    """
    group = open_era5_zarr(source)
    available = group.array_keys()
    for var in variables:
        if var not in available:
            raise ValueError(
                f"Variable {var!r} not present in Zarr store "
                f"(has: {available})"
            )

    times = _read_time_coord(group)
    level_values = np.asarray(group["level"][:])
    lats = np.asarray(group["latitude"][:])
    lons = np.asarray(group["longitude"][:])

    t0, t1 = _index_bounds(times, start_datetime, end_datetime)
    levels = levels or [int(v) for v in level_values]
    lev_idx = _level_indices(level_values, levels)

    coords = {
        "time": Coord("time", times[t0:t1]),
        "level": Coord("level", level_values[lev_idx].astype(int)),
        "latitude": Coord("latitude", lats),
        "longitude": Coord("longitude", lons),
    }

    data_vars: dict[str, Field] = {}
    for var in variables:
        arr = group[var]
        order = _var_axis_order(arr)
        sel: list = [slice(None)] * 4
        sel[order[0]] = slice(t0, t1)
        sel[order[1]] = lev_idx
        block = arr[tuple(sel)]
        block = np.transpose(block, order)  # store order -> canonical
        block = np.ascontiguousarray(block.astype(np.float32))
        data_vars[var] = Field(
            block,
            dims=_DIMS,
            coords=coords,
            attrs={
                k: v
                for k, v in arr.attrs.items()
                if k != "_ARRAY_DIMENSIONS"
            },
            name=var,
        )
    log_and_print(
        logger,
        f"Read ERA5 Zarr slice: {len(variables)} var(s), "
        f"times[{t0}:{t1}], {len(lev_idx)} level(s) from {source}",
    )
    return FieldSet(data_vars, attrs=dict(group.attrs))


def zarr_to_packed(
    source: str | Path,
    out_path: str | Path,
    variables: list[str],
    start_datetime: datetime,
    end_datetime: datetime,
    levels: list[int] | None = None,
    bf16: bool = False,
    row_chunk: int = 4096,
) -> tuple[int, int]:
    """Stream a Zarr ERA5 slice into a packed (space, time) artifact.

    Chunk-by-chunk: for each variable, time-chunk-aligned blocks are
    read, transposed space-major by the native packer, and written as
    column slabs of the packed HDF5 — peak host memory is one time
    chunk per variable, independent of the slice length.  The output is
    identical to ``build_snapshot_matrix`` + ``save_packed_snapshot``
    on the materialized slice and feeds ``load_row_sharded`` /
    ``streamed_randomized_svd`` directly.

    Returns (n_rows, n_cols) of the packed matrix.
    """
    import h5py

    from dmd_era5_tpu.native import pack_space_time

    group = open_era5_zarr(source)
    times = _read_time_coord(group)
    level_values = np.asarray(group["level"][:])
    lats = np.asarray(group["latitude"][:])
    lons = np.asarray(group["longitude"][:])

    t0, t1 = _index_bounds(times, start_datetime, end_datetime)
    levels = levels or [int(v) for v in level_values]
    lev_idx = _level_indices(level_values, levels)

    n_space_var = len(lev_idx) * len(lats) * len(lons)
    n_rows = n_space_var * len(variables)
    n_cols = t1 - t0
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)

    dtype = np.uint16 if bf16 else np.float32
    with h5py.File(out_path, "w") as f:
        dset = f.create_dataset(
            "X",
            shape=(n_rows, n_cols),
            dtype=dtype,
            chunks=(min(row_chunk, n_rows), min(n_cols, 512)),
        )
        f.attrs["bf16"] = int(bf16)
        f.create_dataset(
            "variables",
            data=np.asarray(variables, dtype=h5py.string_dtype()),
        )
        f.create_dataset("levels", data=level_values[lev_idx].astype(int))
        f.create_dataset("latitudes", data=lats)
        f.create_dataset("longitudes", data=lons)
        f.create_dataset(
            "times",
            data=times[t0:t1].astype("datetime64[ns]").astype(np.int64),
        )

        for vi, var in enumerate(variables):
            arr = group[var]
            order = _var_axis_order(arr)
            time_axis = order[0]
            r0 = vi * n_space_var
            for b0, b1 in arr.iter_axis_blocks(time_axis, t0, t1):
                sel: list = [slice(None)] * 4
                sel[time_axis] = slice(b0, b1)
                sel[order[1]] = lev_idx
                block = arr[tuple(sel)]
                block = np.transpose(block, order)  # -> canonical order
                tb = b1 - b0
                flat = np.ascontiguousarray(
                    block.astype(np.float32).reshape(tb, -1)
                )
                packed = pack_space_time(flat, bf16=bf16)  # (S_var, tb)
                dset[r0 : r0 + n_space_var, b0 - t0 : b1 - t0] = packed
    log_and_print(
        logger,
        f"Packed ERA5 Zarr slice to {out_path}: {n_rows} x {n_cols} "
        f"({'bf16' if bf16 else 'f32'})",
    )
    return n_rows, n_cols
