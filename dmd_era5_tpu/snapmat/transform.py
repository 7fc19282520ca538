"""Snapshot-matrix construction: standardize, flatten, delay-embed.

These reproduce the numerical semantics of the reference array toolkit
(/root/reference/src/dmd_era5/slice_tools/slice_tools.py:144-414) on our
:class:`Field`/:class:`FieldSet` containers, with the delay embedding
reformulated as d shifted column-views of the snapshot matrix instead of
a materialized ``sliding_window_view`` Hankel copy — the form the fused
operators consume (see dmd_era5_tpu.ops.hankel).

Layout contract (load-bearing for every consumer downstream):
- flatten stacks space as (level, latitude, longitude), row-major, and
  concatenates variables along space (slice_tools.py:311,323-336);
- delay embedding with depth d maps (S, T) -> (S*d, T-d+1); row block
  j in [0, d) holds columns X[:, j : j+T-d+1] and carries delay index
  d-1-j; the time coordinate drops the first d-1 entries
  (slice_tools.py:182-274).
"""

from __future__ import annotations

from itertools import product
from typing import Any

import numpy as np

from dmd_era5_tpu.core.logging import log_and_print, setup_logger
from dmd_era5_tpu.utils.labels import Coord, Field, FieldSet

logger = setup_logger("ERA5Processing", "era5_processing.log")

SPATIAL_STACK_ORDER = ("level", "latitude", "longitude")


def standardize_data(
    data: FieldSet | Field,
    dim: str = "time",
    scale: bool = True,
):
    """Mean-center (and optionally scale to unit variance) along ``dim``.

    Returns ``(standardized, mean, std_or_None)`` exactly like the
    reference (slice_tools.py:144-179).
    """
    log_and_print(logger, f"Standardizing data along {dim} dimension...")
    mean = data.mean(dim)
    centered = data - mean
    if scale:
        std = centered.std(dim)
        return centered / std, mean, std
    return centered, mean, None


def _space_tuples(level: np.ndarray, lat: np.ndarray, lon: np.ndarray) -> np.ndarray:
    """Object array of (level, lat, lon) tuples in stack order."""
    tuples = np.empty(len(level) * len(lat) * len(lon), dtype=object)
    for i, combo in enumerate(product(level, lat, lon)):
        tuples[i] = combo
    return tuples


def flatten_era5_variables(fs: FieldSet) -> Field:
    """Flatten an ERA5 FieldSet into one (space[, time]) Field.

    Space is the row-major stack of (level, latitude, longitude); when
    multiple variables are present their blocks are concatenated along
    space, first variable first.  The result carries coords ``space``
    (tuples), ``time`` (if present) and ``original_variable`` — matching
    the reference contract (slice_tools.py:277-365).
    """
    variables = fs.variables
    if not variables:
        raise ValueError("Input dataset must have at least one variable.")

    sample = fs.first()
    has_time = "time" in sample.dims
    for d in SPATIAL_STACK_ORDER:
        if d not in sample.dims:
            raise ValueError(
                "Input dataset must have coordinates "
                "('latitude', 'longitude', 'level') "
                "or ('latitude', 'longitude', 'level', 'time')."
            )

    level = np.asarray(fs.coord("level").values)
    lat = np.asarray(fs.coord("latitude").values)
    lon = np.asarray(fs.coord("longitude").values)
    space = _space_tuples(level, lat, lon)
    n_space = len(space)

    blocks = []
    for var in variables:
        field = fs[var]
        if has_time:
            arr = field.transpose(*SPATIAL_STACK_ORDER, "time").data
            blocks.append(arr.reshape(n_space, arr.shape[-1]))
        else:
            arr = field.transpose(*SPATIAL_STACK_ORDER).data
            blocks.append(arr.reshape(n_space))
    data = np.concatenate([np.asarray(b) for b in blocks], axis=0)

    coords: dict[str, Any] = {
        "space": Coord("space", np.tile(space, len(variables))),
        "original_variable": Coord(
            "space", np.repeat(np.asarray(variables, dtype=object), n_space)
        ),
    }
    dims = ("space", "time") if has_time else ("space",)
    if has_time:
        coords["time"] = Coord("time", fs.coord("time").values)

    attrs = dict(fs.attrs)
    attrs["original_variables"] = list(variables)
    attrs["space_coords"] = list(SPATIAL_STACK_ORDER)
    return Field(data, dims, coords, attrs, name="X")


def delay_embed_np(X: np.ndarray, d: int) -> np.ndarray:
    """Delay-embed a (S, T) snapshot matrix to (S*d, T-d+1).

    Row block j holds the time-shifted view ``X[:, j : j+T-d+1]``; block 0
    is the most-delayed.  Numerically identical to the reference's
    sliding-window construction (slice_tools.py:182-211) but expressed as
    d shifted slices, which is the memory-light form the fused kernels
    use (no d-fold Hankel materialization required on device).
    """
    if X.ndim != 2:
        raise ValueError("Input array must be 2D.")
    if not isinstance(d, int) or isinstance(d, bool) or d <= 0:
        raise ValueError("Delay must be an integer greater than 0.")
    t_out = X.shape[1] - d + 1
    if t_out < 1:
        raise ValueError("Delay embedding longer than the time series.")
    return np.concatenate([X[:, j : j + t_out] for j in range(d)], axis=0)


def delay_embedded_coords(X: Field, d: int) -> dict[str, Coord]:
    """Coordinates of the delay-embedded matrix WITHOUT building it.

    The operator-form and out-of-core SVD backends never materialize
    H_d(X) on host, but the packaged results still need the embedded
    coordinate bookkeeping (space/original_variable tiled d times, the
    per-row delay coord, time dropping the first d-1 entries) — the
    exact coords :func:`apply_delay_embedding` attaches.
    """
    n_space = X.sizes["space"]
    return {
        "space": Coord("space", np.tile(X.coords["space"].values, d)),
        "time": Coord("time", X.coords["time"].values[d - 1 :]),
        "original_variable": Coord(
            "space", np.tile(X.coords["original_variable"].values, d)
        ),
        "delay": Coord("space", np.repeat(np.flip(np.arange(d)), n_space)),
    }


def apply_delay_embedding(X: Field, d: int) -> Field:
    """Delay-embed a (space, time) Field, propagating coordinates.

    Output coords match the reference (slice_tools.py:214-274): space and
    original_variable tiled d times, a new per-row ``delay`` coord equal
    to ``repeat([d-1, ..., 0], n_space)``, and the time coord dropping its
    first d-1 entries.
    """
    if not isinstance(X, Field):
        raise ValueError("Input data must be a Field")
    if sorted(X.dims) != ["space", "time"]:
        raise ValueError("Input data must have dimensions ('space', 'time').")
    needed = {"space", "time", "original_variable"}
    if set(X.coords) < needed:
        raise ValueError(
            "Input data must have coordinates "
            "('space', 'time', 'original_variable')."
        )

    data = delay_embed_np(np.asarray(X.transpose("space", "time").data), d)
    coords = delay_embedded_coords(X, d)
    attrs = dict(X.attrs)
    attrs["delay_embedding"] = d
    return Field(data, ("space", "time"), coords, attrs, name=X.name)


def space_coord_to_level_lat_lon(fs: FieldSet) -> FieldSet:
    """Split the tuple-valued space coord into level/lat/lon coords.

    HDF5 (like NetCDF) cannot store tuple-valued coordinate arrays, so
    before serialization the space coord becomes a 0..S-1 integer index
    with three parallel coords — the same transformation the reference
    applies before writing (slice_tools.py:368-414).
    """
    space = None
    for field in fs.data_vars.values():
        if "space" in field.coords:
            space = field.coords["space"]
            break
    if space is None:
        raise ValueError("Input dataset must have a 'space' coordinate.")

    already_split = True
    try:
        for name in ("level", "latitude", "longitude"):
            fs.coord(name)
    except KeyError:
        already_split = False
    if already_split:
        log_and_print(
            logger,
            "Dataset already has separate coordinates for "
            "level, latitude, and longitude.",
        )
        return fs

    tuples = space.values
    level = np.asarray([t[0] for t in tuples])
    lat = np.asarray([t[1] for t in tuples])
    lon = np.asarray([t[2] for t in tuples])
    index = np.arange(len(tuples), dtype=int)

    def convert(field: Field) -> Field:
        if "space" not in field.coords:
            return field
        new_coords = dict(field.coords)
        new_coords["space"] = Coord("space", index)
        new_coords["level"] = Coord("space", level)
        new_coords["latitude"] = Coord("space", lat)
        new_coords["longitude"] = Coord("space", lon)
        return Field(field.data, field.dims, new_coords, field.attrs, field.name)

    return fs.map(convert)
