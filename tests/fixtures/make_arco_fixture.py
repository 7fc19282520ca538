"""Generate the vendored ARCO-ERA5 format fixtures (run once; bytes
are committed).

The ingest stage exists to read ONE store — ARCO-ERA5 at
``gs://gcp-public-data-arco-era5/ar/1959-2022-full_37-1h-0p25deg-chunk-1
.zarr-v2`` (config.ini, and the reference's open_zarr at
/root/reference/src/dmd_era5/era5_download/era5_download.py:81-83) —
but round-4 tests exercised the Zarr reader only against stores written
by the repo's own ``write_zarr_array``, so reader and writer shared
assumptions by construction (review r4 item 5).  These fixtures pin
the ARCO layout *independently*:

1. ``arco_era5_fullscale.zmetadata.json`` — a consolidated ``.zmetadata``
   re-encoding the published store spec at full scale: the 37 ERA5
   pressure levels, the 721 x 1440 0.25-degree grid (latitude 90..-90
   descending, longitude 0..359.75), hourly time for 1959-2022 encoded
   as CF "hours since 1900-01-01", float32, chunks [1, 37, 721, 1440]
   (the "-chunk-1" in the store name), blosc/lz4/shuffle compressor,
   fill_value NaN, xarray ``_ARRAY_DIMENSIONS`` attributes.  (A
   synthetic re-encode of the published chunk spec, NOT fetched bytes —
   this environment has no network egress; byte-level provenance is the
   spec in the store name + the ERA5/ARCO conventions.)

2. ``arco_era5_mini/`` — a complete committed store with the same
   structure at a reduced grid, whose chunk bytes were produced by the
   INDEPENDENT blosc encoder below (byte-shuffle + zlib-in-blosc
   framing, written from the c-blosc header spec — no shared code with
   ``zarr_reader`` or ``write_zarr_array``): analytic float32 values,
   one missing chunk (fill_value NaN semantics), uncompressed
   coordinate arrays, CF int64 time.
"""

from __future__ import annotations

import json
import struct
import zlib
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent

# the 37 ERA5 pressure levels (hPa), as served by ARCO-ERA5
LEVELS_37 = [
    1, 2, 3, 5, 7, 10, 20, 30, 50, 70, 100, 125, 150, 175, 200, 225,
    250, 300, 350, 400, 450, 500, 550, 600, 650, 700, 750, 775, 800,
    825, 850, 875, 900, 925, 950, 975, 1000,
]
VARS = ["temperature", "u_component_of_wind", "v_component_of_wind"]

# hourly 1959-01-01T00 .. 2022-12-31T23 as "hours since 1900-01-01":
# 1900..1959 spans 21549 days (14 leap years), 1959..2022 inclusive
# spans 23376 days (16 leap years)
T0_HOURS = 21549 * 24
N_HOURS = 23376 * 24


def blosc_encode_zlib_shuffle(arr: np.ndarray) -> bytes:
    """Independent blosc1 frame encoder: byte-shuffle + zlib, one block.

    Written from the c-blosc header spec (blosc.h): 16-byte header
    [version, versionlz, flags, typesize, nbytes, blocksize, cbytes],
    then int32 block starts, then per-block [int32 csize | payload].
    flags: bit0 = byte-shuffle, bits5-7 = compressor format code
    (BLOSC_ZLIB_FORMAT = 3).
    """
    raw = np.ascontiguousarray(arr).tobytes()
    typesize = arr.dtype.itemsize
    n = len(raw) // typesize
    shuffled = (
        np.frombuffer(raw, np.uint8).reshape(n, typesize).T.tobytes()
    )
    payload = zlib.compress(shuffled, 6)
    nbytes = len(raw)
    blocksize = nbytes  # single block
    if len(payload) >= nbytes:  # incompressible: stored form
        payload = shuffled
        csize = nbytes
    else:
        csize = len(payload)
    bstart = 16 + 4  # header + one block-start entry
    header = struct.pack(
        "<BBBBIII",
        2,  # blosc format version
        1,  # blosclz version (unused here)
        0x1 | (3 << 5),  # shuffle | zlib format code
        typesize,
        nbytes,
        blocksize,
        16 + 4 + 4 + len(payload),  # cbytes
    )
    return header + struct.pack("<i", bstart) + struct.pack("<i", csize) + payload


def _zarray(shape, chunks, dtype, compressor, fill_value):
    return {
        "zarr_format": 2,
        "shape": list(shape),
        "chunks": list(chunks),
        "dtype": dtype,
        "compressor": compressor,
        "fill_value": fill_value,
        "order": "C",
        "filters": None,
    }


_BLOSC_LZ4 = {
    "id": "blosc", "cname": "lz4", "clevel": 5, "shuffle": 1, "blocksize": 0,
}


def make_fullscale_zmetadata() -> None:
    meta: dict = {".zgroup": {"zarr_format": 2}, ".zattrs": {}}

    def add_coord(name, shape, dtype, attrs):
        meta[f"{name}/.zarray"] = _zarray(shape, shape, dtype, None, None)
        meta[f"{name}/.zattrs"] = {"_ARRAY_DIMENSIONS": [name], **attrs}

    add_coord(
        "time", [N_HOURS], "<i8",
        {"units": "hours since 1900-01-01", "calendar": "proleptic_gregorian"},
    )
    add_coord("level", [37], "<i8", {"units": "hPa"})
    add_coord("latitude", [721], "<f4", {"units": "degrees_north"})
    add_coord("longitude", [1440], "<f4", {"units": "degrees_east"})
    for var in VARS:
        meta[f"{var}/.zarray"] = _zarray(
            [N_HOURS, 37, 721, 1440],
            [1, 37, 721, 1440],  # the "-chunk-1" time chunking
            "<f4",
            _BLOSC_LZ4,
            "NaN",
        )
        meta[f"{var}/.zattrs"] = {
            "_ARRAY_DIMENSIONS": ["time", "level", "latitude", "longitude"],
            "long_name": var.replace("_", " "),
        }
    out = {"metadata": meta, "zarr_consolidated_format": 1}
    (HERE / "arco_era5_fullscale.zmetadata.json").write_text(
        json.dumps(out, indent=1, sort_keys=True)
    )


def mini_values(var_idx, t_idx, lev_idx, lat_idx, lon_idx):
    """Analytic float32-exact values: decodes to its own index."""
    return np.float32(
        var_idx * 100000 + t_idx * 10000 + lev_idx * 1000
        + lat_idx * 100 + lon_idx
    )


MINI_T, MINI_LEVELS = 6, [50, 200, 500, 850, 1000]
MINI_LATS = np.arange(90.0, -90.1, -30.0, dtype=np.float32)  # 7, descending
MINI_LONS = np.arange(0.0, 360.0, 30.0, dtype=np.float32)  # 12


def make_mini_store() -> None:
    root = HERE / "arco_era5_mini"
    root.mkdir(exist_ok=True)
    n_lev, n_lat, n_lon = len(MINI_LEVELS), len(MINI_LATS), len(MINI_LONS)
    meta: dict = {".zgroup": {"zarr_format": 2}, ".zattrs": {}}

    def put_coord(name, values, attrs):
        values = np.ascontiguousarray(values)
        dt = values.dtype.str
        meta[f"{name}/.zarray"] = _zarray(
            [len(values)], [len(values)], dt, None, None
        )
        meta[f"{name}/.zattrs"] = {"_ARRAY_DIMENSIONS": [name], **attrs}
        (root / name).mkdir(exist_ok=True)
        (root / name / "0").write_bytes(values.tobytes())

    put_coord(
        "time",
        (T0_HOURS + np.arange(MINI_T)).astype("<i8"),
        {"units": "hours since 1900-01-01"},
    )
    put_coord("level", np.asarray(MINI_LEVELS, "<i8"), {"units": "hPa"})
    put_coord("latitude", MINI_LATS.astype("<f4"), {"units": "degrees_north"})
    put_coord("longitude", MINI_LONS.astype("<f4"), {"units": "degrees_east"})

    ti, li, ai, oi = np.meshgrid(
        np.arange(MINI_T), np.arange(n_lev), np.arange(n_lat),
        np.arange(n_lon), indexing="ij",
    )
    for vi, var in enumerate(VARS):
        data = (
            vi * 100000 + ti * 10000 + li * 1000 + ai * 100 + oi
        ).astype("<f4")
        meta[f"{var}/.zarray"] = _zarray(
            [MINI_T, n_lev, n_lat, n_lon],
            [1, n_lev, n_lat, n_lon],  # time-chunk-1, full spatial field
            "<f4",
            {"id": "blosc", "cname": "zlib", "clevel": 6, "shuffle": 1,
             "blocksize": 0},
            "NaN",
        )
        meta[f"{var}/.zattrs"] = {
            "_ARRAY_DIMENSIONS": ["time", "level", "latitude", "longitude"],
        }
        (root / var).mkdir(exist_ok=True)
        for t in range(MINI_T):
            # temperature chunk at t=4 is MISSING on purpose: readers
            # must serve fill_value NaN for absent chunks
            if var == "temperature" and t == 4:
                continue
            chunk = blosc_encode_zlib_shuffle(data[t][None])
            (root / var / f"{t}.0.0.0").write_bytes(chunk)

    (root / ".zmetadata").write_text(
        json.dumps(
            {"metadata": meta, "zarr_consolidated_format": 1},
            indent=1, sort_keys=True,
        )
    )


if __name__ == "__main__":
    make_fullscale_zmetadata()
    make_mini_store()
    print("fixtures written to", HERE)
