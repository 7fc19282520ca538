"""Zarr v2 reader + remote-ingest path.

The reference's production ingest opens ARCO-ERA5 Zarr on GCS
(/root/reference/src/dmd_era5/era5_download/era5_download.py:81-83).
These tests exercise the bundled from-scratch reader against fixtures
written in the v2 layout by hand (no zarr dependency anywhere), and the
full ``era5_download.main(use_mock_data=False)`` stage against a local
Zarr store — plus the chunk-streaming path into the packed artifact.
"""

from __future__ import annotations

import gzip
import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest

from dmd_era5_tpu.snapmat.zarr_reader import (
    ZarrArray,
    _blosc_decompress,
    _lz4_block_decompress,
    decode_cf_time,
    open_zarr_group,
    write_zarr_array,
)

# ------------------------------------------------------------- fixtures


def _hours_since_1900(times: np.ndarray) -> np.ndarray:
    epoch = np.datetime64("1900-01-01T00:00:00", "ns")
    return (
        (times.astype("datetime64[ns]") - epoch) / np.timedelta64(1, "h")
    ).astype(np.int64)


def make_era5_zarr_fixture(
    root: Path,
    n_time: int = 30,
    levels=(850, 1000),
    n_lat: int = 9,
    n_lon: int = 10,
    variables=("temperature", "u_component_of_wind"),
    compressor: str | None = "zlib",
    time_chunk: int = 8,
    seed: int = 0,
) -> dict:
    """Hand-written Zarr v2 ERA5-like store (CF time, chunked)."""
    rng = np.random.default_rng(seed)
    times = np.datetime64("2019-01-01T00", "ns") + np.arange(
        n_time
    ) * np.timedelta64(1, "h")
    lats = np.linspace(90, -90, n_lat)
    lons = np.linspace(-180, 175, n_lon)
    lev = np.asarray(levels, dtype=np.int64)

    write_zarr_array(
        root, "time", _hours_since_1900(times), dims=("time",),
        attrs={"units": "hours since 1900-01-01T00:00:00"},
        compressor=None,
    )
    write_zarr_array(root, "level", lev, dims=("level",), compressor=None)
    write_zarr_array(root, "latitude", lats, dims=("latitude",), compressor=None)
    write_zarr_array(root, "longitude", lons, dims=("longitude",), compressor=None)

    data = {}
    for var in variables:
        arr = rng.standard_normal(
            (n_time, len(lev), n_lat, n_lon)
        ).astype(np.float32)
        write_zarr_array(
            root, var, arr,
            chunks=(time_chunk, 1, n_lat, n_lon),
            dims=("time", "level", "latitude", "longitude"),
            compressor=compressor,
        )
        data[var] = arr
    return {
        "times": times, "levels": lev, "lats": lats, "lons": lons,
        "data": data,
    }


@pytest.fixture()
def era5_zarr(tmp_path) -> tuple[Path, dict]:
    root = tmp_path / "era5.zarr"
    info = make_era5_zarr_fixture(root)
    return root, info


# --------------------------------------------------------------- reader


class TestZarrReader:
    def test_roundtrip_full(self, era5_zarr):
        root, info = era5_zarr
        group = open_zarr_group(root)
        assert set(group.array_keys()) >= {"temperature", "time", "level"}
        arr = group["temperature"]
        assert arr.shape == info["data"]["temperature"].shape
        np.testing.assert_array_equal(arr[:], info["data"]["temperature"])

    def test_orthogonal_selection(self, era5_zarr):
        root, info = era5_zarr
        arr = open_zarr_group(root)["temperature"]
        ref = info["data"]["temperature"]
        got = arr[3:17, np.asarray([1]), 2:5]
        np.testing.assert_array_equal(got, ref[3:17, [1], 2:5])
        # int index squeezes the axis
        got = arr[5]
        np.testing.assert_array_equal(got, ref[5])
        # strided slice
        got = arr[::3, 0]
        np.testing.assert_array_equal(got, ref[::3, 0])

    def test_chunk_pushdown_reads_only_covering_chunks(self, era5_zarr):
        root, _ = era5_zarr
        arr = open_zarr_group(root)["temperature"]
        reads: list[str] = []
        orig = arr.store.get

        def spy(key):
            if not key.endswith((".zarray", ".zattrs", ".zgroup")):
                reads.append(key)
            return orig(key)

        arr.store.get = spy
        arr[0:8, 0]  # one time chunk x one level chunk
        assert reads == ["temperature/0.0.0.0"]

    def test_missing_chunk_gives_fill_value(self, tmp_path):
        root = tmp_path / "z"
        write_zarr_array(
            root, "a", np.arange(12, dtype=np.float32).reshape(3, 4),
            chunks=(2, 4),
        )
        (root / "a" / "1.0").unlink()
        arr = open_zarr_group(root)["a"]
        out = arr[:]
        np.testing.assert_array_equal(out[:2], np.arange(8).reshape(2, 4))
        np.testing.assert_array_equal(out[2], 0)

    def test_gzip_and_raw_codecs(self, tmp_path):
        data = np.arange(40, dtype=np.int32).reshape(5, 8)
        for comp in (None, "zlib", "gzip"):
            root = tmp_path / f"z_{comp}"
            write_zarr_array(root, "a", data, chunks=(2, 8), compressor=comp)
            np.testing.assert_array_equal(
                open_zarr_group(root)["a"][:], data
            )

    def test_consolidated_metadata(self, tmp_path):
        root = tmp_path / "z"
        data = np.arange(6, dtype=np.float64).reshape(2, 3)
        write_zarr_array(root, "a", data, dims=("x", "y"))
        meta = {
            "zarr_format": 2,
            "metadata": {
                ".zgroup": {"zarr_format": 2},
                "a/.zarray": json.loads((root / "a" / ".zarray").read_text()),
                "a/.zattrs": json.loads((root / "a" / ".zattrs").read_text()),
            },
        }
        (root / ".zmetadata").write_text(json.dumps(meta))
        group = open_zarr_group(root)
        assert group._consolidated is not None
        assert group.array_keys() == ["a"]
        arr = group["a"]
        assert arr.dims == ("x", "y")
        np.testing.assert_array_equal(arr[:], data)

    def test_dimension_separator_slash(self, tmp_path):
        root = tmp_path / "z"
        data = np.arange(16, dtype=np.float32).reshape(4, 4)
        write_zarr_array(
            root, "a", data, chunks=(2, 2), dimension_separator="/"
        )
        # slash separator writes nested files a/0/0 etc.
        assert (root / "a" / "0" / "1").exists() or (root / "a" / "0/1").exists()
        np.testing.assert_array_equal(open_zarr_group(root)["a"][:], data)

    def test_cf_time_decode(self):
        units = "hours since 1900-01-01T00:00:00"
        vals = np.asarray([0, 24, 25])
        got = decode_cf_time(vals, units)
        assert got[0] == np.datetime64("1900-01-01T00", "ns")
        assert got[1] == np.datetime64("1900-01-02T00", "ns")
        # float offsets (some stores) round correctly
        got_f = decode_cf_time(vals.astype(np.float64), units)
        np.testing.assert_array_equal(got, got_f)

    def test_rejects_v3_and_filters(self, tmp_path):
        store_meta = {
            "zarr_format": 3, "shape": [2], "chunks": [2], "dtype": "<f4",
        }
        with pytest.raises(ValueError, match="format 2"):
            ZarrArray(None, "a", store_meta)
        meta2 = {
            "zarr_format": 2, "shape": [2], "chunks": [2], "dtype": "<f4",
            "filters": [{"id": "delta"}],
        }
        with pytest.raises(ValueError, match="filters"):
            ZarrArray(None, "a", meta2)


class TestBloscLz4:
    """The blosc1 container + pure-Python LZ4 block decode."""

    @staticmethod
    def _lz4_store_literals(raw: bytes) -> bytes:
        """Minimal valid LZ4 block: one all-literal sequence."""
        n = len(raw)
        out = bytearray()
        if n < 15:
            out.append(n << 4)
        else:
            out.append(0xF0)
            rest = n - 15
            while rest >= 255:
                out.append(255)
                rest -= 255
            out.append(rest)
        out += raw
        return bytes(out)

    def test_lz4_literals(self):
        raw = bytes(range(256)) * 3
        enc = self._lz4_store_literals(raw)
        assert _lz4_block_decompress(enc, len(raw)) == raw

    def test_lz4_match_sequence(self):
        # "abcd" then a match copying 8 bytes from offset 4 (overlapping
        # -> repeats abcd twice), then literals "XY" as the tail.
        enc = bytes([0x44]) + b"abcd" + struct.pack("<H", 4) + bytes([0x20]) + b"XY"
        out = _lz4_block_decompress(enc, 14)
        assert out == b"abcd" + b"abcdabcd" + b"XY"

    @staticmethod
    def _make_blosc(
        raw: bytes, typesize: int, codec: int, shuffle: bool
    ) -> bytes:
        """Hand-build a single-block blosc1 chunk."""
        nbytes = len(raw)
        body = raw
        if shuffle:
            arr = np.frombuffer(raw, np.uint8).reshape(-1, typesize)
            body = arr.T.tobytes()
        flags = (0x1 if shuffle else 0) | (codec << 5)
        if codec == 3:
            comp = zlib.compress(body)
        else:
            raise AssertionError("test builds zlib blocks only")
        header = struct.pack(
            "<BBBBIII", 2, 1, flags, typesize, nbytes, nbytes,
            16 + 4 + 4 + len(comp),
        )
        bstarts = struct.pack("<i", 16 + 4)
        block = struct.pack("<i", len(comp)) + comp
        return header + bstarts + block

    def test_blosc_zlib_roundtrip(self):
        data = np.arange(512, dtype=np.float32)
        chunk = self._make_blosc(data.tobytes(), 4, codec=3, shuffle=False)
        out, ts, sh = _blosc_decompress(chunk)
        assert not sh and out == data.tobytes()

    def test_blosc_shuffle_roundtrip(self):
        data = np.arange(512, dtype=np.float32)
        chunk = self._make_blosc(data.tobytes(), 4, codec=3, shuffle=True)
        from dmd_era5_tpu.snapmat.zarr_reader import _byte_unshuffle

        out, ts, sh = _blosc_decompress(chunk)
        assert sh and ts == 4
        assert _byte_unshuffle(out, ts) == data.tobytes()

    def test_blosc_memcpy(self):
        raw = b"0123456789abcdef"
        header = struct.pack(
            "<BBBBIII", 2, 1, 0x2, 1, len(raw), len(raw), 16 + len(raw)
        )
        out, _, _ = _blosc_decompress(header + raw)
        assert out == raw


# ------------------------------------------------------- ingest parity


class TestEra5ZarrIngest:
    def test_slice_pushdown_matches_fixture(self, era5_zarr):
        from dmd_era5_tpu.snapmat.era5_zarr import read_era5_zarr_slice

        root, info = era5_zarr
        fs = read_era5_zarr_slice(
            root,
            ["temperature"],
            np.datetime64("2019-01-01T05").astype("datetime64[s]").item(),
            np.datetime64("2019-01-01T20").astype("datetime64[s]").item(),
            levels=[1000],
        )
        ref = info["data"]["temperature"][5:21, [1]]
        np.testing.assert_allclose(
            np.asarray(fs["temperature"].data), ref, rtol=0, atol=0
        )
        np.testing.assert_array_equal(
            fs.coord("level").values, np.asarray([1000])
        )
        assert fs.coord("time").values[0] == np.datetime64("2019-01-01T05", "ns")

    def test_out_of_bounds_raises(self, era5_zarr):
        from dmd_era5_tpu.snapmat.era5_zarr import read_era5_zarr_slice

        root, _ = era5_zarr
        with pytest.raises(ValueError, match="outside dataset bounds"):
            read_era5_zarr_slice(
                root, ["temperature"],
                np.datetime64("2018-12-31T00").astype("datetime64[s]").item(),
                np.datetime64("2019-01-01T10").astype("datetime64[s]").item(),
            )

    def test_missing_variable_raises(self, era5_zarr):
        from dmd_era5_tpu.snapmat.era5_zarr import read_era5_zarr_slice

        root, _ = era5_zarr
        with pytest.raises(ValueError, match="not present"):
            read_era5_zarr_slice(
                root, ["v_component_of_wind"],
                np.datetime64("2019-01-01T00").astype("datetime64[s]").item(),
                np.datetime64("2019-01-01T10").astype("datetime64[s]").item(),
            )

    def test_download_stage_end_to_end(self, era5_zarr, tmp_path):
        """era5_download.main(use_mock_data=False) against a local store."""
        from dmd_era5_tpu.pipeline import era5_download
        from dmd_era5_tpu.utils.io_h5 import load_fieldset

        root, info = era5_zarr
        config = {
            "source_path": str(root),
            "start_datetime": "2019-01-01T02",
            "end_datetime": "2019-01-02T02",
            "delta_time": "2h",
            "variables": "temperature,u_component_of_wind",
            "levels": "850,1000",
        }
        from dmd_era5_tpu.core import config_parser

        parsed = config_parser(config, "era5-download")
        fs = era5_download.download_era5_data(parsed, use_mock_data=False)
        assert Path(parsed["save_path"]).exists()
        # 2h resampling of hours [2, 26] -> 13 snapshots
        assert fs.sizes["time"] == 13
        ref = info["data"]["temperature"][2:27:2]
        np.testing.assert_allclose(
            np.asarray(fs["temperature"].data), ref, rtol=0, atol=0
        )
        saved = load_fieldset(parsed["save_path"])
        assert saved.attrs["source_path"] == str(root)
        np.testing.assert_allclose(
            np.asarray(saved["temperature"].data), ref
        )

    def test_zarr_to_packed_matches_inmem_pack(self, era5_zarr, tmp_path):
        """Chunk-streamed packing == materialize-then-pack."""
        from dmd_era5_tpu.snapmat.era5_zarr import (
            read_era5_zarr_slice,
            zarr_to_packed,
        )
        from dmd_era5_tpu.snapmat.loader import (
            build_snapshot_matrix,
            packed_info,
            read_packed_rows,
        )

        root, _ = era5_zarr
        start = np.datetime64("2019-01-01T00").astype("datetime64[s]").item()
        end = np.datetime64("2019-01-02T05").astype("datetime64[s]").item()
        variables = ["temperature", "u_component_of_wind"]

        out = tmp_path / "packed.h5"
        n_rows, n_cols = zarr_to_packed(
            root, out, variables, start, end, levels=[850, 1000]
        )

        fs = read_era5_zarr_slice(root, variables, start, end, [850, 1000])
        x_ref, meta = build_snapshot_matrix(fs, variables)
        assert (n_rows, n_cols) == x_ref.shape
        (shape, meta2, bf16) = packed_info(out)
        assert shape == x_ref.shape and not bf16
        assert meta2.variables == variables
        np.testing.assert_allclose(
            read_packed_rows(out, 0, n_rows), x_ref, rtol=0, atol=0
        )


# ---- vendored ARCO-ERA5 format fixtures (review r4 item 5) ---------------
# Committed bytes generated by tests/fixtures/make_arco_fixture.py with an
# INDEPENDENT blosc encoder — no shared code with the reader or the repo's
# own write_zarr_array, so these fail if the reader's assumptions diverge
# from the ARCO layout (chunks [1, levels, lat, lon], blosc+shuffle, CF
# int64 time, NaN fill, consolidated metadata, descending latitude).

FIXTURES = Path(__file__).resolve().parent / "fixtures"


def test_arco_mini_store_slice_values():
    from datetime import datetime

    from dmd_era5_tpu.snapmat.era5_zarr import read_era5_zarr_slice

    store = FIXTURES / "arco_era5_mini"
    # T0_HOURS = hours from 1900-01-01 to 1959-01-01
    fs = read_era5_zarr_slice(
        store,
        ["temperature", "v_component_of_wind"],
        datetime(1959, 1, 1, 1),
        datetime(1959, 1, 1, 3),
        levels=[200, 1000],
    )
    temp = fs["temperature"]
    assert temp.data.shape == (3, 2, 7, 12)
    np.testing.assert_array_equal(
        temp.coords["time"].values,
        np.arange("1959-01-01T01", "1959-01-01T04", dtype="datetime64[h]")
        .astype("datetime64[ns]"),
    )
    np.testing.assert_array_equal(temp.coords["level"].values, [200, 1000])
    # latitude comes through DESCENDING, exactly as stored
    np.testing.assert_array_equal(
        temp.coords["latitude"].values,
        np.arange(90.0, -90.1, -30.0, dtype=np.float32),
    )
    # analytic values decode to their own indices:
    # value = var*100000 + t*10000 + lev*1000 + lat*100 + lon
    assert temp.data[0, 0, 0, 0] == 1 * 10000 + 1 * 1000  # t=1, lev_idx=1
    assert temp.data[2, 1, 3, 5] == 3 * 10000 + 4 * 1000 + 3 * 100 + 5
    v = fs["v_component_of_wind"]
    assert v.data[0, 0, 0, 0] == 2 * 100000 + 1 * 10000 + 1 * 1000


def test_arco_mini_missing_chunk_is_nan_fill():
    from datetime import datetime

    from dmd_era5_tpu.snapmat.era5_zarr import read_era5_zarr_slice

    store = FIXTURES / "arco_era5_mini"
    fs = read_era5_zarr_slice(
        store,
        ["temperature"],
        datetime(1959, 1, 1, 3),
        datetime(1959, 1, 1, 5),
        levels=[50],
    )
    data = fs["temperature"].data  # times t=3,4,5; chunk t=4 is absent
    assert np.isfinite(data[0]).all() and np.isfinite(data[2]).all()
    assert np.isnan(data[1]).all()  # fill_value "NaN" served for the gap


def test_arco_fullscale_metadata_and_chunk_pushdown():
    """Parse the full-scale consolidated metadata (the published store
    spec: 37 levels, 721 x 1440, hourly 1959-2022, chunks
    [1, 37, 721, 1440]) and verify slice pushdown touches EXACTLY the
    covering chunk keys — one store key per requested hour."""
    import json

    from dmd_era5_tpu.snapmat.zarr_reader import ZarrGroup

    consolidated = json.loads(
        (FIXTURES / "arco_era5_fullscale.zmetadata.json").read_text()
    )["metadata"]

    requested: list[str] = []

    class RecordingStore:
        def get(self, key):
            requested.append(key)
            return None  # no chunk bytes: reads resolve to fill values

        def list_prefix(self, prefix=""):
            return []

    group = ZarrGroup(RecordingStore(), consolidated=consolidated)
    assert set(group.array_keys()) >= {
        "temperature", "u_component_of_wind", "v_component_of_wind",
    }
    temp = group["temperature"]
    n_hours = 23376 * 24  # hourly 1959-01-01..2022-12-31 inclusive
    assert temp.shape == (n_hours, 37, 721, 1440)
    assert temp.chunks == (1, 37, 721, 1440)
    assert temp.dims == ("time", "level", "latitude", "longitude")
    assert temp.compressor["id"] == "blosc"

    # pushdown: 24 hours x all levels -> exactly 24 chunk fetches, at
    # the right time indices, '.'-separated keys
    t0 = 100_000
    block = temp[t0 : t0 + 24, :, :2, :2]
    assert block.shape == (24, 37, 2, 2)
    assert np.isnan(block).all()  # fill_value NaN for absent chunks
    keys = [k for k in requested if k.startswith("temperature/")]
    assert keys == [f"temperature/{t}.0.0.0" for t in range(t0, t0 + 24)]
