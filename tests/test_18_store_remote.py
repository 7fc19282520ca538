"""Artifact-store remote lifecycle (tier 2).

The reference's hardest DVC test: delete the local data AND the local
cache, then restore everything from the default remote
(/root/reference/tests/test_04_dvc_era5_download.py:304-330, run inside
a container with a baked-in local remote, Dockerfile.repo:6-12).  Here
the remote is a plain directory configured via DMD_ERA5_TPU_REMOTE, so
the same lifecycle runs hermetically in a tmp dir.
"""

from __future__ import annotations

import os

import pytest

from dmd_era5_tpu.core.config_parser import config_parser
from dmd_era5_tpu.pipeline.artifacts import (
    _objects_dir,
    add_data_to_store,
    fetch_from_remote,
    push_to_remote,
    retrieve_data_from_store,
)
from dmd_era5_tpu.snapmat.mock import create_mock_era5
from dmd_era5_tpu.utils.io_h5 import load_fieldset, save_fieldset

pytestmark = pytest.mark.tier2


@pytest.fixture()
def dl_config():
    return {
        "source_path": "mock_data",
        "start_datetime": "2019-01-01T00",
        "end_datetime": "2019-01-01T06",
        "delta_time": "1h",
        "variables": "temperature",
        "levels": "1000",
    }


@pytest.fixture()
def remote_dir(tmp_path, monkeypatch):
    remote = tmp_path / "store_remote"
    monkeypatch.setenv("DMD_ERA5_TPU_REMOTE", str(remote))
    return remote


def _make_slice(parsed):
    fs = create_mock_era5(
        "2019-01-01", "2019-01-01T06", ["temperature"], [1000], seed=0
    )
    fs.attrs["variables"] = ["temperature"]
    fs.attrs["levels"] = [1000]
    fs.attrs["source_path"] = parsed["source_path"]
    save_fieldset(fs, parsed["save_path"])
    return fs


def test_add_pushes_to_remote(dl_config, remote_dir):
    parsed = config_parser(dl_config, "era5-download")
    fs = _make_slice(parsed)
    md5 = add_data_to_store(parsed["save_path"], fs.attrs)
    assert (remote_dir / md5).exists(), "add must push to the default remote"


def test_refetch_after_local_wipe(dl_config, remote_dir):
    """Delete workdir copy AND local cache object; retrieval must
    restore both from the remote."""
    parsed = config_parser(dl_config, "era5-download")
    fs = _make_slice(parsed)
    md5 = add_data_to_store(parsed["save_path"], fs.attrs)

    os.remove(parsed["save_path"])  # workdir data gone
    os.remove(_objects_dir() / md5)  # local cache gone

    path = retrieve_data_from_store(parsed, "era5_slice")
    assert path.exists()
    assert (_objects_dir() / md5).exists(), "fetch must repopulate the cache"
    back = load_fieldset(path)
    assert back.attrs["variables"] == ["temperature"]


def test_no_remote_configured(dl_config, monkeypatch):
    """Without a remote, push/fetch are clean no-ops and a cache miss
    still raises FileNotFoundError (the reference's error contract)."""
    monkeypatch.delenv("DMD_ERA5_TPU_REMOTE", raising=False)
    parsed = config_parser(dl_config, "era5-download")
    fs = _make_slice(parsed)
    md5 = add_data_to_store(parsed["save_path"], fs.attrs)
    assert push_to_remote(md5) is False
    assert fetch_from_remote(md5) is False

    os.remove(parsed["save_path"])
    os.remove(_objects_dir() / md5)
    with pytest.raises(FileNotFoundError):
        retrieve_data_from_store(parsed, "era5_slice")


def test_as_of_time_travel(dl_config, monkeypatch):
    """add v1, add v2 -> as-of v1's append time (or ordinal) returns v1
    bytes; the default returns v2.  Restores the reference's ability to
    reproduce any historical pipeline state
    (/root/reference/src/dmd_era5/dvc_tools.py:66-92,217-218)."""
    import numpy as np

    from dmd_era5_tpu.pipeline.artifacts import file_md5, list_versions

    monkeypatch.delenv("DMD_ERA5_TPU_REMOTE", raising=False)
    parsed = config_parser(dl_config, "era5-download")
    fs = _make_slice(parsed)
    md5_v1 = add_data_to_store(parsed["save_path"], fs.attrs)

    # v2: same config, different bytes
    first = next(iter(fs.data_vars))
    fs[first].data = np.asarray(fs[first].data) + 1.0
    save_fieldset(fs, parsed["save_path"])
    md5_v2 = add_data_to_store(parsed["save_path"], fs.attrs)
    assert md5_v1 != md5_v2

    versions = list_versions(
        parsed["save_path"], data_type="era5_slice"
    )
    assert [m for m, _ in versions] == [md5_v1, md5_v2]
    v1_time = versions[0][1]["_store_logged_at"]

    # default: newest
    target = retrieve_data_from_store(parsed, data_type="era5_slice")
    assert file_md5(target) == md5_v2
    # as-of v1's timestamp: v1 bytes
    target = retrieve_data_from_store(
        parsed, data_type="era5_slice", as_of=v1_time
    )
    assert file_md5(target) == md5_v1
    # as-of append ordinal 0: v1 bytes
    target = retrieve_data_from_store(
        parsed, data_type="era5_slice", as_of=0
    )
    assert file_md5(target) == md5_v1
    # as-of a pre-history timestamp: no visible match
    with pytest.raises(ValueError, match="as of"):
        retrieve_data_from_store(
            parsed, data_type="era5_slice",
            as_of="1990-01-01T00:00:00+00:00",
        )
    # NAIVE timestamps are treated as UTC (review r4): v1's stamp with
    # the offset stripped must behave identically to the aware form
    from datetime import datetime

    v1_naive = datetime.fromisoformat(v1_time).replace(tzinfo=None)
    target = retrieve_data_from_store(
        parsed, data_type="era5_slice", as_of=v1_naive
    )
    assert file_md5(target) == md5_v1
    with pytest.raises(ValueError, match="as of"):
        retrieve_data_from_store(
            parsed, data_type="era5_slice",
            as_of="1990-01-01T00:00:00",  # naive pre-history
        )
    # bool is not an ordinal
    with pytest.raises(TypeError, match="as_of"):
        retrieve_data_from_store(
            parsed, data_type="era5_slice", as_of=True
        )
