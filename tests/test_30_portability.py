"""What the package needs from its platform, checked on the CPU.

- no module imports the TPU Pallas backend, and no kernel runs in the
  Pallas interpreter;
- the fit step's dispatch depends on the mesh's ``time`` axis alone;
- the out-of-core budget comes from the device's memory limit;
- the multi-device dry run uses CPU devices only in a CPU process;
- the stage path runs without h5py (the numpy-only artifact container).
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def _run(code: str, env_extra: dict | None = None) -> str:
    env = dict(os.environ, **(env_extra or {}))
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out.stdout


def test_no_module_imports_tpu_pallas():
    """Importing every module of the package pulls in no TPU backend."""
    out = _run(
        "import importlib, pathlib, sys, dmd_era5_tpu\n"
        "root = pathlib.Path(dmd_era5_tpu.__path__[0]).parent\n"
        "for f in sorted(root.joinpath('dmd_era5_tpu').rglob('*.py')):\n"
        "    mod = '.'.join(f.relative_to(root).with_suffix('').parts)\n"
        "    importlib.import_module(mod.removesuffix('.__init__'))\n"
        "print(sorted(k for k in sys.modules if 'pallas' in k))\n"
    )
    assert "jax.experimental.pallas.tpu" not in out, out


def test_no_pallas_interpreter_in_package_sources():
    for path in (REPO / "dmd_era5_tpu").rglob("*.py"):
        src = path.read_text()
        assert "interpret=" not in src, path
        assert "pallas.tpu" not in src and "pltpu" not in src, path


@pytest.mark.parametrize("backend", ["cpu", "gpu", "tpu"])
def test_fit_step_dispatch_reads_only_the_time_axis(monkeypatch, backend):
    """Per-shard fused ingest when ``time`` is unsharded, the portable
    GSPMD step otherwise — whatever the process's default backend."""
    from dmd_era5_tpu.parallel import make_mesh
    from dmd_era5_tpu.pipeline import train_step

    calls = []
    monkeypatch.setattr(
        train_step, "_fit_step_fused_sharded",
        lambda *a, **k: calls.append("fused"),
    )
    monkeypatch.setattr(
        train_step, "_fit_step_portable",
        lambda *a, **k: calls.append("portable"),
    )
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    for spec, want in (
        ("space=8", "fused"),
        ("data=2,space=4", "fused"),
        ("space=4,time=2", "portable"),
        ("data=2,space=2,time=2", "portable"),
    ):
        calls.clear()
        train_step.fit_step(None, None, make_mesh(spec), 4)
        assert calls == [want], (spec, calls)


class _Dev:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


class _Mesh:
    def __init__(self, stats):
        self.devices = np.asarray([_Dev(stats)], dtype=object)


def test_memory_budget_from_device_limit(monkeypatch):
    from dmd_era5_tpu.pipeline.era5_svd import device_memory_budget_gb

    monkeypatch.delenv("DMD_ERA5_TPU_HBM_BUDGET_GB", raising=False)
    # an 80 GB card whose JAX process may hold three quarters of it
    mesh = _Mesh({"bytes_limit": 60e9})
    assert device_memory_budget_gb(mesh) == pytest.approx(30.0)
    assert device_memory_budget_gb(_Mesh(None)) is None
    assert device_memory_budget_gb(_Mesh({})) is None
    monkeypatch.setenv("DMD_ERA5_TPU_HBM_BUDGET_GB", "7")
    assert device_memory_budget_gb(mesh) == 7.0


def test_dryrun_multichip_refuses_too_few_devices():
    import __graft_entry__ as g

    with pytest.raises(RuntimeError, match="need 64 CPU devices"):
        g.dryrun_multichip(64)


# ------------------------------------------- artifacts without h5py


def _fieldset():
    from dmd_era5_tpu.utils.labels import Coord, Field, FieldSet

    times = np.arange(
        np.datetime64("2020-01-01T00", "ns"),
        np.datetime64("2020-01-01T05", "ns"),
        np.timedelta64(1, "h"),
    )
    space = Coord("space", np.arange(6))
    var = Coord("space", np.asarray(["t", "t", "t", "u", "u", "u"], object))
    u = Field(
        np.arange(30, dtype=np.float32).reshape(6, 5),
        ("space", "time"),
        {"space": space, "time": Coord("time", times), "original_variable": var},
        {"units": "K", "scale": [1.5, 2.5]},
        "U",
    )
    s = Field(
        np.asarray([3.0, 2.0, 1.0]), ("mode",), {}, {"flag": True}, "s"
    )
    attrs = {
        "n_components": 3,
        "variables": ["temperature", "u_component_of_wind"],
        "levels": [1000, 850],
        "mean_center": True,
        "source_path": "mock_data",
        "nothing": None,
        "extra": {"a": [1, 2]},
        "eig0": complex(0.5, -1.0),
    }
    return FieldSet({"U": u, "s": s}, attrs=attrs)


def test_npz_container_round_trip(tmp_path, monkeypatch):
    from dmd_era5_tpu.utils import io_h5

    monkeypatch.setitem(sys.modules, "h5py", None)  # import raises
    fs = _fieldset()
    path = tmp_path / "artifact.h5"
    io_h5.save_fieldset(fs, path)
    assert path.read_bytes()[:4] == b"PK\x03\x04"
    back = io_h5.load_fieldset(path)
    assert set(back.data_vars) == {"U", "s"}
    np.testing.assert_array_equal(back["U"].data, fs["U"].data)
    assert back["U"].dims == ("space", "time")
    assert back["U"].coords["time"].values.dtype == np.dtype("datetime64[ns]")
    np.testing.assert_array_equal(
        back["U"].coords["time"].values, fs["U"].coords["time"].values
    )
    assert list(back["U"].coords["original_variable"].values) == list("tttuuu")
    assert back["U"].attrs["units"] == "K"
    np.testing.assert_array_equal(back["U"].attrs["scale"], [1.5, 2.5])
    assert back["s"].attrs["flag"] == 1
    a = back.attrs
    assert a["n_components"] == 3 and a["mean_center"] == 1
    assert a["variables"] == ["temperature", "u_component_of_wind"]
    np.testing.assert_array_equal(a["levels"], [1000, 850])
    assert a["nothing"] is None and a["extra"] == {"a": [1, 2]}
    assert a["eig0"] == complex(0.5, -1.0)


def test_h5_artifacts_still_load_when_saved_with_h5py(tmp_path):
    """The netCDF-compatible HDF5 layout stays the format where h5py
    exists; load_fieldset tells the two apart by their magic bytes."""
    pytest.importorskip("h5py")
    from dmd_era5_tpu.utils import io_h5

    path = tmp_path / "artifact.h5"
    io_h5.save_fieldset(_fieldset(), path)
    assert path.read_bytes()[:4] == b"\x89HDF"
    back = io_h5.load_fieldset(path)
    np.testing.assert_array_equal(back["U"].data, _fieldset()["U"].data)


def test_stage_mains_run_without_h5py(tmp_path):
    """Mock ingest -> SVD -> optimized DMD + holdout forecast, with h5py
    unimportable: the artifacts are the numpy container, the cache
    ladder serves them back, and the SVD matches the host oracle."""
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None\n"
        "import numpy as np\n"
        "from dmd_era5_tpu.pipeline import era5_dmd, era5_download, era5_svd\n"
        "from dmd_era5_tpu.snapmat import apply_delay_embedding, "
        "flatten_era5_variables, standardize_data\n"
        "cfg = dict(source_path='mock_data', start_datetime='2019-01-01T00',"
        " end_datetime='2019-01-02T00', delta_time='1h',"
        " variables='temperature', levels='1000', svd_type='standard',"
        " delay_embedding=2, mean_center=True, scale=False, n_components=6,"
        " save_data_matrix=False, dmd_rank=4, optimized=True,"
        " forecast_steps=4, forecast_holdout=3, lm_max_iter=10)\n"
        "fs = era5_download.main(cfg, use_mock_data=True, use_store=True)\n"
        "res, _, _ = era5_dmd.main(cfg, write_artifact=True, use_store=True)\n"
        "assert np.isfinite(np.asarray(res['eigenvalues'].values)).all()\n"
        "svd, _, _ = era5_svd.main(cfg, write_artifact=True, use_store=True)\n"
        "from dmd_era5_tpu.core import config_parser\n"
        "p = config_parser(cfg, 'era5-svd')\n"
        "assert open(p['save_path'], 'rb').read(4) == b'PK\\x03\\x04'\n"
        "print('OK', float(np.asarray(svd['s'].data)[0]))\n"
    )
    out = _run(code, {"DMD_ERA5_TPU_ROOT": str(tmp_path)})
    assert "OK" in out, out
