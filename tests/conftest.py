"""Test harness configuration.

Must run before anything imports jax or dmd_era5_tpu:
- defaults to the CPU backend (``JAX_PLATFORMS=cpu`` unless the caller
  set it) with 8 virtual devices so the multi-chip sharding paths are
  exercised on a simulated mesh (the analogue of the reference's
  mock-data tier, SURVEY.md section 4); ``JAX_PLATFORMS=cuda python -m
  pytest -m gpu`` runs the card's tests instead;
- redirects the project root to a session tmp dir so logs/ and data/
  artifacts never pollute the repo.
"""

from __future__ import annotations

import os
import tempfile

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

_SESSION_ROOT = tempfile.mkdtemp(prefix="dmd_era5_tpu_test_")
os.environ["DMD_ERA5_TPU_ROOT"] = _SESSION_ROOT

import jax  # noqa: E402

# Persistent compilation cache: the suite is compile-latency dominated
# — identical programs recompile per xdist worker and per run.  A shared
# on-disk cache lets every worker (and every warm rerun) reuse compiled
# executables.  Low thresholds: the suite's programs are many and
# individually cheap to compile.  JAX_COMPILATION_CACHE_DIR, when set,
# wins (JAX reads it itself).
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        os.environ.get(
            "JAX_TEST_CACHE_DIR",
            os.path.join(tempfile.gettempdir(), "dmd_era5_tpu_jax_cache_tests"),
        ),
    )
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def session_root() -> str:
    return _SESSION_ROOT


@pytest.fixture()
def rng() -> np.random.Generator:
    return np.random.default_rng(0)


@pytest.fixture()
def gpu_device():
    """The first GPU device; skips the test where the process has none.

    Decided here, at run time, never at import or collection: every
    xdist worker must collect the same tests.
    """
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip(
            "needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu"
        )
    return gpus[0]


# ---- shared config dicts (mirroring the reference conftest fixture style,
# /root/reference/tests/conftest.py) -----------------------------------------

BASE_DOWNLOAD_CONFIG = {
    "source_path": "gs://gcp-public-data-arco-era5/ar/"
    "1959-2022-full_37-1h-0p25deg-chunk-1.zarr-v2",
    "start_datetime": "2019-01-01T00",
    "end_datetime": "2019-01-02T00",
    "delta_time": "1h",
    "variables": "temperature",
    "levels": "1000",
}

BASE_SVD_CONFIG = {
    **BASE_DOWNLOAD_CONFIG,
    "svd_type": "standard",
    "delay_embedding": 2,
    "mean_center": True,
    "scale": False,
    "n_components": 10,
    "save_data_matrix": True,
}


@pytest.fixture()
def download_config() -> dict:
    return dict(BASE_DOWNLOAD_CONFIG)


@pytest.fixture()
def svd_config() -> dict:
    return dict(BASE_SVD_CONFIG)
