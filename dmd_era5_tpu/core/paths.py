"""Project-root and artifact-path resolution.

The reference resolves its project root with ``pyprojroot.here()``
(/root/reference/src/dmd_era5/config_parser.py:5,196-216).  We avoid that
dependency: the root is resolved once per process by walking up from the
current working directory looking for repo markers, and can be overridden
with the ``DMD_ERA5_TPU_ROOT`` environment variable (which is what tests
use to redirect artifacts into a tmp dir without monkeypatching).
"""

from __future__ import annotations

import os
from pathlib import Path

_ROOT_MARKERS = ("pyproject.toml", ".git", "config.ini")

ROOT_ENV_VAR = "DMD_ERA5_TPU_ROOT"


def repo_root() -> Path:
    """Return the project root directory.

    Resolution order:
      1. ``DMD_ERA5_TPU_ROOT`` environment variable, if set.
      2. Nearest ancestor of the CWD containing a repo marker.
      3. The CWD itself.
    """
    env = os.environ.get(ROOT_ENV_VAR)
    if env:
        return Path(env).expanduser().resolve()
    cwd = Path.cwd().resolve()
    for candidate in (cwd, *cwd.parents):
        if any((candidate / marker).exists() for marker in _ROOT_MARKERS):
            return candidate
    return cwd


def data_dir(stage: str) -> Path:
    """Return (and create) the artifact directory for a pipeline stage."""
    d = repo_root() / "data" / stage
    d.mkdir(parents=True, exist_ok=True)
    return d


def logs_dir() -> Path:
    d = repo_root() / "logs"
    d.mkdir(parents=True, exist_ok=True)
    return d


COMPILE_CACHE_ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache() -> Path | None:
    """Turn on JAX's persistent compilation cache for a script run.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here (returns None).  Otherwise the cache lives at
    ``.jax_cache`` in the checkout, a fixed path (the path is part of
    the cache key, so a moving directory never hits) that ``.gitignore``
    lists.
    """
    if os.environ.get(COMPILE_CACHE_ENV_VAR):
        return None
    import jax

    cache = Path(__file__).resolve().parents[2] / ".jax_cache"
    jax.config.update("jax_compilation_cache_dir", str(cache))
    return cache
