"""Content-addressed artifact store with a human-readable version log.

Capability parity with the reference's DVC integration
(/root/reference/src/dmd_era5/dvc_tools.py:11-253) — versioned artifacts
keyed by content md5, a YAML sidecar log mapping each md5 to the config
attributes that produced it, and newest-match retrieval — redesigned to
be **side-effect-free**: the reference's retrieval checks out old .dvc
files into the git working tree (dvc_tools.py:217-218; SURVEY.md section
3.4 flags this), whereas here versions live in a local object store
(``<root>/store/objects/<md5>``) and retrieval only copies bytes into
the workdir path.  No git/DVC process boundary.

The sidecar log format (md5 -> attrs mapping, append-ordered) matches
the reference's (dvc_tools.py:39-42), so the version-multiplexing
behavior — many configs sharing one artifact filename — carries over.
``add_data_to_dvc`` / ``retrieve_data_from_dvc`` aliases keep the
reference's public names working.
"""

from __future__ import annotations

import hashlib
import os
import shutil
from datetime import datetime, timezone
from pathlib import Path

from dmd_era5_tpu.core.logging import log_and_print, setup_logger
from dmd_era5_tpu.core.paths import repo_root

logger = setup_logger("ArtifactStore", "artifact_store.log")

__all__ = [
    "file_md5",
    "add_data_to_store",
    "retrieve_data_from_store",
    "retrieve_latest_from_store",
    "retrieve_by_md5",
    "list_versions",
    "add_data_to_dvc",
    "retrieve_data_from_dvc",
    "push_to_remote",
    "fetch_from_remote",
]


def _objects_dir() -> Path:
    d = repo_root() / "store" / "objects"
    d.mkdir(parents=True, exist_ok=True)
    return d


def _remote_dir() -> Path | None:
    """Default remote object store, if configured.

    The analogue of the reference's default DVC remote
    (dvc_tools.py:95-116, Makefile:23-49): a second object directory —
    typically on shared/durable storage — that ``add`` pushes to and
    retrieval falls back to when the local cache was wiped.  Configured
    via the ``DMD_ERA5_TPU_REMOTE`` environment variable.
    """
    remote = os.environ.get("DMD_ERA5_TPU_REMOTE")
    return Path(remote) if remote else None


def push_to_remote(md5: str) -> bool:
    """Copy one object from the local store to the default remote.

    Returns True if pushed (or already present remotely), False when no
    remote is configured.  Mirrors the reference's push-on-add workflow
    (README.md:57-93: ``dvc push`` after ``add``).
    """
    remote = _remote_dir()
    if remote is None:
        return False
    remote.mkdir(parents=True, exist_ok=True)
    dst = remote / md5
    if not dst.exists():
        shutil.copy2(_objects_dir() / md5, dst)
        log_and_print(logger, f"Pushed {md5} to remote {remote}")
    return True


def fetch_from_remote(md5: str) -> bool:
    """Restore one object from the default remote into the local store.

    The reference's cache-miss path: ``dvc fetch`` from the default
    remote then checkout (dvc_tools.py:228-243).  Returns True if the
    object is now in the local store.
    """
    remote = _remote_dir()
    if remote is None:
        return False
    src = remote / md5
    if not src.exists():
        return False
    shutil.copy2(src, _objects_dir() / md5)
    log_and_print(logger, f"Fetched {md5} from remote {remote}")
    return True


def file_md5(path: str | Path, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while block := f.read(chunk):
            h.update(block)
    return h.hexdigest()


def _log_path(data_path: str | Path) -> Path:
    return Path(str(data_path) + ".yaml")


def add_data_to_store(data_path: str | Path, data_attrs: dict) -> str:
    """Version an artifact: copy into the object store and log its attrs.

    Returns the content md5.  Matches ``add_data_to_dvc`` +
    ``add_config_to_dvc_log`` semantics (dvc_tools.py:11-63) without the
    git staging side effect.
    """
    import yaml

    data_path = Path(data_path)
    md5 = file_md5(data_path)
    obj = _objects_dir() / md5
    if not obj.exists():
        shutil.copy2(data_path, obj)

    log_file = _log_path(data_path)

    def _to_yaml(v):
        # attrs re-loaded from HDF5 artifacts come back as numpy
        # arrays/scalars and byte strings — normalize to plain Python
        import numpy as _np

        if isinstance(v, _np.ndarray):
            return [_to_yaml(e) for e in v.tolist()]
        if isinstance(v, (_np.generic,)):
            return v.item()
        if isinstance(v, bytes):
            return v.decode()
        if isinstance(v, (list, tuple)):
            return [_to_yaml(e) for e in v]
        return v

    serializable = {k: _to_yaml(v) for k, v in data_attrs.items()}
    # append-time stamp: the handle for as-of time travel
    # (retrieve_data_from_store(..., as_of=...)) — the capability the
    # reference gets from git history over the DVC log
    # (dvc_tools.py:66-92,217-218)
    serializable["_store_logged_at"] = (
        datetime.now(timezone.utc).isoformat()
    )
    with open(log_file, "a") as f:
        yaml.safe_dump({md5: serializable}, f, sort_keys=False)
    log_and_print(logger, f"Versioned {data_path.name} as {md5}")
    push_to_remote(md5)
    return md5


_SLICE_MATCH_KEYS = ("variables", "levels", "source_path")
_SVD_MATCH_KEYS = (
    "variables",
    "levels",
    "source_path",
    "delay_embedding",
    "mean_center",
    "scale",
    "n_components",
    "forecast_holdout",
)
_DMD_MATCH_KEYS = _SVD_MATCH_KEYS + (
    "dmd_rank",
    "optimized",
    "forecast_steps",
    "bagging_trials",
    "multiresolution_levels",
    "mr_refit_rank",
    "control_input",
)

# Fields added after the store format shipped: entries logged by older
# builds lack them, and a missing key means the entry was produced with
# the default in force.
_MATCH_KEY_DEFAULTS = {
    "forecast_holdout": 0,
    "forecast_steps": 0,
    "bagging_trials": 0,
    "multiresolution_levels": 0,
    "mr_refit_rank": 0,
    "control_input": "none",
}


def _normalize(value):
    if isinstance(value, (list, tuple)):
        return sorted(map(str, value))
    if isinstance(value, bool):
        return int(value)
    return value


def _entry_matches(entry: dict, parsed_config: dict, keys) -> bool:
    for key in keys:
        default = _MATCH_KEY_DEFAULTS.get(key)
        have = entry.get(key, default)
        want = parsed_config.get(key, default)
        if have is None or want is None:
            return False
        if _normalize(have) != _normalize(want):
            return False
    return True


def _entry_visible_as_of(attrs: dict, index: int, as_of) -> bool:
    """Was this log entry already appended "as of" the given point?

    ``as_of`` is an int ordinal (0-based append index into the log —
    every entry, matching or not) or an ISO-8601 timestamp / datetime
    compared against the entry's ``_store_logged_at`` stamp.  Entries
    from logs written before time stamping are treated as older than
    any timestamp (always visible).
    """
    if as_of is None:
        return True
    # bool is an int subclass — True would silently mean "ordinal 1"
    if isinstance(as_of, bool):
        raise TypeError("as_of must be an int ordinal, str, or datetime")
    if isinstance(as_of, int):
        return index <= as_of
    when = (
        datetime.fromisoformat(as_of) if isinstance(as_of, str) else as_of
    )
    stamp = (attrs or {}).get("_store_logged_at")
    if stamp is None:
        return True
    logged = datetime.fromisoformat(stamp)
    # the stored stamp is UTC; a naive as_of is TREATED AS UTC (review
    # r4: stripping tzinfo from the stamp instead shifted visibility by
    # the caller's UTC offset)
    if when.tzinfo is None:
        when = when.replace(tzinfo=timezone.utc)
    if logged.tzinfo is None:
        logged = logged.replace(tzinfo=timezone.utc)
    return logged <= when


def retrieve_data_from_store(
    parsed_config: dict, data_type: str = "era5_slice", as_of=None
) -> Path:
    """Find the newest versioned artifact matching the config and place
    it at the workdir path.

    Matching semantics follow the reference (dvc_tools.py:171-207):
    slices match on variables/levels/source_path; SVD results
    additionally on delay_embedding/mean_center/scale/n_components.
    Raises FileNotFoundError if the log or object is missing, ValueError
    if no entry matches — the same error contract the callers catch
    (era5_svd.py:120-127).

    ``as_of`` restores the reference's time travel — "the version that
    was current at <point>" (git checkout of the .dvc file at a
    historical commit, dvc_tools.py:66-92,217-218): an int append
    ordinal or an ISO timestamp/datetime; later log entries are
    invisible to the match.
    """
    import yaml

    if data_type == "era5_slice":
        target = Path(parsed_config["era5_slice_path"])
        keys = _SLICE_MATCH_KEYS
    elif data_type == "era5_svd":
        target = Path(parsed_config["era5_svd_path"])
        keys = _SVD_MATCH_KEYS
    elif data_type == "era5_dmd":
        target = Path(parsed_config["era5_dmd_path"])
        keys = _DMD_MATCH_KEYS
    else:
        raise ValueError(f"Unsupported data_type: {data_type}")

    log_file = _log_path(target)
    if not log_file.exists():
        raise FileNotFoundError(f"No version log found at {log_file}")

    with open(log_file) as f:
        entries = list(yaml.safe_load_all(f))

    best_md5 = None
    index = 0
    for doc in entries:
        if not doc:
            continue
        for md5, attrs in doc.items():
            if _entry_visible_as_of(attrs, index, as_of) and _entry_matches(
                attrs or {}, parsed_config, keys
            ):
                best_md5 = md5  # keep the newest (last) visible match
            index += 1

    if best_md5 is None:
        raise ValueError(
            f"No versioned {data_type} matches the requested configuration"
            + (f" as of {as_of}." if as_of is not None else ".")
        )

    obj = _objects_dir() / best_md5
    if not obj.exists() and not fetch_from_remote(best_md5):
        raise FileNotFoundError(
            f"Object {best_md5} missing from store (log at {log_file})"
        )
    target.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy2(obj, target)
    log_and_print(logger, f"Retrieved {data_type} version {best_md5}")
    return target


def _type_keys(data_type: str):
    if data_type == "era5_slice":
        return _SLICE_MATCH_KEYS
    if data_type == "era5_svd":
        return _SVD_MATCH_KEYS
    if data_type == "era5_dmd":
        return _DMD_MATCH_KEYS
    raise ValueError(f"Unsupported data_type: {data_type}")


def list_versions(
    data_path: str | Path, parsed_config: dict | None = None,
    data_type: str = "era5_svd",
) -> list[tuple[str, dict]]:
    """All (md5, attrs) entries logged for an artifact path, in version
    order — optionally filtered to entries matching a config.

    The version-history API the reference gets from git time travel
    over the DVC log (dvc_tools.py:66-92): every historical version
    remains addressable, not just the newest match.
    """
    import yaml

    log_file = _log_path(data_path)
    if not log_file.exists():
        return []
    with open(log_file) as f:
        docs = list(yaml.safe_load_all(f))
    out = []
    keys = _type_keys(data_type)
    for doc in docs:
        for md5, attrs in (doc or {}).items():
            if parsed_config is None or _entry_matches(
                attrs or {}, parsed_config, keys
            ):
                out.append((md5, attrs or {}))
    return out


def retrieve_by_md5(md5: str, target: str | Path) -> Path:
    """Place one specific historical version at a workdir path.

    The reference achieves this with ``git show <rev>`` + dvc checkout
    (dvc_tools.py:217-218); here any version is directly addressable in
    the object store by its content md5 (falling back to the remote).
    """
    target = Path(target)
    obj = _objects_dir() / md5
    if not obj.exists() and not fetch_from_remote(md5):
        raise FileNotFoundError(f"Object {md5} not in store or remote")
    target.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy2(obj, target)
    log_and_print(logger, f"Retrieved version {md5} -> {target}")
    return target


def retrieve_latest_from_store(
    parsed_config: dict, data_type: str = "era5_svd"
) -> Path:
    """Newest store artifact matching the config across ALL version
    logs of the data type — the time window is free.

    ``retrieve_data_from_store`` looks only at the log of the config's
    own derived filename; incremental updates must instead find the
    newest PREFIX-window artifact of the same (source, variables,
    levels, preprocessing), whose filename embeds a different time
    range.  Scans the sibling logs oldest-modified first so the newest
    matching version wins, and places the artifact at the config's own
    workdir path.
    """
    import yaml

    if data_type == "era5_slice":
        target = Path(parsed_config["era5_slice_path"])
    elif data_type == "era5_svd":
        target = Path(parsed_config["era5_svd_path"])
    elif data_type == "era5_dmd":
        target = Path(parsed_config["era5_dmd_path"])
    else:
        raise ValueError(f"Unsupported data_type: {data_type}")
    keys = _type_keys(data_type)

    logs = sorted(
        target.parent.glob("*.yaml"), key=lambda p: p.stat().st_mtime
    )
    best_md5 = None
    for log_file in logs:
        with open(log_file) as f:
            docs = list(yaml.safe_load_all(f))
        for doc in docs:
            for md5, attrs in (doc or {}).items():
                if _entry_matches(attrs or {}, parsed_config, keys):
                    best_md5 = md5
    if best_md5 is None:
        raise ValueError(
            f"No versioned {data_type} matches the requested configuration."
        )
    return retrieve_by_md5(best_md5, target)


# Reference-compatible aliases (the reference exposes these names in its
# public API, /root/reference/src/dmd_era5/__init__.py:22-38).
add_data_to_dvc = add_data_to_store
retrieve_data_from_dvc = retrieve_data_from_store
