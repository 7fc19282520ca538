"""Decomposition stage: truncated SVD of the preprocessed ERA5 slice.

Behavioral parity with the reference stage
(/root/reference/src/dmd_era5/era5_svd/era5_svd.py:42-478): three-level
cache (workdir attr-match -> versioned store -> compute), the preprocess
chain (subset vars -> slice levels -> resample -> standardize -> flatten
-> delay-embed -> tile mean/std across delay blocks), decomposition, and
the packaged results dataset — with the decomposition itself running on
the device mesh through ``ops.truncated_svd`` (distributed TSQR / sketch)
instead of numpy/sklearn in host RAM.

Run as ``python -m dmd_era5_tpu.pipeline.era5_svd``.
"""

from __future__ import annotations

import os
import time
from datetime import datetime
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from dmd_era5_tpu.core import config_parser, config_reader, log_and_print, setup_logger
from dmd_era5_tpu.ops import truncated_svd
from dmd_era5_tpu.parallel import AXIS_SPACE, mesh_from_config, shard_rows
from dmd_era5_tpu.pipeline.artifacts import add_data_to_store, retrieve_data_from_store
from dmd_era5_tpu.snapmat import (
    apply_delay_embedding,
    flatten_era5_variables,
    resample_era5_dataset,
    slice_era5_dataset,
    space_coord_to_level_lat_lon,
    standardize_data,
)
from dmd_era5_tpu.snapmat.transform import delay_embedded_coords
from dmd_era5_tpu.utils.io_h5 import load_fieldset, save_fieldset
from dmd_era5_tpu.utils.labels import Coord, Field, FieldSet

logger = setup_logger("ERA5-SVD", "era5_svd.log")

__all__ = [
    "add_config_attributes",
    "retrieve_era5_slice",
    "retrieve_svd_results",
    "resolve_svd_backend",
    "svd_on_era5",
    "combine_svd_results",
    "main",
]


def add_config_attributes(fs: FieldSet, parsed_config: dict) -> FieldSet:
    """Stamp decomposition provenance (reference era5_svd.py:42-66)."""
    fs.attrs["source_path"] = parsed_config["source_path"]
    fs.attrs["n_components"] = parsed_config["n_components"]
    fs.attrs["variables"] = list(parsed_config["variables"])
    fs.attrs["levels"] = list(parsed_config["levels"])
    fs.attrs["mean_center"] = int(parsed_config["mean_center"])
    fs.attrs["scale"] = int(parsed_config["scale"])
    fs.attrs["delay_embedding"] = parsed_config["delay_embedding"]
    fs.attrs["svd_type"] = parsed_config["svd_type"]
    fs.attrs["era5_slice_path"] = parsed_config["era5_slice_path"]
    fs.attrs["date_processed"] = datetime.now().isoformat()
    fs.attrs["save_data_matrix"] = int(parsed_config["save_data_matrix"])
    fs.attrs["forecast_holdout"] = int(
        parsed_config.get("forecast_holdout", 0)
    )
    return fs


def _as_str_list(value) -> list[str]:
    if isinstance(value, str):
        return [value]
    return [str(v) for v in value]


def _as_int_list(value) -> list[int]:
    if isinstance(value, (int, np.integer)):
        return [int(value)]
    return [int(v) for v in np.asarray(value).tolist()]


def check_era5_slice(fs: FieldSet, parsed_config: dict) -> bool:
    """Superset-tolerant slice match (reference era5_svd.py:101-114):
    the workdir slice is valid if the requested variables and levels are
    subsets of what it contains and the source matches."""
    attrs = fs.attrs
    want_vars = sorted(parsed_config["variables"])
    want_levels = sorted(parsed_config["levels"])
    have_vars = set(_as_str_list(attrs.get("variables", [])))
    have_levels = set(_as_int_list(attrs.get("levels", [])))
    return (
        want_vars == sorted(have_vars & set(want_vars))
        and want_levels == sorted(have_levels & set(want_levels))
        and parsed_config["source_path"] == attrs.get("source_path")
    )


def check_svd_results(fs: FieldSet, parsed_config: dict) -> bool:
    """Exact-config SVD match (reference era5_svd.py:178-188).

    Also rejects numerically corrupt artifacts (non-finite singular
    values) so a bad cached file is recomputed rather than served.
    """
    attrs = fs.attrs
    if "s" in fs.data_vars and not np.isfinite(
        np.asarray(fs["s"].data)
    ).all():
        return False
    return (
        parsed_config["source_path"] == attrs.get("source_path")
        and parsed_config["n_components"] == attrs.get("n_components")
        and list(parsed_config["variables"]) == _as_str_list(attrs.get("variables", []))
        and list(parsed_config["levels"]) == _as_int_list(attrs.get("levels", []))
        and int(parsed_config["mean_center"]) == attrs.get("mean_center")
        and int(parsed_config["scale"]) == attrs.get("scale")
        and parsed_config["delay_embedding"] == attrs.get("delay_embedding")
        and parsed_config.get("forecast_holdout", 0)
        == attrs.get("forecast_holdout", 0)
    )


def _retrieve(
    parsed_config: dict,
    use_store: bool,
    path_key: str,
    data_type: str,
    checker,
    label: str,
) -> tuple[FieldSet | None, bool]:
    """Shared workdir -> store retrieval ladder (era5_svd.py:130-228)."""
    retrieved_from_store = False

    def from_store() -> FieldSet | None:
        log_and_print(logger, f"Attempting to retrieve {label} from store...")
        try:
            retrieve_data_from_store(parsed_config, data_type=data_type)
            log_and_print(
                logger, f"{label} retrieved: {parsed_config[path_key]}"
            )
            fs = load_fieldset(parsed_config[path_key])
        except (FileNotFoundError, ValueError) as err:
            log_and_print(
                logger, f"Could not retrieve {label} from store: {err}", "warning"
            )
            return None
        # the store's match keys are a coarser filter than the full
        # config checker (and say nothing about corruption) — validate
        # the retrieved artifact exactly like a workdir hit
        if not checker(fs, parsed_config):
            log_and_print(
                logger,
                f"Store-retrieved {label} does not match configuration; "
                "recomputing.",
                "warning",
            )
            return None
        return fs

    if os.path.exists(parsed_config[path_key]):
        log_and_print(logger, f"{label} found in working directory.")
        fs = load_fieldset(parsed_config[path_key])
        if checker(fs, parsed_config):
            log_and_print(logger, f"{label} matches configuration.")
            return fs, retrieved_from_store
        log_and_print(logger, f"{label} does not match configuration.")
        if use_store:
            fs = from_store()
            return fs, fs is not None
        log_and_print(
            logger,
            f"{label} in working directory does not match configuration.",
            "warning",
        )
        return None, retrieved_from_store

    log_and_print(logger, f"{label} not found in working directory.", "warning")
    if use_store:
        fs = from_store()
        return fs, fs is not None
    return None, retrieved_from_store


def retrieve_era5_slice(
    parsed_config: dict, use_store: bool = False
) -> tuple[FieldSet | None, bool]:
    return _retrieve(
        parsed_config,
        use_store,
        "era5_slice_path",
        "era5_slice",
        check_era5_slice,
        "ERA5 slice",
    )


def retrieve_svd_results(
    parsed_config: dict, use_store: bool = False
) -> tuple[FieldSet | None, bool]:
    return _retrieve(
        parsed_config,
        use_store,
        "save_path",
        "era5_svd",
        check_svd_results,
        "SVD results",
    )


BUDGET_ENV_VAR = "DMD_ERA5_TPU_HBM_BUDGET_GB"
# share of the allocator's limit that the in-memory estimate may fill:
# the estimate counts X and two (S, k) factors in f32, not the transient
# copies of the in-memory routes (the bf16 hi/lo split of X, the f32
# sketch before its cast), which add about as much again
_BUDGET_FRACTION = 0.5


def device_memory_budget_gb(mesh: Mesh) -> float | None:
    """Per-device memory (GB) the in-memory SVD backends may plan for.

    ``DMD_ERA5_TPU_HBM_BUDGET_GB`` overrides; otherwise half of the
    first mesh device's ``memory_stats()["bytes_limit"]``.  None when
    the device reports no limit (the CPU): everything stays in memory.
    """
    override = os.environ.get(BUDGET_ENV_VAR)
    if override:
        return float(override)
    stats = mesh.devices.flat[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        return None
    return _BUDGET_FRACTION * limit / 1e9


def resolve_svd_backend(
    parsed_config: dict,
    mesh: Mesh,
    have_flat: bool = True,
) -> str:
    """Resolve ``svd_backend = auto`` against the config and the mesh.

    auto picks: the Hankel-operator path for delay d > 1 randomized
    fits (the embedded matrix never materializes on host or device —
    on a time-sharded mesh it runs grid-sharded with halo exchange),
    grid2d for d == 1 on a time-sharded mesh (randomized only — the
    exact path stays inmem with replicated time work and a warning),
    else inmem.
    """
    backend = parsed_config.get("svd_backend", "auto")
    svd_type = parsed_config["svd_type"]
    d = int(parsed_config.get("delay_embedding", 1))
    time_shards = mesh.shape.get("time", 1)
    if backend != "auto":
        if (
            backend == "grid2d"
            and d > 1
            and have_flat
            and svd_type == "randomized"
        ):
            # grid2d consumes the MATERIALIZED embedded matrix — with
            # d > 1 that is the exact d-fold host-RAM blowup
            # (/root/reference/src/dmd_era5/slice_tools/slice_tools.py:207-211)
            # the operator path exists to avoid.  The Hankel grid path
            # (hankel_randomized_svd_2d) computes the same grid-sharded
            # factorization without ever forming H_d(X).
            log_and_print(
                logger,
                "svd_backend='grid2d' with delay_embedding > 1 routes "
                "through the Hankel-operator grid path (the embedded "
                "matrix never materializes).",
            )
            return "hankel"
        return backend
    def over_hbm_budget() -> bool:
        # real-ERA5 scale guard: if the per-device share of the matrix
        # (f32) plus the factor arrays cannot fit device memory, route
        # out-of-core.  One week of 0.25-degree hourly ERA5 at 3 vars x
        # 5 levels is 15.6M rows — an in-memory f32 X alone is
        # 10.5 GB / device-share.
        n_rows = parsed_config.get("_matrix_rows")
        t_cols = parsed_config.get("_matrix_cols")
        if not (have_flat and n_rows and t_cols):
            return False
        budget_gb = device_memory_budget_gb(mesh)
        if budget_gb is None:
            return False
        # only the space axis splits one matrix's rows (data shards
        # independent fits and does not reduce per-device residency)
        space_shards = max(mesh.shape.get(AXIS_SPACE, 1), 1)
        k = parsed_config.get("n_components", 0) + 28
        per_device = n_rows * d / space_shards * (t_cols + 2 * k) * 4
        if per_device > budget_gb * 1e9:
            log_and_print(
                logger,
                f"matrix {n_rows * d} x {t_cols} exceeds the "
                f"{budget_gb:.0f} GB/device memory budget in memory — "
                "routing svd_backend=auto to the out-of-core streamed "
                "backend "
                + (
                    "(2-pass exact Gram route)."
                    if svd_type != "randomized"
                    else "(power-iteration schedule)."
                ),
            )
            return True
        return False

    if svd_type != "randomized":
        if time_shards > 1:
            log_and_print(
                logger,
                f"mesh has time={time_shards} but svd_type='standard' "
                "only shards over space — the time axis computes "
                "replicated work. Use svd_type='randomized' (backend "
                "grid2d) to use a time-sharded mesh.",
                "warning",
            )
        # standard + d > 1: the exact Hankel-operator path (embedded
        # Gram = banded shift-sum of the raw Gram) — no host H_d(X)
        if d > 1 and have_flat:
            return "hankel"
        if over_hbm_budget():
            return "streamed"  # exact 2-pass Gram route at this scale
        return "inmem"
    if d > 1 and have_flat:
        return "hankel"
    if time_shards > 1:
        return "grid2d"
    if over_hbm_budget():
        return "streamed"
    return "inmem"


def _svd_backend_hankel(
    da_flat: Field, parsed_config: dict, mesh: Mesh, d: int, k: int
):
    """Operator-form SVD of H_d(X): the embedded matrix never exists.

    randomized: single device -> ops.hankel.hankel_randomized_svd; a
    space-sharded mesh -> hankel_randomized_svd_sharded; a time-sharded
    (or full space x time grid) mesh -> hankel_randomized_svd_2d, where
    each device holds only its (S_loc, T_loc) block of the RAW matrix
    and delay windows cross shard boundaries through halo exchange of
    small factors — the SP production path (SURVEY.md section 7,
    hard part c).  standard: ops.hankel.hankel_exact_svd — exact
    deterministic triplets via the banded raw-Gram identity, single
    device or space-sharded (time shards compute replicated — the
    resolver warns).  Zero-row padding is neutral (zero rows of X are
    zero rows in every delay block of H and drop out of every Gram/QR
    product; the matching U rows are stripped per block); zero-column
    padding is excluded by the op's ``t_valid`` handling.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dmd_era5_tpu.ops.hankel import (
        hankel_exact_svd,
        hankel_randomized_svd_2d,
        hankel_randomized_svd_fused,
        hankel_randomized_svd_sharded,
    )

    x_flat = np.asarray(da_flat.data, dtype=np.float32)
    s_rows, t_cols = x_flat.shape
    gemm_dtype = (
        jnp.bfloat16
        if parsed_config.get("precision") == "bfloat16"
        else jnp.float32
    )
    n_space_shards = mesh.shape.get(AXIS_SPACE, 1)
    n_time_shards = mesh.shape.get("time", 1)
    if parsed_config["svd_type"] != "randomized":
        # exact path: space sharding only (replicated time work)
        if mesh.devices.size == 1 or n_space_shards == 1:
            res = hankel_exact_svd(jnp.asarray(x_flat), d, k)
            return np.asarray(res.U), np.asarray(res.s), np.asarray(res.V)
        xs, _ = shard_rows(x_flat, mesh)
        s_pad = xs.shape[0]
        res = hankel_exact_svd(xs, d, k, mesh=mesh, axis_name=AXIS_SPACE)
        u = np.asarray(res.U)
        if s_pad != s_rows:  # strip the pad rows inside each delay block
            u = u.reshape(d, s_pad, -1)[:, :s_rows].reshape(d * s_rows, -1)
        return u, np.asarray(res.s), np.asarray(res.V)
    if n_time_shards > 1:
        pad_r = (-s_rows) % n_space_shards
        pad_c = (-t_cols) % n_time_shards
        x_pad = np.pad(x_flat, ((0, pad_r), (0, pad_c)))
        xs = jax.device_put(
            x_pad, NamedSharding(mesh, P(AXIS_SPACE, "time"))
        )
        res = hankel_randomized_svd_2d(
            xs, d, k, mesh, t_valid=t_cols,
            space_axis=AXIS_SPACE, time_axis="time",
        )
        u = np.asarray(res.U)
        if pad_r:  # strip the pad rows inside each delay block
            s_pad = s_rows + pad_r
            u = u.reshape(d, s_pad, -1)[:, :s_rows].reshape(d * s_rows, -1)
        return u, np.asarray(res.s), np.asarray(res.V)
    if mesh.devices.size == 1 or n_space_shards == 1:
        # fused single-chip path: one pass over X per power iteration
        # (ops.hankel.hankel_randomized_svd_fused)
        res = hankel_randomized_svd_fused(
            jnp.asarray(x_flat), d, k, gemm_dtype=gemm_dtype
        )
        return np.asarray(res.U), np.asarray(res.s), np.asarray(res.V)

    xs, _ = shard_rows(x_flat, mesh)
    s_pad = xs.shape[0]
    res = hankel_randomized_svd_sharded(
        xs, d, k, mesh, axis_name=AXIS_SPACE, gemm_dtype=gemm_dtype
    )
    u = np.asarray(res.U)
    if s_pad != s_rows:  # strip the pad rows inside each delay block
        u = u.reshape(d, s_pad, -1)[:, :s_rows].reshape(d * s_rows, -1)
    return u, np.asarray(res.s), np.asarray(res.V)


def _svd_backend_grid2d(
    x: np.ndarray, parsed_config: dict, mesh: Mesh, k: int, gemm_dtype
):
    """(space x time) grid-sharded randomized SVD of the embedded matrix.

    Ingest lands ROW-sharded — the layout the loader/packer emit, where
    each device (or host) reads a contiguous row block — and the
    factorization wants the (space x time) grid.  The layout change is
    the Ulysses-style reshard (SURVEY.md section 2b): a jitted identity
    with a grid out-sharding, which XLA lowers to an all-to-all over
    the ``time`` axis — the device-side analogue of the
    reference's nonexistent multi-GPU reshuffle.

    Rows and columns zero-pad up to the mesh axes; zero columns add
    nothing to any X-product, so U/s are unchanged and the padded tail
    of V is exactly zero and stripped.
    """
    from dmd_era5_tpu.ops.svd import randomized_svd_2d
    from dmd_era5_tpu.parallel.sharding import grid_sharded
    from dmd_era5_tpu.snapmat.loader import load_row_sharded

    n_rows, t_cols = x.shape
    sp = mesh.shape.get(AXIS_SPACE, 1)
    tp = mesh.shape.get("time", 1)
    pad_r = (-n_rows) % sp
    pad_c = (-t_cols) % tp
    if pad_r or pad_c:
        x = np.pad(x, ((0, pad_r), (0, pad_c)))
    xs_rows, _ = load_row_sharded(x, mesh, axis=AXIS_SPACE)  # ingest layout
    xs = jax.jit(lambda a: a, out_shardings=grid_sharded(mesh))(xs_rows)
    res = randomized_svd_2d(
        xs, k, mesh, space_axis=AXIS_SPACE, time_axis="time",
        gemm_dtype=gemm_dtype,
    )
    u = np.asarray(res.U)[:n_rows]
    v = np.asarray(res.V)[:, :t_cols]
    return u, np.asarray(res.s), v


def _svd_backend_streamed(
    da: Field | None,
    da_flat: Field | None,
    parsed_config: dict,
    d: int,
    k: int,
    onepass: bool,
    svd_type: str = "randomized",
):
    """Out-of-core backends: pack to disk, stream disk -> device.

    The packed file is written next to the stage artifact (d delay
    slabs of the flat matrix — the d-fold Hankel copy never exists in
    host RAM when ``da_flat`` is available) and removed after the fit.

    ``svd_type=standard`` takes the 2-pass exact Gram route
    (streamed_exact_gram_svd); ``randomized`` the n_iter + 2-pass
    power-iteration schedule; ``onepass`` the single-pass two-sided
    sketch.
    """
    from dmd_era5_tpu.pipeline.streamed_fit import (
        streamed_exact_gram_svd,
        streamed_onepass_svd,
        streamed_randomized_svd,
    )
    from dmd_era5_tpu.snapmat.loader import save_packed_matrix

    packed_path = Path(str(parsed_config["save_path"]) + ".packed.h5")
    if da_flat is not None:
        x = np.asarray(da_flat.data, dtype=np.float32)
        save_packed_matrix(packed_path, x, d=d)
    else:
        x = np.asarray(da.data, dtype=np.float32)
        save_packed_matrix(packed_path, x, d=1)
    block_rows = int(parsed_config.get("stream_block_rows", 1 << 16))
    info: dict = {}
    try:
        if onepass:
            res = streamed_onepass_svd(
                packed_path, k, block_rows=block_rows, info=info
            )
        elif svd_type == "standard":
            res = streamed_exact_gram_svd(
                packed_path, k, block_rows=block_rows
            )
        else:
            res = streamed_randomized_svd(packed_path, k, block_rows=block_rows)
    finally:
        packed_path.unlink(missing_ok=True)
    return np.asarray(res.U), np.asarray(res.s), np.asarray(res.V), info


def _svd_backend_inmem_multihost(
    da_flat: Field,
    parsed_config: dict,
    mesh: Mesh,
    d: int,
    k: int,
    svd_type: str,
    gemm_dtype,
):
    """Multi-process inmem route: per-process hyperslab reads.

    Each host never touches rows outside its shards: process 0 writes
    the packed (delay-slab) matrix to the shared filesystem, every
    process hyperslab-reads ONLY the row blocks its addressable devices
    own (snapmat.loader.load_row_sharded), and the factorization runs
    on the global mesh.  The small factors come back replicated; the
    row-sharded U is all-gathered on device (replicated out-sharding)
    for packaging.
    """
    from jax.experimental import multihost_utils

    from dmd_era5_tpu.parallel.sharding import replicated
    from dmd_era5_tpu.snapmat.loader import load_row_sharded, save_packed_matrix

    packed = Path(str(parsed_config["save_path"]) + ".packed.h5")
    if jax.process_index() == 0:
        save_packed_matrix(
            packed, np.asarray(da_flat.data, dtype=np.float32), d=d
        )
    multihost_utils.sync_global_devices("era5_svd: packed matrix written")
    try:
        xs, n_rows = load_row_sharded(packed, mesh, axis=AXIS_SPACE)
        res = truncated_svd(
            xs,
            k,
            svd_type=svd_type,
            mesh=mesh,
            axis_name=AXIS_SPACE,
            gemm_dtype=gemm_dtype,
        )
        # replicate U across processes so every host can package the
        # artifact (device all-gather; order-safe regardless of the
        # process -> mesh-coordinate assignment)
        u_repl = jax.jit(lambda u: u, out_shardings=replicated(mesh))(res.U)
        u = np.asarray(u_repl)[:n_rows]
        s, v = np.asarray(res.s), np.asarray(res.V)
    finally:
        multihost_utils.sync_global_devices("era5_svd: packed matrix read")
        if jax.process_index() == 0:
            packed.unlink(missing_ok=True)
    return u, s, v


def svd_on_era5(
    da: Field | None,
    parsed_config: dict,
    mesh: Mesh | None = None,
    da_flat: Field | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Truncated SVD of the preprocessed snapshot matrix on the mesh.

    Dispatcher semantics extend the reference's two-branch ``svd_type``
    switch (era5_svd.py:230-263) with the config-selectable execution
    backends (``svd_backend``): inmem (row-sharded TSQR / sketch),
    hankel (delay operators), grid2d (space x time grid sharding),
    streamed / onepass (out-of-core).  ``da`` is the materialized
    embedded matrix (may be None for operator/out-of-core backends when
    ``da_flat`` is given); ``da_flat`` the un-embedded (S, T) matrix.
    """
    svd_type = parsed_config["svd_type"]
    n_components = parsed_config["n_components"]
    d = int(parsed_config.get("delay_embedding", 1))
    gemm_dtype = (
        jnp.bfloat16
        if parsed_config.get("precision") == "bfloat16"
        else jnp.float32
    )
    if mesh is None:
        mesh = mesh_from_config(parsed_config)
    if da_flat is not None:
        parsed_config["_matrix_rows"] = int(da_flat.data.shape[0])
        parsed_config["_matrix_cols"] = int(da_flat.data.shape[1])
    backend = resolve_svd_backend(
        parsed_config, mesh, have_flat=da_flat is not None
    )
    multihost_inmem = backend == "inmem" and jax.process_count() > 1
    if da is None and backend in ("inmem", "grid2d") and not multihost_inmem:
        if da_flat is None:
            raise ValueError("svd_on_era5 needs da or da_flat")
        # materialize the embedding host-side only when the backend
        # actually consumes the embedded matrix
        from dmd_era5_tpu.snapmat.transform import delay_embed_np

        x_embedded = delay_embed_np(
            np.asarray(da_flat.data, dtype=np.float32), d
        )
    elif backend in ("inmem", "grid2d") and da is not None and not multihost_inmem:
        x_embedded = np.asarray(da.data, dtype=np.float32)
    else:
        x_embedded = None

    log_and_print(
        logger,
        f"Performing {svd_type} SVD (backend={backend}) on mesh "
        f"{dict(mesh.shape)}...",
    )
    t_start = time.perf_counter()

    if backend == "hankel":
        # serves BOTH svd_types: randomized sketch or the exact
        # banded-Gram path (_svd_backend_hankel dispatches on svd_type)
        if da_flat is None:
            raise ValueError(
                "svd_backend='hankel' needs the un-embedded matrix "
                "(da_flat); the stage main provides it."
            )
        u, s, v = _svd_backend_hankel(da_flat, parsed_config, mesh, d, n_components)
    elif backend == "grid2d":
        if svd_type != "randomized":
            raise ValueError("svd_backend='grid2d' requires svd_type='randomized'")
        u, s, v = _svd_backend_grid2d(
            x_embedded, parsed_config, mesh, n_components, gemm_dtype
        )
    elif backend in ("streamed", "onepass"):
        if backend == "onepass" and svd_type != "randomized":
            raise ValueError(
                "svd_backend='onepass' requires svd_type='randomized'"
            )
        if da is None and da_flat is None:
            raise ValueError("svd_on_era5 needs da or da_flat")
        u, s, v, stream_info = _svd_backend_streamed(
            da, da_flat, parsed_config, d, n_components,
            onepass=backend == "onepass", svd_type=svd_type,
        )
    elif backend == "inmem":
        if jax.process_count() > 1:
            if da_flat is None:
                raise ValueError(
                    "multi-process inmem SVD needs the un-embedded matrix "
                    "(da_flat); the stage main provides it."
                )
            u, s, v = _svd_backend_inmem_multihost(
                da_flat, parsed_config, mesh, d, n_components,
                svd_type, gemm_dtype,
            )
        else:
            n_rows = x_embedded.shape[0]
            xs, _ = shard_rows(x_embedded, mesh)
            res = truncated_svd(
                xs,
                n_components,
                svd_type=svd_type,
                mesh=mesh,
                axis_name=AXIS_SPACE,
                gemm_dtype=gemm_dtype,
            )
            # strip padding rows introduced by shard_rows
            u = np.asarray(res.U)[:n_rows]
            s, v = np.asarray(res.s), np.asarray(res.V)
    else:
        raise ValueError(f"SVD backend {backend} is not supported.")

    elapsed = time.perf_counter() - t_start
    if da_flat is not None:
        elems = int(np.prod(da_flat.shape)) * (1 if backend == "hankel" else d)
    else:
        elems = int(np.prod(da.shape))
    parsed_config["metrics"] = {
        "svd_backend": backend,
        "svd_seconds": round(elapsed, 4),
        "svd_gelem_per_s": round(elems / elapsed / 1e9, 6),
    }
    if backend in ("streamed", "onepass"):
        # onepass: posterior tail-error estimate into the artifact attrs
        parsed_config["metrics"].update(stream_info)
    log_and_print(
        logger,
        f"{svd_type} SVD complete ({backend}): {elapsed:.3f}s, "
        f"{elems / elapsed / 1e9:.4f} Gelem/s.",
    )
    return u, s, v


def combine_svd_results(
    U: np.ndarray,
    s: np.ndarray,
    V: np.ndarray,
    coords,
    **kwargs: Field | None,
) -> FieldSet:
    """Package U/s/V (+ optional X, X_mean, X_std) into a FieldSet,
    matching the reference schema (era5_svd.py:266-333)."""
    components = np.arange(U.shape[1])
    u_field = Field(
        U,
        dims=("space", "components"),
        coords={
            "space": Coord("space", coords["space"].values),
            "components": Coord("components", components),
            "original_variable": Coord(
                "space", coords["original_variable"].values
            ),
            "delay": Coord("space", coords["delay"].values),
        },
        name="U",
    )
    s_field = Field(
        s,
        dims=("components",),
        coords={"components": Coord("components", np.arange(s.shape[0]))},
        name="s",
    )
    v_field = Field(
        V,
        dims=("components", "time"),
        coords={
            "components": Coord("components", np.arange(V.shape[0])),
            "time": Coord("time", coords["time"].values),
        },
        name="V",
    )
    data_vars: dict[str, Field] = {"U": u_field, "s": s_field, "V": v_field}
    for key in ("X", "X_mean", "X_std"):
        value = kwargs.get(key)
        if value is not None:
            data_vars[key] = value.copy()
            data_vars[key].name = key
    return FieldSet(data_vars)


def _holdout_truth_fields(
    ds_holdout: FieldSet, persist_raw: FieldSet
) -> dict[str, Field]:
    """Package the raw physical holdout block for the DMD stage scorer.

    Returns ``holdout_truth`` (S, h) and ``holdout_persistence`` (S,) —
    the last raw train snapshot, the standard no-skill baseline — on a
    dedicated ``space_out`` axis (undelayed rows) with the
    level/lat/lon/variable row coordinates pre-split for HDF5 (the
    space axis of U is the d-times-larger embedded one, so these
    cannot share its coords).
    """
    truth_flat = flatten_era5_variables(ds_holdout)  # (S, h) raw
    persist_flat = flatten_era5_variables(persist_raw)  # (S, 1) raw
    tuples = truth_flat.coords["space"].values
    index = np.arange(len(tuples), dtype=int)
    coords = {
        "space_out": Coord("space_out", index),
        "level_out": Coord(
            "space_out", np.asarray([t[0] for t in tuples])
        ),
        "latitude_out": Coord(
            "space_out", np.asarray([t[1] for t in tuples])
        ),
        "longitude_out": Coord(
            "space_out", np.asarray([t[2] for t in tuples])
        ),
        "original_variable_out": Coord(
            "space_out", truth_flat.coords["original_variable"].values
        ),
    }
    truth = Field(
        np.asarray(truth_flat.data, dtype=np.float32),
        ("space_out", "time_holdout"),
        {
            **coords,
            "time_holdout": Coord(
                "time_holdout", truth_flat.coords["time"].values
            ),
        },
        name="holdout_truth",
    )
    persistence = Field(
        np.asarray(persist_flat.data, dtype=np.float32)[:, 0],
        ("space_out",),
        coords,
        name="holdout_persistence",
    )
    return {"holdout_truth": truth, "holdout_persistence": persistence}


def _tile_field_along_space(field: Field, d: int) -> Field:
    """Repeat a (space,) field d times along space — the mean/std tiling
    that matches the delay-embedded row layout (era5_svd.py:400-414)."""
    data = np.tile(np.asarray(field.data), d)
    coords = {
        "space": Coord("space", np.tile(field.coords["space"].values, d)),
        "original_variable": Coord(
            "space", np.tile(field.coords["original_variable"].values, d)
        ),
    }
    return Field(data, ("space",), coords, dict(field.attrs), field.name)


def main(
    config: dict | None = None,
    write_artifact: bool = False,
    use_store: bool = False,
    mesh: Mesh | None = None,
) -> tuple[FieldSet, bool, bool]:
    """SVD stage orchestration (reference era5_svd.py:336-452).

    Returns (svd_results, added_to_store, retrieved_from_store).
    """
    if config is None:
        config = config_reader("era5-svd")
    added_to_store = False
    parsed_config = config_parser(config, "era5-svd")

    try:
        svd_results, retrieved_from_store = retrieve_svd_results(
            parsed_config, use_store
        )
    except Exception as err:
        msg = f"Error retrieving SVD results: {err}"
        log_and_print(logger, msg, "error")
        raise Exception(msg) from err

    if svd_results is None:
        try:
            ds, _ = retrieve_era5_slice(parsed_config, use_store)
            if ds is None:
                if use_store:
                    msg = "Could not retrieve ERA5 slice from working directory or store."
                else:
                    msg = (
                        "Could not retrieve ERA5 slice from working directory. "
                        "Consider using the artifact store, if available."
                    )
                log_and_print(logger, msg, "error")
                raise FileNotFoundError(msg)
        except Exception as err:
            msg = f"Error retrieving ERA5 slice: {err}"
            log_and_print(logger, msg, "error")
            raise Exception(msg) from err

        try:
            ds = ds[parsed_config["variables"]]
            ds = slice_era5_dataset(ds, levels=parsed_config["levels"])
            ds = resample_era5_dataset(ds, parsed_config["delta_time"])

            # ---- forecast holdout: withhold the trailing snapshots
            # from EVERYTHING downstream (standardization statistics,
            # factors) so the DMD stage can score its rollout against
            # truly unseen truth.  The raw physical holdout fields (and
            # the last raw train snapshot, the persistence baseline)
            # ride along in the artifact.
            holdout = int(parsed_config.get("forecast_holdout", 0))
            ds_holdout = None
            persist_raw = None
            if holdout > 0:
                n_time = len(ds.coord("time").values)
                d_embed = parsed_config["delay_embedding"]
                min_train = max(
                    parsed_config["n_components"] + d_embed, d_embed + 1
                )
                if n_time - holdout < min_train:
                    raise ValueError(
                        f"forecast_holdout={holdout} leaves "
                        f"{n_time - holdout} train snapshots of {n_time}; "
                        f"need >= {min_train} (n_components + delay)."
                    )
                ds_holdout = ds.isel(
                    time=slice(n_time - holdout, None)
                )
                persist_raw = ds.isel(
                    time=slice(n_time - holdout - 1, n_time - holdout)
                )
                ds = ds.isel(time=slice(0, n_time - holdout))
                log_and_print(
                    logger,
                    f"Withholding final {holdout} snapshots from the "
                    f"fit ({n_time - holdout} train columns remain).",
                )

            if parsed_config["mean_center"] and parsed_config["scale"]:
                ds, ds_mean, ds_std = standardize_data(ds)
            elif parsed_config["mean_center"]:
                ds, ds_mean, ds_std = standardize_data(ds, scale=False)
            else:
                ds_mean = None
                ds_std = None
            da_flat = flatten_era5_variables(ds)
            d = parsed_config["delay_embedding"]

            # Materialize the d-times-larger embedded matrix on host
            # only when something actually consumes it: the inmem/grid2d
            # backends or a requested X artifact (save_data_matrix).
            # The operator/out-of-core backends work from the flat
            # matrix; the embedded coordinates are computed standalone.
            if mesh is None:
                stage_mesh = mesh_from_config(parsed_config)
            else:
                stage_mesh = mesh
            parsed_config["_matrix_rows"] = int(da_flat.data.shape[0])
            parsed_config["_matrix_cols"] = int(da_flat.data.shape[1])
            backend = resolve_svd_backend(parsed_config, stage_mesh)
            # multi-process inmem reads per-shard hyperslabs from the
            # packed delay-slab file — no host-RAM embedding either
            multihost_inmem = (
                backend == "inmem" and jax.process_count() > 1
            )
            need_host_embed = parsed_config["save_data_matrix"] or (
                backend in ("inmem", "grid2d") and not multihost_inmem
            )
            if need_host_embed:
                da = apply_delay_embedding(da_flat, d)
                embedded_coords = da.coords
            else:
                da = None
                embedded_coords = delay_embedded_coords(da_flat, d)

            da_mean = None
            da_std = None
            if ds_mean is not None:
                da_mean = flatten_era5_variables(ds_mean)
                if d > 1:
                    da_mean = _tile_field_along_space(da_mean, d)
                da_mean.name = "X_mean"
                if ds_std is not None:
                    da_std = flatten_era5_variables(ds_std)
                    if d > 1:
                        da_std = _tile_field_along_space(da_std, d)
                    da_std.name = "X_std"

            U, s, V = svd_on_era5(
                da, parsed_config, mesh=stage_mesh, da_flat=da_flat
            )
            if parsed_config["save_data_matrix"]:
                svd_results = combine_svd_results(
                    U, s, V, embedded_coords, X=da, X_mean=da_mean, X_std=da_std
                )
            else:
                svd_results = combine_svd_results(
                    U, s, V, embedded_coords, X_mean=da_mean, X_std=da_std
                )
            if ds_holdout is not None:
                for name, field in _holdout_truth_fields(
                    ds_holdout, persist_raw
                ).items():
                    svd_results.data_vars[name] = field
            svd_results = add_config_attributes(svd_results, parsed_config)
            for key, value in parsed_config.get("metrics", {}).items():
                svd_results.attrs[key] = value
            svd_results = space_coord_to_level_lat_lon(svd_results)
        except Exception as err:
            msg = f"Error in the SVD on ERA5 process: {err}"
            log_and_print(logger, msg, "error")
            raise Exception(msg) from err

        if write_artifact:
            try:
                log_and_print(logger, "Writing SVD results...")
                save_fieldset(svd_results, parsed_config["save_path"])
                log_and_print(
                    logger, f"SVD results written to {parsed_config['save_path']}"
                )
            except Exception as err:
                msg = f"Error writing SVD results: {err}"
                log_and_print(logger, msg, "error")
                raise Exception(msg) from err
            if use_store:
                try:
                    log_and_print(logger, "Versioning SVD results...")
                    add_data_to_store(
                        parsed_config["save_path"], svd_results.attrs
                    )
                    log_and_print(logger, "SVD results versioned.")
                    added_to_store = True
                except Exception as err:
                    msg = f"Error versioning SVD results: {err}"
                    log_and_print(logger, msg, "error")
                    raise Exception(msg) from err

    return svd_results, added_to_store, retrieved_from_store


if __name__ == "__main__":
    main(write_artifact=True, use_store=True)
