"""Sharded snapshot-matrix loader.

The scalable replacement for the reference's in-memory numpy
flatten/embed chain (SURVEY.md section 2b, "Sharded snapshot-matrix
loader"): lays (level*lat*lon*var, time) rows across the devices of a
mesh, with each shard's rows read and placed independently — on a
multi-host pod every host touches only its own row blocks.

Design: the ingest stage packs fields into a **space-major** matrix
artifact once (native C++ packer: cache-blocked transpose + optional
bf16, dmd_era5_tpu/native/packer.cpp), so shard loading is a contiguous
HDF5 hyperslab read per device — no gather, no host Hankel (delay
embedding happens on device via ops.hankel).
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from dmd_era5_tpu.native import pack_space_time, row_stats
from dmd_era5_tpu.parallel.mesh import AXIS_SPACE
from dmd_era5_tpu.utils.labels import FieldSet

__all__ = [
    "SnapshotMeta",
    "build_snapshot_matrix",
    "save_packed_snapshot",
    "save_packed_matrix",
    "packed_info",
    "read_packed_rows",
    "load_row_sharded",
]


class SnapshotMeta(NamedTuple):
    """Row/column bookkeeping of a packed snapshot matrix."""

    variables: list[str]
    levels: np.ndarray
    latitudes: np.ndarray
    longitudes: np.ndarray
    times: np.ndarray  # datetime64

    @property
    def n_space_per_var(self) -> int:
        return len(self.levels) * len(self.latitudes) * len(self.longitudes)

    @property
    def n_rows(self) -> int:
        return self.n_space_per_var * len(self.variables)


def build_snapshot_matrix(
    fs: FieldSet,
    variables: list[str] | None = None,
    bf16: bool = False,
) -> tuple[np.ndarray, SnapshotMeta]:
    """FieldSet -> (space, time) matrix via the native packer.

    Row layout matches ``flatten_era5_variables`` exactly: per variable a
    row-major (level, latitude, longitude) block, variables concatenated
    (reference stack order, slice_tools.py:311,323-336).
    """
    variables = variables or fs.variables
    meta = SnapshotMeta(
        variables=list(variables),
        levels=np.asarray(fs.coord("level").values),
        latitudes=np.asarray(fs.coord("latitude").values),
        longitudes=np.asarray(fs.coord("longitude").values),
        times=np.asarray(fs.coord("time").values),
    )
    blocks = []
    for var in variables:
        field = fs[var].transpose("time", "level", "latitude", "longitude")
        arr = np.asarray(field.data, dtype=np.float32)
        t = arr.shape[0]
        # (T, L, A, O) C-contiguous == (T, n_space) with the required
        # (level, lat, lon) row-major stacking
        blocks.append(pack_space_time(arr.reshape(t, -1), bf16=bf16))
    return np.concatenate(blocks, axis=0), meta


def save_packed_snapshot(
    path: str | Path,
    x: np.ndarray,
    meta: SnapshotMeta,
    row_chunk: int = 4096,
) -> None:
    """Persist the packed matrix with row-chunked layout for shard reads."""
    import h5py

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        f.create_dataset(
            "X",
            data=x,
            chunks=(min(row_chunk, x.shape[0]), x.shape[1]),
        )
        f.attrs["bf16"] = int(x.dtype == np.uint16)
        f.create_dataset("variables", data=np.asarray(meta.variables, dtype=h5py.string_dtype()))
        f.create_dataset("levels", data=meta.levels)
        f.create_dataset("latitudes", data=meta.latitudes)
        f.create_dataset("longitudes", data=meta.longitudes)
        f.create_dataset(
            "times", data=meta.times.astype("datetime64[ns]").astype(np.int64)
        )


def save_packed_matrix(
    path: str | Path,
    x: np.ndarray,
    d: int = 1,
    row_chunk: int = 4096,
    bf16: bool = False,
) -> tuple[int, int]:
    """Persist a (coord-free) snapshot matrix, optionally delay-embedded.

    With ``d > 1`` the packed file holds H_d(X) — rows S*d, block j =
    ``x[:, j : j+T-d+1]`` (the snapmat/transform.py layout) — written as
    d hyperslab slabs of the raw (S, T) input, so the d-fold Hankel
    blowup never exists in host RAM.  The streamed/out-of-core SVD
    backends read this file row-block by row-block.

    Returns the packed (rows, cols).
    """
    import h5py

    if x.ndim != 2:
        raise ValueError("save_packed_matrix expects a 2-D (space, time) array")
    s_rows, t_cols = x.shape
    t_out = t_cols - d + 1
    if t_out < 1:
        raise ValueError("Delay embedding longer than the time series.")
    n_rows = s_rows * d
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    dtype = np.uint16 if bf16 else np.float32
    with h5py.File(path, "w") as f:
        dset = f.create_dataset(
            "X",
            shape=(n_rows, t_out),
            dtype=dtype,
            chunks=(min(row_chunk, n_rows), t_out),
        )
        f.attrs["bf16"] = int(bf16)
        f.attrs["delay_embedding"] = d
        for j in range(d):
            block = np.ascontiguousarray(x[:, j : j + t_out], dtype=np.float32)
            if bf16:
                block = pack_space_time(block.T, bf16=True)
            dset[j * s_rows : (j + 1) * s_rows, :] = block
    return n_rows, t_out


def packed_info(path: str | Path) -> tuple[tuple[int, int], SnapshotMeta, bool]:
    import h5py

    with h5py.File(path, "r") as f:
        shape = f["X"].shape
        bf16 = bool(f.attrs.get("bf16", 0))
        if "variables" in f:
            meta = SnapshotMeta(
                variables=[v.decode() for v in f["variables"][()]],
                levels=f["levels"][()],
                latitudes=f["latitudes"][()],
                longitudes=f["longitudes"][()],
                times=f["times"][()].astype("datetime64[ns]"),
            )
        else:
            # coord-free matrix (save_packed_matrix): bookkeeping lives
            # with the caller, the streamed readers only need the shape
            empty = np.empty(0)
            meta = SnapshotMeta(
                [], empty, empty, empty, np.empty(0, "datetime64[ns]")
            )
    return shape, meta, bf16


def read_packed_rows(path: str | Path, r0: int, r1: int) -> np.ndarray:
    """Contiguous row-block hyperslab read (a shard's local rows)."""
    import h5py

    with h5py.File(path, "r") as f:
        return f["X"][r0:r1, :]


def load_row_sharded(
    source: str | Path | np.ndarray,
    mesh: Mesh,
    axis: str = AXIS_SPACE,
    dtype=jnp.float32,
) -> tuple[jax.Array, int]:
    """Place a packed snapshot matrix row-sharded on the mesh.

    Each shard's rows are read (hyperslab for HDF5 sources) and placed
    on its device independently, then assembled into one global array —
    the single-process form of the multi-host pattern where every
    process calls this with its own addressable devices.

    Returns (global_array, original_rows) — rows are zero-padded up to a
    multiple of the shard count.
    """
    from_file = not isinstance(source, np.ndarray)
    if from_file:
        (n_rows, n_cols), _, bf16 = packed_info(source)
        if bf16:
            dtype = jnp.bfloat16
    else:
        n_rows, n_cols = source.shape
        if source.dtype == np.uint16:
            dtype = jnp.bfloat16

    n_shards = mesh.shape[axis]
    padded = ((n_rows + n_shards - 1) // n_shards) * n_shards
    rows_per_shard = padded // n_shards

    spec = P(axis, None)
    sharding = NamedSharding(mesh, spec)

    def shard_block(index: int) -> np.ndarray:
        r0 = index * rows_per_shard
        r1 = min(r0 + rows_per_shard, n_rows)
        if r1 <= r0:
            block = np.zeros((0, n_cols), dtype=np.float32)
        elif from_file:
            block = read_packed_rows(source, r0, r1)
        else:
            block = source[r0:r1]
        if block.shape[0] < rows_per_shard:
            pad = np.zeros(
                (rows_per_shard - block.shape[0], n_cols), dtype=block.dtype
            )
            block = np.concatenate([block, pad], axis=0)
        return block

    # One buffer per addressable device in the sharding
    arrays = []
    for device, idx in sharding.addressable_devices_indices_map(
        (padded, n_cols)
    ).items():
        row_slice = idx[0]
        shard_index = (row_slice.start or 0) // rows_per_shard
        block = shard_block(shard_index)
        if block.dtype == np.uint16:
            block = block.view(np.dtype(jnp.bfloat16))
        arrays.append(
            jax.device_put(jnp.asarray(block, dtype=dtype), device)
        )
    global_arr = jax.make_array_from_single_device_arrays(
        (padded, n_cols), sharding, arrays
    )
    return global_arr, n_rows


def host_row_stats(x: np.ndarray, ddof: int = 0):
    """Native one-pass per-row (mean, std) — ingest-side statistics."""
    return row_stats(x, ddof=ddof)
