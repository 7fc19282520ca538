"""Pytree checkpointing to HDF5.

Checkpoint/resume for long iterative solves (SURVEY.md section 5: the
reference's only "resume" is artifact caching; this build adds
in-run checkpoints inside the LM variable-projection solver, see
models.optdmd.varpro_lm_checkpointed).  Flat pytrees of arrays/scalars
are stored with their tree structure, so restore returns the exact
object shape.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import numpy as np

__all__ = ["save_pytree", "load_pytree"]


def save_pytree(path: str | Path, tree, metadata: dict | None = None) -> None:
    """Write a pytree of arrays/scalars to an HDF5 checkpoint."""
    import h5py

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    with h5py.File(path, "w") as f:
        f.attrs["treedef"] = str(treedef)
        f.attrs["n_leaves"] = len(leaves)
        if metadata:
            f.attrs["metadata"] = json.dumps(metadata)
        for i, leaf in enumerate(leaves):
            arr = np.asarray(jax.device_get(leaf))
            f.create_dataset(f"leaf_{i}", data=arr)


def load_pytree(path: str | Path, like=None):
    """Load a checkpoint; with ``like`` given, restore its tree structure
    (leaves replaced by the stored arrays, in flatten order)."""
    import h5py

    path = Path(path)
    with h5py.File(path, "r") as f:
        n = int(f.attrs["n_leaves"])
        leaves = [f[f"leaf_{i}"][()] for i in range(n)]
        meta = (
            json.loads(f.attrs["metadata"]) if "metadata" in f.attrs else None
        )
    if like is not None:
        _, treedef = jax.tree_util.tree_flatten(like)
        return jax.tree_util.tree_unflatten(treedef, leaves), meta
    return leaves, meta
