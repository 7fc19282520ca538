"""Numerical-safety and determinism checks.

The analogue of the reference's "sanitizers" (SURVEY.md
section 5: warnings-as-errors + mypy only): NaN trapping via JAX debug
flags, finiteness assertions over pytrees, and a determinism harness
that reruns a function and compares checksums — the practical test for
"deterministic collectives" on a mesh.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import jax
import numpy as np

__all__ = ["debug_nans", "assert_finite", "tree_checksum", "check_deterministic"]


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Trap NaN production inside jitted code for the scope."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def assert_finite(tree, name: str = "value") -> None:
    """Raise if any leaf of a pytree contains NaN/Inf."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arr = np.asarray(jax.device_get(leaf))
        if not np.all(np.isfinite(arr)):
            n_bad = int(np.size(arr) - np.sum(np.isfinite(arr)))
            raise FloatingPointError(
                f"{name}{jax.tree_util.keystr(path)} has {n_bad} non-finite "
                f"values (shape {arr.shape})"
            )


def tree_checksum(tree) -> float:
    """Deterministic scalar digest of a pytree of arrays."""
    total = 0.0
    for leaf in jax.tree_util.tree_leaves(tree):
        arr = np.asarray(jax.device_get(leaf), dtype=np.float64)
        if np.iscomplexobj(arr):
            arr = np.abs(arr)
        total += float(np.sum(arr * np.arange(1, arr.size + 1).reshape(arr.shape) % 97))
    return total


def check_deterministic(fn: Callable, *args, runs: int = 2) -> bool:
    """Run fn repeatedly and require bit-identical outputs.

    The collectives contract: a fixed mesh + fixed inputs must reproduce
    exactly (XLA collectives are deterministic; this guards against
    accidental nondeterminism like unseeded RNG or atomics).
    """
    outs = []
    for _ in range(runs):
        out = fn(*args)
        outs.append(
            [np.asarray(jax.device_get(x)) for x in jax.tree_util.tree_leaves(out)]
        )
    first = outs[0]
    for other in outs[1:]:
        for a, b in zip(first, other):
            if not np.array_equal(a, b, equal_nan=True):
                return False
    return True


def enable_float64() -> None:
    """Opt into float64 on CPU oracles (never on the device hot path)."""
    jax.config.update("jax_enable_x64", True)
