"""Device-mesh construction and multi-host initialization.

The communication backend of the engine (SURVEY.md section 2b): the
reference is single-process with no comm layer at all, so this module is
designed for the mesh rather than ported.  All distributed code in the
package is written against a :class:`jax.sharding.Mesh` with up to three
named axes:

- ``space``: row-sharding of the snapshot matrix (tensor-parallel
  workhorse for the tall-skinny GEMM/QR path).
- ``time``: column-sharding for long time ranges (sequence-parallel
  analogue); the delay-embedding halo exchange and the all-to-all
  reshard live on this axis.
- ``data``: batches of independent decompositions (per-variable /
  per-window fits; data-parallel / expert-parallel analogue).

Axes of size one are always present so sharding specs compose uniformly.
"""

from __future__ import annotations

import math
import os
from typing import Mapping, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

AXIS_DATA = "data"
AXIS_SPACE = "space"
AXIS_TIME = "time"
MESH_AXES = (AXIS_DATA, AXIS_SPACE, AXIS_TIME)


# Environment markers whose presence means "this process is one worker
# of a managed multi-host launch" (SLURM and OpenMPI launchers).
# jax.distributed's cluster autodetection derives coordinator and
# process id from each of these, so an argless initialize() is the
# right call.
_CLUSTER_ENV_MARKERS = (
    "SLURM_JOB_ID",
    "OMPI_COMM_WORLD_SIZE",
)


def initialize_distributed() -> None:
    """Initialize multi-host JAX if this process is part of a pod launch.

    Resolution order (no-op if already initialized):

    1. Explicit ``JAX_COORDINATOR_ADDRESS`` + ``JAX_NUM_PROCESSES`` +
       ``JAX_PROCESS_ID`` — bespoke launchers (our multi-process CPU
       tests use this).
    2. Managed launchers (SLURM / OpenMPI, detected via their env
       markers): argless
       ``jax.distributed.initialize()`` so jax's cluster autodetection
       does the wiring.
    3. Otherwise: single-process, do nothing.
    """
    if jax.process_count() > 1:
        return
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coord:
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(os.environ["JAX_NUM_PROCESSES"]),
            process_id=int(os.environ["JAX_PROCESS_ID"]),
        )
        return
    if any(os.environ.get(marker) for marker in _CLUSTER_ENV_MARKERS):
        try:
            jax.distributed.initialize()
        except Exception as exc:  # pragma: no cover - env-specific
            # Detection markers can be present without a reachable
            # coordinator (e.g. SLURM_JOB_ID on a 1-task allocation);
            # a failed autodetect must not kill single-host runs.
            import logging

            logging.getLogger(__name__).warning(
                "jax.distributed autodetect failed (%s); "
                "continuing single-process",
                exc,
            )


def parse_mesh_shape(spec: str | Mapping[str, int] | None) -> dict[str, int] | None:
    """Parse a mesh-shape spec like ``"space=4,time=2"`` into a dict.

    ``None`` / ``"auto"`` return None (meaning: auto layout).
    """
    if spec is None or spec == "auto":
        return None
    if isinstance(spec, Mapping):
        shape = dict(spec)
    else:
        shape = {}
        for part in spec.split(","):
            name, _, value = part.partition("=")
            name = name.strip()
            if name not in MESH_AXES:
                raise ValueError(
                    f"Unknown mesh axis {name!r}; supported axes: {MESH_AXES}"
                )
            shape[name] = int(value)
    for name, size in shape.items():
        if size < 1:
            raise ValueError(f"Mesh axis {name} must be >= 1, got {size}")
    return shape


def make_mesh(
    shape: str | Mapping[str, int] | None = None,
    devices: Sequence[jax.Device] | None = None,
) -> Mesh:
    """Build a (data, space, time) mesh over the available devices.

    Auto layout puts every device on the ``space`` axis — the dominant
    axis for the tall-skinny factorizations.  An explicit shape must
    multiply to the device count; unspecified axes default to 1, with the
    ``space`` axis absorbing the remainder.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    parsed = parse_mesh_shape(shape)
    if parsed is None:
        sizes = {AXIS_DATA: 1, AXIS_SPACE: n, AXIS_TIME: 1}
    else:
        sizes = {axis: parsed.get(axis, 0) for axis in MESH_AXES}
        known = math.prod(s for s in sizes.values() if s > 0)
        missing = [axis for axis, s in sizes.items() if s == 0]
        if n % known != 0:
            raise ValueError(
                f"Mesh shape {parsed} incompatible with {n} devices"
            )
        remainder = n // known
        for axis in missing:
            sizes[axis] = 1
        if missing and remainder > 1:
            # absorb the remainder on space if unspecified, else on the
            # first unspecified axis
            target = AXIS_SPACE if AXIS_SPACE in missing else missing[0]
            sizes[target] = remainder
        if math.prod(sizes.values()) != n:
            raise ValueError(
                f"Mesh shape {sizes} does not cover {n} devices"
            )
    grid = np.asarray(devices).reshape(
        sizes[AXIS_DATA], sizes[AXIS_SPACE], sizes[AXIS_TIME]
    )
    return Mesh(grid, MESH_AXES)


def single_device_mesh(device: jax.Device | None = None) -> Mesh:
    device = device or jax.devices()[0]
    return make_mesh(devices=[device])


def mesh_from_config(parsed_config: Mapping[str, object]) -> Mesh:
    """Build the stage mesh from parsed config fields.

    ``mesh_shape`` gives the ICI factors; a non-None ``dcn_mesh_shape``
    (multislice) routes to :func:`make_hybrid_mesh` so the named axes
    combine DCN(outer) x ICI(inner) factors.
    """
    ici = parsed_config.get("mesh_shape", "auto")
    dcn = parsed_config.get("dcn_mesh_shape", None)
    if dcn is None:
        return make_mesh(ici)  # type: ignore[arg-type]
    return make_hybrid_mesh(ici, dcn)  # type: ignore[arg-type]


def make_hybrid_mesh(
    ici_shape: str | Mapping[str, int] | None = None,
    dcn_shape: str | Mapping[str, int] | None = None,
    devices: Sequence[jax.Device] | None = None,
    n_slices: int | None = None,
) -> Mesh:
    """Build a (data, space, time) mesh spanning multiple slices.

    Multislice topology: devices within one slice are connected by ICI
    (fast); slices talk over DCN (slow).  Each mesh axis combines a DCN
    factor (outer/major) with an ICI factor (inner/minor), the same
    convention as ``jax.experimental.mesh_utils.create_hybrid_device_mesh``
    — so a shard index along an axis first selects the slice, then the
    device within it, and collectives along an axis whose DCN factor is
    1 ride ICI only.

    Defaults follow the scaling-book recipe for this workload: the
    ``data`` axis (independent decompositions; only scalar losses cross
    it) spans DCN, and ``space`` — the GEMM/TSQR workhorse whose r x r /
    r x T factors psum every step — absorbs each slice's devices on ICI.

    ``n_slices`` overrides slice detection for virtual-device tests
    (contiguous equal groups); otherwise devices are grouped by their
    ``slice_index`` (one slice when the devices report none).
    """
    devices = list(devices if devices is not None else jax.devices())
    if n_slices is not None:
        if len(devices) % n_slices:
            raise ValueError(
                f"{len(devices)} devices not divisible into {n_slices} slices"
            )
        per = len(devices) // n_slices
        groups = [devices[i * per : (i + 1) * per] for i in range(n_slices)]
    else:
        by_slice: dict[int, list[jax.Device]] = {}
        for d in devices:
            by_slice.setdefault(getattr(d, "slice_index", 0), []).append(d)
        groups = [by_slice[i] for i in sorted(by_slice)]
    sizes = {len(g) for g in groups}
    if len(sizes) != 1:
        raise ValueError(f"Uneven slices: {sorted(len(g) for g in groups)}")

    def _resolve(
        spec: str | Mapping[str, int] | None, total: int, default_axis: str
    ) -> dict[str, int]:
        parsed = parse_mesh_shape(spec)
        if parsed is None:
            out = {axis: 1 for axis in MESH_AXES}
            out[default_axis] = total
            return out
        out = {axis: parsed.get(axis, 0) for axis in MESH_AXES}
        known = math.prod(s for s in out.values() if s > 0)
        if total % known:
            raise ValueError(f"shape {parsed} incompatible with {total}")
        rem = total // known
        missing = [axis for axis, s in out.items() if s == 0]
        for axis in missing:
            out[axis] = 1
        if rem > 1:
            if default_axis in missing:
                target = default_axis
            elif missing:
                target = missing[0]
            else:
                raise ValueError(f"shape {parsed} does not cover {total}")
            out[target] = rem
        if math.prod(out.values()) != total:
            raise ValueError(f"shape {out} does not cover {total}")
        return out

    dcn = _resolve(dcn_shape, len(groups), AXIS_DATA)
    ici = _resolve(ici_shape, len(groups[0]), AXIS_SPACE)
    # (Dd, Ds, Dt, Id, Is, It) -> interleave DCN-major per axis
    grid = np.asarray(
        [np.asarray(g).reshape([ici[a] for a in MESH_AXES]) for g in groups]
    ).reshape([dcn[a] for a in MESH_AXES] + [ici[a] for a in MESH_AXES])
    grid = grid.transpose(0, 3, 1, 4, 2, 5).reshape(
        [dcn[a] * ici[a] for a in MESH_AXES]
    )
    return Mesh(grid, MESH_AXES)
