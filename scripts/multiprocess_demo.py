"""Multi-process distributed demo: the multi-host execution pattern.

Launches (or participates in) an N-process JAX cluster over local CPU
collectives (gloo) — the same ``jax.distributed.initialize`` + global
mesh + shard_map code path a multi-host cluster uses, so the
framework's multi-host story is exercisable on one machine:

    python scripts/multiprocess_demo.py            # launches 2 workers
    python scripts/multiprocess_demo.py <id> <n>   # worker entry

Each process owns one shard of the snapshot matrix (its "host-local"
rows), the cluster runs the distributed randomized SVD, and process 0
checks the result against the host oracle.
"""

from __future__ import annotations

import os
import subprocess
import sys


def worker(process_id: int, num_processes: int) -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    port = os.environ.get("DMD_DEMO_PORT", "12633")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=num_processes,
        process_id=process_id,
    )
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from dmd_era5_tpu.ops.svd import randomized_svd
    from dmd_era5_tpu.parallel import make_mesh

    mesh = make_mesh()  # all global devices on the space axis
    n_dev = len(jax.devices())
    assert n_dev == num_processes, (n_dev, num_processes)

    s_rows, t_cols, k = 512, 32, 4
    rng = np.random.default_rng(0)
    x = (
        rng.standard_normal((s_rows, 8)) @ rng.standard_normal((8, t_cols))
    ).astype(np.float32)

    # each process contributes only its own row block (host-local data)
    rows_per = s_rows // n_dev
    local = x[process_id * rows_per : (process_id + 1) * rows_per]
    sharding = NamedSharding(mesh, P("space", None))
    local_dev = jax.device_put(local, jax.local_devices()[0])
    global_x = jax.make_array_from_single_device_arrays(
        (s_rows, t_cols), sharding, [local_dev]
    )

    res = randomized_svd(global_x, k, mesh=mesh, seed=0)
    s_local = np.asarray(jax.device_get(res.s))
    if process_id == 0:
        s_host = np.linalg.svd(x, compute_uv=False)[:k]
        ok = np.allclose(s_local, s_host, rtol=1e-2)
        print(f"[p0] distributed svd over {num_processes} processes: "
              f"s={np.round(s_local, 2)} match={ok}")
        if not ok:
            sys.exit(1)
    jax.distributed.shutdown()


def launch(num_processes: int = 2) -> None:
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, str(i), str(num_processes)],
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )
        for i in range(num_processes)
    ]
    codes = [p.wait(timeout=300) for p in procs]
    if any(codes):
        raise SystemExit(f"worker exit codes: {codes}")
    print("multiprocess demo OK")


if __name__ == "__main__":
    if len(sys.argv) == 3:
        worker(int(sys.argv[1]), int(sys.argv[2]))
    else:
        launch()
