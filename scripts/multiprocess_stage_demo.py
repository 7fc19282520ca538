"""Multi-process STAGE execution: era5_svd.main across a 2-host cluster.

Extends scripts/multiprocess_demo.py from the raw-op demo to the full
config-driven pipeline stage: each process joins a
gloo-backed JAX cluster, process 0 stages the mock ERA5 slice into the
shared workdir, and then EVERY process runs ``era5_svd.main`` on the
global mesh.  The inmem backend detects the multi-process run and
switches to per-process hyperslab reads of the packed delay-slab matrix
(snapmat.loader.load_row_sharded) — no host ever materializes rows it
does not own.  Process 0 checks the stage factors against the host
numpy oracle.

    python scripts/multiprocess_stage_demo.py            # launches 2 workers
    python scripts/multiprocess_stage_demo.py <id> <n>   # worker entry
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
    port = os.environ.get("DMD_DEMO_PORT", "12644")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=num_processes,
        process_id=process_id,
    )
    import numpy as np
    from jax.experimental import multihost_utils

    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    from dmd_era5_tpu.core.config_parser import config_parser
    from dmd_era5_tpu.parallel import make_mesh
    from dmd_era5_tpu.pipeline import era5_download, era5_svd
    from dmd_era5_tpu.snapmat import create_mock_era5
    from dmd_era5_tpu.snapmat.transform import delay_embed_np
    from dmd_era5_tpu.utils.io_h5 import save_fieldset

    config = {
        "source_path": "gs://mock",
        "start_datetime": "2021-01-01T00",
        "end_datetime": "2021-01-02T00",
        "delta_time": "1h",
        "variables": "temperature",
        "levels": "1000",
        # exact TSQR path: deterministic, so the host oracle comparison
        # is tight (the randomized path is covered op-level by
        # scripts/multiprocess_demo.py)
        "svd_type": "standard",
        "svd_backend": "inmem",
        "delay_embedding": 2,
        "mean_center": True,
        "scale": False,
        "n_components": 8,
        "save_data_matrix": False,
    }
    parsed = config_parser(config, "era5-svd")

    if process_id == 0:
        fs = create_mock_era5(
            parsed["start_datetime"],
            parsed["end_datetime"],
            parsed["variables"],
            parsed["levels"],
            seed=11,
        )
        fs = era5_download.add_config_attributes(fs, parsed)
        save_fieldset(fs, parsed["era5_slice_path"])
    multihost_utils.sync_global_devices("stage demo: slice staged")

    mesh = make_mesh()  # all global devices on the space axis
    assert len(jax.devices()) == num_processes
    results, _, _ = era5_svd.main(config, write_artifact=False, mesh=mesh)

    if process_id == 0:
        # host oracle: standardize + embed + exact SVD of the same slice
        from dmd_era5_tpu.snapmat import (
            flatten_era5_variables,
            standardize_data,
        )
        from dmd_era5_tpu.utils.io_h5 import load_fieldset

        ds = load_fieldset(parsed["era5_slice_path"])
        ds, _, _ = standardize_data(ds[parsed["variables"]], scale=False)
        flat = np.asarray(
            flatten_era5_variables(ds).data, dtype=np.float32
        )
        x = delay_embed_np(flat, parsed["delay_embedding"])
        s_host = np.linalg.svd(x, compute_uv=False)[: parsed["n_components"]]
        s_stage = np.asarray(results["s"].data)
        u_stage = np.asarray(results["U"].data)
        ok_s = np.allclose(s_stage, s_host, rtol=1e-4)
        # POD subspace agreement with the oracle's left vectors
        u_host = np.linalg.svd(x, full_matrices=False)[0][
            :, : parsed["n_components"]
        ]
        qa, _ = np.linalg.qr(u_stage)
        qb, _ = np.linalg.qr(u_host)
        cos = np.linalg.svd(qa.T @ qb, compute_uv=False)
        ok_u = cos.min() > 1 - 1e-4
        print(
            f"[p0] era5_svd stage over {num_processes} processes: "
            f"s match={ok_s} subspace match={ok_u} "
            f"(min principal cosine {cos.min():.6f})"
        )
        if not (ok_s and ok_u):
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
    print("multiprocess stage demo OK")


if __name__ == "__main__":
    if len(sys.argv) == 3:
        worker(int(sys.argv[1]), int(sys.argv[2]))
    else:
        launch()
