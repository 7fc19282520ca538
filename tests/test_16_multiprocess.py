"""Multi-process distributed execution (the multi-host pattern).

Runs the 2-process gloo-backed distributed SVD demo in subprocesses —
the analogue of the reference's containerized tier-2 tests
(SURVEY.md section 4: "multi-process tests on a simulated mesh").
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = pytest.mark.tier2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_demo(script_name: str, ok_marker: str) -> None:
    script = Path(__file__).resolve().parents[1] / "scripts" / script_name
    env = {
        **os.environ,
        "JAX_PLATFORMS": "cpu",
        "DMD_DEMO_PORT": str(_free_port()),
        # workers must not inherit the 8-virtual-device flag: each
        # process contributes exactly one device to the cluster
        "XLA_FLAGS": "",
    }
    result = subprocess.run(
        [sys.executable, str(script)],
        env=env,
        capture_output=True,
        text=True,
        timeout=280,
    )
    assert result.returncode == 0, result.stdout + result.stderr
    assert ok_marker in result.stdout


def test_two_process_distributed_svd():
    _run_demo("multiprocess_demo.py", "multiprocess demo OK")


def test_two_process_era5_svd_stage():
    """The config-driven era5_svd STAGE across a 2-process cluster:
    per-process hyperslab reads (load_row_sharded), global-mesh TSQR,
    factors equal to the host oracle (review r1 item 5)."""
    _run_demo("multiprocess_stage_demo.py", "multiprocess stage demo OK")
