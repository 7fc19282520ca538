"""Worked examples run in CI (review r2 missing #5).

The reference ships ``examples/notebook_test.ipynb`` but never executes
it in CI; here both shipped examples — the demo script and the
quickstart notebook — are executed end-to-end in hermetic subprocesses
(fresh DMD_ERA5_TPU_ROOT, CPU backend) so a drifting example is a test
failure, not a user bug report.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _example_env(root: str) -> dict[str, str]:
    env = dict(os.environ)
    env["DMD_ERA5_TPU_ROOT"] = root
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # single-device is fine and faster here
    return env


# pin the backend inside the subprocess too, so examples stay hermetic
# on machines with a (possibly busy) accelerator
_FORCE_CPU = "import jax; jax.config.update('jax_platforms', 'cpu')\n"


def test_demo_pipeline_script_runs():
    with tempfile.TemporaryDirectory() as root:
        runner = (
            _FORCE_CPU
            + "import runpy; runpy.run_path("
            + repr(str(REPO / "examples" / "demo_pipeline.py"))
            + ", run_name='__main__')"
        )
        proc = subprocess.run(
            [sys.executable, "-c", runner],
            cwd=REPO,
            env=_example_env(root),
            capture_output=True,
            text=True,
            timeout=900,
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "continuous eigenvalues" in proc.stdout
        assert "DMD residual" in proc.stdout
        assert "forecast field" in proc.stdout
        # the run must have versioned artifacts into the hermetic store
        assert (Path(root) / "store" / "objects").is_dir()


def test_quickstart_notebook_executes():
    """Execute every code cell of the notebook in one namespace.

    No jupyter kernel in this image, so the cells are exec'd
    sequentially in a subprocess — same semantics for a linear
    notebook, and it keeps the example hermetic.
    """
    nb = json.loads((REPO / "examples" / "quickstart.ipynb").read_text())
    cells = [
        "".join(c["source"])
        for c in nb["cells"]
        if c["cell_type"] == "code"
    ]
    assert len(cells) >= 4
    runner = _FORCE_CPU + "\n\n".join(
        cell for cell in cells if not cell.lstrip().startswith("%")
    )
    with tempfile.TemporaryDirectory() as root:
        # cell 1 reads <root>/config.ini; artifacts land in the tmp root
        (Path(root) / "config.ini").write_text(
            (REPO / "config.ini").read_text()
        )
        proc = subprocess.run(
            [sys.executable, "-c", runner],
            cwd=REPO,
            env=_example_env(root),
            capture_output=True,
            text=True,
            timeout=900,
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "singular values:" in proc.stdout
        assert "alpha =" in proc.stdout


def test_demo_out_of_core_script_runs():
    with tempfile.TemporaryDirectory() as root:
        runner = (
            _FORCE_CPU
            + "import runpy; runpy.run_path("
            + repr(str(REPO / "examples" / "demo_out_of_core.py"))
            + ", run_name='__main__')"
        )
        proc = subprocess.run(
            [sys.executable, "-c", runner],
            cwd=REPO,
            env=_example_env(root),
            capture_output=True,
            text=True,
            timeout=900,
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "out-of-core factors agree with dense numpy." in proc.stdout
