"""Run the port's walkthrough, ``docs/walkthrough_torch.py`` (the steps of
``docs/walkthrough.py`` through ``coolpup-torch``, ``dividepups-torch``,
``plotpup-torch`` and the Python API on the CPU), in a subprocess."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def test_walkthrough_torch(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["TMPDIR"] = str(tmp_path)
    proc = subprocess.run(
        [sys.executable, str(REPO / "docs" / "walkthrough_torch.py")],
        capture_output=True, text=True, timeout=600, env=env, cwd=tmp_path,
    )
    assert proc.returncode == 0, (
        f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    assert "walkthrough_torch ok" in proc.stdout
