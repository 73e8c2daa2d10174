"""``python -m repro_torch.scripts.chaos_smoke --device cpu``: the CI
script boots the launcher's HTTP server on the CPU over a starved paged
arena and attacks it: malformed requests, a slow-loris, mid-stream
disconnects, page exhaustion, a deadline storm, SIGTERM under load. It
exits 0 only when every check of its contract holds."""
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_chaos_smoke_script_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-u", "-m", "repro_torch.scripts.chaos_smoke",
         "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=300, cwd=ROOT)
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out
    assert "chaos_smoke: OK" in proc.stdout, out
