"""chip_smoke.py is a GPU-only check: on the CPU backend it must refuse to
run (exit non-zero) and print no result line."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_chip_smoke_refuses_cpu_backend():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs 1 GPU" in r.stderr
