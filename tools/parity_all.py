"""ONE parity-regeneration ritual: rebuild
docs/PARITY.md from scratch -- the long-horizon no-decay table (>=300
frames, >=3 seeds, tools/parity_report.py) followed by the
distribution-level ROC sweeps + future-status calibration for ALL THREE
variants (tools/parity_roc.py).  Run this whenever the step's numerics
change so the front-page parity claims always have a same-HEAD artifact
behind them.

Usage: python tools/parity_all.py [--frames 300] [--seeds 3 4 5] [--quick]
(--quick: 100 frames / fewer ROC seeds, for smoke checks only.)
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def run(cmd):
    print("+", " ".join(cmd), flush=True)
    r = subprocess.run([sys.executable] + cmd, cwd=REPO)
    if r.returncode:
        sys.exit(r.returncode)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--seeds", type=int, nargs="+", default=[3, 4, 5])
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()

    frames = 100 if args.quick else args.frames
    run(["tools/parity_report.py", "--frames", str(frames), "--seeds",
         *map(str, args.seeds)])
    for variant in ("dynamic", "static", "multi"):
        cmd = ["tools/parity_roc.py", "--variant", variant]
        if args.quick:
            cmd += ["--seeds", "3"]
        run(cmd)
    print("docs/PARITY.md fully regenerated (long-horizon + ROC sweeps "
          "+ calibration, all variants)")


if __name__ == "__main__":
    main()
