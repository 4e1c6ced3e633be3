"""Replay synthetic scenes through the compiled reference oracle.

Produces:
* BASELINE_MEASURED.json -- the reference's single-core map-update rate on
  this machine (the denominator for bench.py's vs_baseline),
* per-frame occupied-voxel world centers for stochastic-tolerance parity
  tests against the JAX build.

Usage: python tools/oracle/run_oracle.py [--frames N] [--variant dynamic]
"""

from __future__ import annotations

import argparse
import json
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))


def write_frames(path: Path, frames, max_points: int) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", len(frames), max_points))
        for pts, n, pos, quat, t in frames:
            f.write(struct.pack("<i", int(n)))
            f.write(np.asarray(pos, "<f4").tobytes())
            f.write(np.asarray(quat, "<f4").tobytes())
            f.write(struct.pack("<d", float(t)))
            f.write(np.asarray(pts[:n], "<f4").tobytes())


def read_results(path: Path):
    with open(path, "rb") as f:
        n_frames, voxel_num, horizons = struct.unpack("<iii", f.read(12))
        dims = struct.unpack("<iii", f.read(12))
        (res,) = struct.unpack("<f", f.read(4))
        frames = []
        for _ in range(n_frames):
            (wall,) = struct.unpack("<d", f.read(8))
            (n_occ,) = struct.unpack("<i", f.read(4))
            centers = np.frombuffer(f.read(12 * n_occ), "<f4").reshape(n_occ, 3)
            frames.append({"wall_s": wall, "ego_centers": centers})
        future = np.frombuffer(f.read(4 * voxel_num * horizons), "<f4").reshape(
            voxel_num, horizons
        )
    return {
        "frames": frames,
        "future": future,
        "dims": dims,
        "res": res,
        "voxel_num": voxel_num,
        "horizons": horizons,
    }


def make_frames(n_frames: int, max_points: int, seed: int = 0, dense: bool = True):
    from dspmap_tpu import dsp_dynamic, example_node_settings
    from dspmap_tpu.utils import sim

    cfg = example_node_settings(dsp_dynamic(max_input_points=max_points))
    scene = sim.street_scene(seed)
    rng = np.random.default_rng(seed + 1)
    frames = []
    for i in range(n_frames):
        t = i * 0.1
        pos = np.array([0.5 * t, 0.3 * np.sin(0.3 * t), 1.0], np.float32)
        yaw = 0.1 * np.sin(0.5 * t)
        quat = np.array(
            [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)], np.float32
        )
        pts, n = sim.render_frame(
            scene, pos, quat, t, rng, max_points,
            points_per_box=150 if not dense else 600,
            fov_h_deg=cfg.half_fov_h_deg, fov_v_deg=cfg.half_fov_v_deg,
        )
        frames.append((pts, n, pos, quat, t))
    return frames


def run(variant: str, frames, max_points: int, threshold: float = 0.2):
    tmp = REPO / "tools" / "oracle" / "tmp"
    tmp.mkdir(exist_ok=True)
    fin, fout = tmp / "frames.bin", tmp / f"out_{variant}.bin"
    write_frames(fin, frames, max_points)
    binary = REPO / "tools" / "oracle" / "bin" / f"oracle_{variant}"
    subprocess.run([str(binary), str(fin), str(fout), str(threshold)], check=True)
    return read_results(fout)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--max-points", type=int, default=5000)
    ap.add_argument("--variant", default="dynamic")
    ap.add_argument("--write-baseline", action="store_true")
    args = ap.parse_args()

    frames = make_frames(args.frames, args.max_points)
    res = run(args.variant, frames, args.max_points)
    walls = np.asarray([f["wall_s"] for f in res["frames"]])
    # skip the first frames (cold caches / map fill-in)
    steady = walls[5:] if len(walls) > 10 else walls
    ups = 1.0 / steady.mean()
    print(
        f"variant={args.variant} frames={len(walls)} "
        f"mean={steady.mean()*1e3:.2f}ms p50={np.median(steady)*1e3:.2f}ms "
        f"max={steady.max()*1e3:.2f}ms -> {ups:.1f} updates/s"
    )
    if args.write_baseline:
        out = {
            "updates_per_sec": round(float(ups), 2),
            "mean_frame_ms": round(float(steady.mean() * 1e3), 3),
            "variant": args.variant,
            "frames": int(len(walls)),
            "workload": "synthetic street scene, <=5000 pts/frame, node settings",
            "hardware": "single CPU core (this machine)",
        }
        (REPO / "BASELINE_MEASURED.json").write_text(json.dumps(out, indent=1))
        print("wrote BASELINE_MEASURED.json")


if __name__ == "__main__":
    main()
