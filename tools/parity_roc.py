"""Distribution-level parity vs the compiled reference: occupancy ROC over
a threshold sweep, and future-status calibration.

* ROC: the oracle is replayed once per occupancy threshold (it thresholds
  internally, run_oracle.py); our weight grid is read once per frame and
  thresholded post-hoc at the same values.  Agreement = chamfer fractions
  at 1.6 voxel over steady-state frames -- ours-matched is a precision
  proxy, ref-matched a recall proxy, so the pair swept over thresholds
  traces the operating curve.
* Future calibration: per frame, the future-status accumulator for each
  horizon tau is compared against the map's own realized occupancy tau
  later; predictions are binned by accumulated weight and each bin reports
  the empirical hit rate (monotone increasing = calibrated ranking).  The
  oracle's final-frame future grid is compared on the same frame directly.

Usage: python tools/parity_roc.py [--frames 60] [--seeds 3 4]
Appends the report to docs/PARITY.md.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools" / "oracle"))

THRESHOLDS = [0.1, 0.2, 0.4, 0.7, 1.0, 1.5]


def chamfer(a, b, tol):
    if len(a) == 0 or len(b) == 0:
        return float(len(a) == len(b)), float(len(a) == len(b))
    d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
    return float((d.min(1) <= tol).mean()), float((d.min(0) <= tol).mean())


def replay_ours(cfg, frames, dm, jnp, jax):
    """One replay; returns per-frame (weights, centers, future, occupied@t)."""
    state = dm.init_state(cfg, jax.random.key(0))
    step = jax.jit(dm.make_step(cfg))
    recs = []
    for pts, n, pos, quat, t in frames:
        fr = dm.Frame(jnp.asarray(pts), jnp.int32(n), jnp.asarray(pos),
                      jnp.asarray(quat), jnp.asarray(np.float32(t)))
        state, out = step(state, fr)
        occ, centers, future, weight, state = dm.read_occupancy(
            state, cfg, 0.2
        )
        recs.append({
            "weight": np.asarray(weight),
            "centers": np.asarray(centers),
            "future": np.asarray(future),
            "pos": np.asarray(pos),
        })
    return recs


#: per-variant (preset name, frames, seeds, steady) -- the 1-degree multi
#: oracle is the heaviest reference configuration, so its sweep is shorter
VARIANTS = {
    "dynamic": ("dsp_dynamic", 60, [3, 4], 15),
    "static": ("dsp_static", 40, [3], 12),
    "multi": ("dsp_dynamic_multi_neighbors", 20, [3], 8),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=None,
                    help="override the per-variant default")
    ap.add_argument("--seeds", type=int, nargs="+", default=None)
    ap.add_argument("--max-points", type=int, default=3000)
    ap.add_argument("--steady", type=int, default=None)
    ap.add_argument("--variant", default="dynamic", choices=sorted(VARIANTS))
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_threefry_partitionable", True)
    import jax.numpy as jnp
    import dspmap_tpu as dm
    from run_oracle import make_frames, run as run_oracle_variant

    preset_name, d_frames, d_seeds, d_steady = VARIANTS[args.variant]
    if args.frames is None:
        args.frames = d_frames
    if args.seeds is None:
        args.seeds = d_seeds
    if args.steady is None:
        args.steady = d_steady

    def run(_ignored, frames, max_points, threshold):
        return run_oracle_variant(args.variant, frames, max_points,
                                  threshold=threshold)

    cfg = dm.example_node_settings(
        getattr(dm, preset_name)(max_input_points=args.max_points))
    tol = cfg.voxel_resolution * 1.6
    taus = list(cfg.prediction_horizons)
    frame_dt = 0.1

    roc = {th: [] for th in THRESHOLDS}
    calib_hits = {tau: np.zeros(4) for tau in taus}
    calib_tot = {tau: np.zeros(4) for tau in taus}
    bins = np.array([0.0, 0.5, 1.0, 2.0, np.inf])
    oracle_future = []

    for seed in args.seeds:
        frames = make_frames(args.frames, args.max_points, seed=seed,
                             dense=False)
        recs = replay_ours(cfg, frames, dm, jnp, jax)

        # --- ROC sweep (one oracle subprocess per threshold) -----------
        for th in THRESHOLDS:
            ref = run("dynamic", frames, args.max_points, threshold=th)
            ms = []
            for i in range(args.steady, args.frames):
                ours = recs[i]["centers"][recs[i]["weight"] > th]
                ref_w = ref["frames"][i]["ego_centers"] + recs[i]["pos"]
                ms.append(chamfer(ours, ref_w, tol))
            roc[th].append(np.mean(ms, axis=0))
            if th == THRESHOLDS[0]:
                oracle_future.append(
                    (ref["future"], recs[-1]["future"])
                )

        # --- future-status calibration vs our own realized occupancy ---
        # World-space: the window moves with the sensor, so ego indices at
        # t and t+tau are different world voxels; predictions are matched
        # against realized occupied voxel CENTERS within 1.6 voxel.
        try:
            from scipy.spatial import cKDTree
        except Exception:
            cKDTree = None
        for k, tau in enumerate(taus):
            lead = int(round(tau / frame_dt))
            for i in range(args.steady, args.frames - lead):
                pred = recs[i]["future"][:, k]
                pc = recs[i]["centers"]
                realized = recs[i + lead]["centers"][
                    recs[i + lead]["weight"] > 0.2
                ]
                if len(realized) == 0:
                    continue
                b = np.digitize(pred, bins) - 1
                sel_any = pred > 0
                pts = pc[sel_any]
                if cKDTree is not None:
                    d, _ = cKDTree(realized).query(pts)
                else:
                    d = np.linalg.norm(
                        pts[:, None] - realized[None], axis=-1
                    ).min(1)
                hit = d <= tol
                bsel = b[sel_any]
                for bi in range(4):
                    m = bsel == bi
                    calib_tot[tau][bi] += m.sum()
                    calib_hits[tau][bi] += (m & hit).sum()

    lines = [
        "",
        f"## Distribution-level parity: {args.variant} "
        "(tools/parity_roc.py)",
        "",
        f"{args.variant} variant, {args.frames} frames x seeds {args.seeds}, "
        f"steady-state frames {args.steady}+.",
        "",
        "### Occupancy operating curve vs the compiled reference",
        "",
        "| threshold | ours-matched (precision) | ref-matched (recall) |",
        "|---|---|---|",
    ]
    for th in THRESHOLDS:
        m = np.mean(roc[th], axis=0)
        lines.append(f"| {th} | {m[0]:.3f} | {m[1]:.3f} |")
    lines += [
        "",
        "### Future-status calibration (prediction at t vs realized "
        "occupancy at t+tau)",
        "",
        "| tau | hit rate by predicted-weight bin "
        "(0-0.5 / 0.5-1 / 1-2 / >2) | n |",
        "|---|---|---|",
    ]
    for tau in taus:
        rates = [
            f"{calib_hits[tau][b] / max(calib_tot[tau][b], 1):.2f}"
            for b in range(4)
        ]
        lines.append(
            f"| {tau}s | {' / '.join(rates)} | {int(calib_tot[tau].sum())} |"
        )

    # oracle final-frame future comparison (same frame, same horizons)
    sims = []
    for ref_f, our_f in oracle_future:
        if ref_f.shape == our_f.shape:
            a = (ref_f > 0.2).ravel()
            # ours is ego-ordered (read_occupancy); oracle dumps ego order too
            b = (our_f > 0.2).ravel()
            inter, union = (a & b).sum(), (a | b).sum()
            sims.append(inter / max(union, 1))
    if sims:
        lines += [
            "",
            f"Final-frame future-grid IoU vs oracle (>0.2): "
            f"{np.mean(sims):.3f} (n={len(sims)} seeds; different RNG "
            "streams, so this bounds agreement from below).",
        ]

    report = "\n".join(lines) + "\n"
    print(report)
    with open(REPO / "docs" / "PARITY.md", "a") as f:
        f.write(report)
    print("appended to docs/PARITY.md")


if __name__ == "__main__":
    main()
