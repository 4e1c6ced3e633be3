"""Weak-scaling rehearsal: particles/sec of the map-parallel step at mesh
sizes 1..N on virtual CPU devices (a run on several GPUs uses the same
program; virtual-device numbers bound overheads only).

Weak scaling: the map volume grows with the mesh (nz = 8 * n_devices), so
per-device work is constant; reported efficiency = rate_N / (N * rate_1).

Usage: python bench_scaling.py [--devices 1 2 4 8] [--frames 10]
       [--impl gspmd|shardmap]

``--impl shardmap`` runs the hand-scheduled collective path
(parallel/shard_step.py) instead of the GSPMD-partitioned jit; comparing
the two on the same mesh separates the two programs' overheads
(collective *transport* cost needs real devices).
"""

import argparse
import json
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--impl", choices=["gspmd", "shardmap"], default="gspmd")
    args = ap.parse_args()

    import os
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={max(args.devices)}"
    )
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_threefry_partitionable", True)
    import jax.numpy as jnp
    import dspmap_tpu as dm
    from dspmap_tpu.parallel import make_mesh, shard_state, state_shardings
    from dspmap_tpu.utils import sim

    results = {}
    for n_dev in args.devices:
        cfg = dm.dsp_dynamic(
            nx=32, ny=32, nz=8 * n_dev,
            max_input_points=2048,
            mover_capacity=8192,
            pyramid_slot_capacity=64,
            max_clusters=8,
        )
        mesh = make_mesh(n_dev)
        state = shard_state(dm.init_state(cfg, jax.random.key(0)), mesh)
        if args.impl == "shardmap":
            from dspmap_tpu.parallel import make_shardmap_step

            step = make_shardmap_step(cfg, mesh)
        else:
            step = jax.jit(
                dm.make_step(cfg),
                in_shardings=(state_shardings(mesh, state), None),
                donate_argnums=0,
            )
        frames = []
        for pts, n, pos, quat, t in sim.generate_sequence(
            args.frames + 2, cfg, seed=0
        ):
            frames.append(dm.Frame(jnp.asarray(pts), jnp.int32(n),
                                   jnp.asarray(pos), jnp.asarray(quat),
                                   jnp.asarray(t)))
        for f in frames[:2]:
            state, out = step(state, f)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for f in frames[2:]:
            state, out = step(state, f)
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        ups = args.frames / dt
        slots = cfg.voxel_num * cfg.slots_per_voxel
        results[n_dev] = {
            "updates_per_sec": round(ups, 2),
            "slot_throughput_per_sec": round(ups * slots, 0),
            "voxels": cfg.voxel_num,
        }
        print(f"devices={n_dev}: {ups:.2f} updates/s "
              f"({ups * slots/1e6:.1f}M slots/s)", flush=True)

    base = results[args.devices[0]]["slot_throughput_per_sec"] / args.devices[0]
    for n_dev, r in results.items():
        r["weak_scaling_efficiency"] = round(
            r["slot_throughput_per_sec"] / (n_dev * base), 3
        )
    print(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
