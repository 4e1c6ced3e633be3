"""Capture a device trace of the full step on the GPU and print the
per-kernel hotspot table and the device's busy share.

    python tools/trace_step.py --variant dynamic --logdir traces/dynamic
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import jax  # noqa: E402

import dspmap_tpu as dm  # noqa: E402
from dspmap_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from dspmap_tpu.utils.drive import init_and_step, street_frames  # noqa: E402
from dspmap_tpu.utils.profiling import (  # noqa: E402
    device_busy_share, summarize_device_trace)


def main():
    presets = dm.shipped_presets()
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="dynamic", choices=list(presets))
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--logdir", default=None,
                    help="trace directory (default: traces/<variant>)")
    args = ap.parse_args()
    logdir = args.logdir or str(
        Path(__file__).parent.parent / "traces" / args.variant)

    enable_compile_cache()
    jax.config.update("jax_threefry_partitionable", True)
    cfg, n_sensors = presets[args.variant]
    state, step = init_and_step(cfg, n_sensors)
    step = jax.jit(step, donate_argnums=0)
    frames = street_frames(cfg, args.frames + 5, n_sensors)
    for f in frames[:5]:
        state, out = step(state, f)
    jax.block_until_ready((state, out))

    t0 = time.perf_counter()
    with jax.profiler.trace(logdir):
        for f in frames[5:]:
            state, out = step(state, f)
        jax.block_until_ready((state, out))
    wall = (time.perf_counter() - t0) / args.frames
    print(f"variant={args.variant} device={jax.devices()[0].device_kind} "
          f"~{wall * 1e3:.3f} ms/frame (wall, traced)")
    print(f"device busy share: {device_busy_share(logdir):.4f}")

    total = 0.0
    for ms, op, kernel in summarize_device_trace(logdir, args.top):
        per = ms / args.frames
        total += per
        print(f"{per:8.4f} ms  {op:<40.40} {kernel:.60}")
    print(f"{'':8}     total listed: {total:.4f} ms/frame")


if __name__ == "__main__":
    main()
