"""A/B of the occupancy pool pass on the GPU: the Pallas (Triton) kernel vs
the XLA formulation, alone on a populated pool and end to end in the pool
presets.

    python tools/occupancy_ab.py [--presets dynamic static multi]

End to end, each preset runs both steps (``use_pallas_occupancy`` on and
off) over the same frames in turns (on, off, off, on; 10 frames a turn
after 3 warm-up frames) and reports the median frame time of each.  Alone,
it times the kernel at several block shapes and the XLA pass on the pool
the kernel-on run ended with.
"""

import argparse
import dataclasses
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import jax  # noqa: E402

import dspmap_tpu as dm  # noqa: E402
from dspmap_tpu.ops.occupancy import _pool_pass_xla  # noqa: E402
from dspmap_tpu.ops.pallas.occupancy import occupancy_pool_pass  # noqa: E402
from dspmap_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from dspmap_tpu.utils.drive import init_and_step, street_frames  # noqa: E402


def median_ms(fn, *args, n=5, batch=20):
    """Per-call time with ``batch`` calls in flight between syncs, median
    over ``n`` batches."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        for _ in range(batch):
            out = fn(*args)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / batch)
    return 1e3 * statistics.median(times)


def end_to_end(cfg, turn=10, warm=3):
    frames = street_frames(cfg, warm + 2 * turn)
    runs = {}
    for on in (True, False):
        c = dataclasses.replace(cfg, use_pallas_occupancy=on)
        state, step = init_and_step(c)
        runs[on] = [state, jax.jit(step, donate_argnums=0), []]

    def play(on, fs, record=True):
        r = runs[on]
        for f in fs:
            t0 = time.perf_counter()
            r[0], out = r[1](r[0], f)
            jax.block_until_ready((r[0], out))
            if record:
                r[2].append(time.perf_counter() - t0)

    for on in (True, False):
        play(on, frames[:warm], record=False)
    first, second = frames[warm:warm + turn], frames[warm + turn:]
    play(True, first)
    play(False, first)
    play(False, second)
    play(True, second)
    return ({on: 1e3 * statistics.median(r[2]) for on, r in runs.items()},
            runs[True][0].particles)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--presets", nargs="+",
                    default=["dynamic", "static", "multi"])
    args = ap.parse_args()
    enable_compile_cache()
    jax.config.update("jax_threefry_partitionable", True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.splitlines()[0].strip()
    print(f"card: {card}", flush=True)
    presets = dm.shipped_presets()
    for name in args.presets:
        cfg, _ = presets[name]
        ms, pool = end_to_end(cfg)
        print(f"{name} end to end: kernel {ms[True]:.4f} ms/frame, "
              f"xla {ms[False]:.4f} ms/frame (medians of 20 frames)",
              flush=True)
        S, V = pool.flags.shape
        xla = jax.jit(_pool_pass_xla, static_argnums=1)
        line = f"{name} alone [S={S} V={V}]: xla {median_ms(xla, pool, cfg):.4f} ms"
        for block, warps in ((128, 4), (256, 4), (512, 4), (256, 8)):
            t = median_ms(lambda p: occupancy_pool_pass(
                p, cfg, block=block, num_warps=warps), pool)
            line += f"; kernel block={block} warps={warps} {t:.4f} ms"
        print(line, flush=True)


if __name__ == "__main__":
    main()
