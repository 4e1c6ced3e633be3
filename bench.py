"""Benchmark: map updates per second of the DSP-map step on one NVIDIA GPU.

The default run measures the flagship DSP-Dynamic configuration
(``include/dsp_dynamic.h:38-50``: 66x66x40 voxels @ 0.15 m, 3 deg pyramids,
9 particles/voxel) fed by the synthetic street scene at the reference node's
input budget (<=5000 points/frame, ``src/map_sim_example.cpp:48``).  Each
frame is timed on the host clock around the jitted, donated step up to
``block_until_ready``.  It prints ONE JSON line: {"metric", "value", "unit",
"vs_baseline", "particles_per_sec", "frame_ms", "device", "card"}, where
``device`` is what JAX reports and ``card`` the name and power limit that
``nvidia-smi`` reports.

``--all`` measures every shipped preset (``dspmap_tpu.shipped_presets``)
and adds them to the line under "configs".

Baselines: the reference's single-core per-frame update times, measured by
compiling its headers against the stub toolchain in tools/oracle
(BASELINE.md): BASELINE_MEASURED.json for the flagship; static 36.1 ms and
multi-neighbor 33.9 ms from the same harness.

The run is one process.  It refuses to run without a GPU and exits non-zero
on any failure.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent))

import jax  # noqa: E402

import dspmap_tpu as dm  # noqa: E402
from dspmap_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from dspmap_tpu.utils.drive import init_and_step, street_frames  # noqa: E402

#: reference single-core ms/frame per variant (tools/oracle, BASELINE.md)
REF_MS = {"static": 36.1, "multi": 33.9}


def bench_config(cfg, n_sensors=1, n_warmup=3, n_bench=30, seed=0):
    """(median frame ms, alive after the last frame) over ``n_bench``
    frames after ``n_warmup`` warm-up frames."""
    state, step = init_and_step(cfg, n_sensors)
    step = jax.jit(step, donate_argnums=0)
    frames = street_frames(cfg, n_warmup + n_bench, n_sensors, seed=seed)
    times = []
    for i, f in enumerate(frames):
        t0 = time.perf_counter()
        state, out = step(state, f)
        jax.block_until_ready((state, out))
        if i >= n_warmup:
            times.append(time.perf_counter() - t0)
        if not bool(out.accepted):
            raise RuntimeError(f"frame {i} rejected")
    return 1e3 * statistics.median(times), int(out.metrics["alive"])


def main() -> None:
    device = jax.devices()[0]
    if device.platform != "gpu":
        sys.exit(f"bench: no GPU (JAX found {device.platform})")
    enable_compile_cache()
    jax.config.update("jax_threefry_partitionable", True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.splitlines()[0].strip()

    presets = dm.shipped_presets()
    cfg, _ = presets["dynamic"]
    ms, alive = bench_config(cfg)
    ups = 1e3 / ms
    baseline = json.loads(
        (Path(__file__).parent / "BASELINE_MEASURED.json").read_text()
    )["updates_per_sec"]
    result = {
        "metric": "map_updates_per_sec",
        "value": round(ups, 2),
        "unit": "updates/s (66x66x40 @ 0.15m, <=5000 pts/frame)",
        "vs_baseline": round(ups / baseline, 2),
        "particles_per_sec": round(ups * alive),
        "frame_ms": ms,
        "device": {"platform": device.platform, "kind": device.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }
    if "--all" in sys.argv:
        detail = {"dynamic": {"frame_ms": ms, "alive": alive}}
        for name, (c, n_sensors) in presets.items():
            if name == "dynamic":
                continue
            m, a = bench_config(
                c, n_sensors, n_bench=10 if name == "large_urban" else 30)
            detail[name] = {"frame_ms": m, "alive": a}
            if name in REF_MS:
                detail[name]["vs_reference_cpu"] = round(REF_MS[name] / m, 2)
            print(f"# {name}: {json.dumps(detail[name])}", file=sys.stderr)
        result["configs"] = detail
    print(json.dumps(result))


if __name__ == "__main__":
    main()
