"""Quick ablation bench: flagship step with/without the admission-control
cond and the metrics reductions (structural-overhead probes).  Runs on the
default JAX device; prints the median frame time of each variant."""

import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import jax  # noqa: E402

import dspmap_tpu as dm  # noqa: E402
from dspmap_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from dspmap_tpu.utils.drive import init_and_step, street_frames  # noqa: E402


def bench(cfg, with_metrics, admission, n_warm=3, n_bench=30):
    state, step = init_and_step(cfg, with_metrics=with_metrics,
                                admission_control=admission)
    step = jax.jit(step, donate_argnums=0)
    times = []
    for i, f in enumerate(street_frames(cfg, n_warm + n_bench)):
        t0 = time.perf_counter()
        state, out = step(state, f)
        jax.block_until_ready((state, out))
        if i >= n_warm:
            times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def main():
    enable_compile_cache()
    jax.config.update("jax_threefry_partitionable", True)
    cfg = dm.example_node_settings(dm.dsp_dynamic())
    print(f"device={jax.devices()[0].device_kind}", flush=True)
    for wm, ac in [(True, True), (False, True), (True, False),
                   (False, False)]:
        ms = bench(cfg, wm, ac)
        print(f"with_metrics={wm} admission={ac}: {ms:.3f} ms/frame (median)",
              flush=True)


if __name__ == "__main__":
    main()
