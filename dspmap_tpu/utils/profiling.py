"""Tracing/profiling helpers (the reference's instrumentation is clock()
prints + a /map_update_time topic, SURVEY.md section 5.1).

* :func:`timed_steps` -- wall time per frame, each frame ending in
  ``jax.block_until_ready``,
* :func:`trace` -- context manager around ``jax.profiler``,
* :func:`summarize_device_trace` -- device time per GPU kernel from a
  captured trace.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    with jax.profiler.trace(log_dir):
        yield


def timed_steps(step, state, frames, sync_every: int = 1):
    """Run ``step`` over ``frames`` returning (state, wall_seconds_per_frame).

    ``sync_every=1`` gives per-frame latency; larger values amortize the
    sync cost for throughput measurements.
    """
    walls = []
    t0 = time.perf_counter()
    for i, frame in enumerate(frames):
        state, out = step(state, frame)
        if (i + 1) % sync_every == 0:
            jax.block_until_ready((state, out))
            walls.append((time.perf_counter() - t0) / sync_every)
            t0 = time.perf_counter()
    return state, walls


def _gpu_kernel_events(log_dir: str):
    """``(file, [(hlo_op, kernel, start_ns, duration_ns), ...])`` for the
    kernel events on the GPU planes' stream lines of the newest
    ``.xplane.pb`` that ``jax.profiler`` wrote under ``log_dir``."""
    files = sorted(glob.glob(f"{log_dir}/plugins/profile/*/*.xplane.pb"))
    if not files:
        raise FileNotFoundError(f"no trace under {log_dir}")
    data = jax.profiler.ProfileData.from_file(files[-1])
    events = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                op = str(dict(ev.stats).get("hlo_op", ev.name))
                events.append((op, ev.name, ev.start_ns, ev.duration_ns))
    if not events:
        raise ValueError(f"no GPU kernel events in {files[-1]}")
    return files[-1], events


def device_busy_share(log_dir: str) -> float:
    """Share of the traced window (first kernel start to last kernel end)
    in which at least one kernel ran on the GPU."""
    _, events = _gpu_kernel_events(log_dir)
    spans = sorted((s, s + d) for _, _, s, d in events)
    busy, end = 0.0, spans[0][0]
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / max(end - spans[0][0], 1.0)


def summarize_device_trace(log_dir: str, top: int = 25):
    """Device time per kernel from the newest trace under ``log_dir``.

    Sums the durations of the GPU kernel events, keyed by the HLO op that
    launched them (the kernel name when the event carries none).  Returns
    ``[(ms, hlo_op, kernel), ...]`` sorted by time, longest first.  Raises
    if the trace holds no GPU kernel events."""
    _, events = _gpu_kernel_events(log_dir)
    agg = collections.Counter()
    for op, kernel, _, dur in events:
        agg[(op, kernel)] += dur / 1e6
    return sorted(
        ((ms, op, kernel) for (op, kernel), ms in agg.items()), reverse=True
    )[:top]
