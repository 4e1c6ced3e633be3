"""Smoke test of the DSP-map step on NVIDIA GPUs.

    python chip_smoke.py              # one GPU: every shipped preset + checks
    python chip_smoke.py --four-gpus  # four GPUs: the sharded steps only

One GPU: the card's name and power limit; then, for each shipped preset at
full width (``dspmap_tpu.shipped_presets``), compile seconds, the median
frame time over 10 frames of the synthetic street scene, ``alive``,
``accepted`` and the occupied-voxel count, with behavioural checks; then
the comparisons of the GPU code with its references:

* the occupancy Pallas kernel vs the XLA pool pass on populated flagship and
  static pools (flags and counters exact, weights and fields to
  ``rtol=1e-6, atol=1e-9``);
* the measurement update's pair passes vs a float64 NumPy evaluation on rows
  of a real static and multi-neighbor frame (relative error <= 1e-4), beside
  the error of the expanded ``|a|^2+|b|^2-2a.b`` form at default precision;
* the same program on the GPU and on the CPU backend for frames 1-3 of a
  tiny and a medium map, each frame stepped on both from the same state.
  Only rounding differs (identical random bits): per-voxel ``weight_sum``
  within ``rtol=1e-4, atol=1e-5`` everywhere, occupied sets equal but for
  at most one voxel or 1% (``backend_check`` says why frames are not
  chained per backend).

``--four-gpus`` runs the map-parallel steps on a 4-GPU mesh against the
single-device step on the same frames, and nothing else.

Every check raises on failure, so the script exits non-zero and prints no
result line.  Without a GPU it refuses to run.  The last line of standard
output is one JSON object: ``{"ok": true, "device": {"platform": "gpu",
"kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dspmap_tpu as dm  # noqa: E402
from dspmap_tpu.ops.fov import register_fov  # noqa: E402
from dspmap_tpu.ops.occupancy import _pool_pass_xla  # noqa: E402
from dspmap_tpu.ops.pallas.occupancy import occupancy_pool_pass  # noqa: E402
from dspmap_tpu.ops.project import project_points  # noqa: E402
from dspmap_tpu.ops.update import (  # noqa: E402
    REF_PDF_CONST, gather_neighbors, pass1_sums, pass2_sums,
    scatter_neighbor_sum)
from dspmap_tpu.parallel import (  # noqa: E402
    make_mesh, make_sharded_step, make_shardmap_step, shard_state)
from dspmap_tpu.utils import sim  # noqa: E402
from dspmap_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from dspmap_tpu.utils.drive import init_and_step, street_frames  # noqa: E402


def require_gpus(n: int):
    """The JAX devices, or exit non-zero unless there are ``n`` GPUs."""
    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < n:
        print(f"chip_smoke: needs {n} GPU(s); JAX found "
              f"{len(devices)} {devices[0].platform} device(s)",
              file=sys.stderr)
        sys.exit(2)
    return devices


def card_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def same_tree(a, b) -> bool:

    def raw(x):
        if jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key):
            x = jax.random.key_data(x)
        return np.asarray(x)

    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(raw(x), raw(y)) for x, y in zip(la, lb))


# --------------------------------------------------------------- presets
def run_preset(name, cfg, n_sensors, n_frames=12, n_warm=2):
    """Compile and run one preset; returns its final state."""

    state, step = init_and_step(cfg, n_sensors)
    frames = street_frames(cfg, n_frames + 1, n_sensors)
    t0 = time.perf_counter()
    step = jax.jit(step, donate_argnums=0).lower(state, frames[0]).compile()
    compile_s = time.perf_counter() - t0

    times, alive, accepted = [], [], []
    for f in frames[:n_frames]:
        t0 = time.perf_counter()
        state, out = step(state, f)
        jax.block_until_ready((state, out))
        times.append(time.perf_counter() - t0)
        alive.append(out.metrics["alive"])
        accepted.append(out.accepted)
    alive = [int(a) for a in alive]
    accepted = [bool(a) for a in accepted]
    check(all(accepted), f"{name}: a frame was rejected")
    check(alive[-1] > alive[0] > 0, f"{name}: alive did not grow {alive}")

    if name == "dynamic":
        # frame admission: a bad quaternion is rejected and leaves the state
        # bit-identical (dsp_dynamic.h:193-208)
        last = frames[n_frames]
        bad = last._replace(quat=jnp.asarray([2.0, 0.0, 0.0, 0.0]))
        before = jax.tree.map(jnp.copy, state)
        after, out = step(jax.tree.map(jnp.copy, state), bad)
        check(not bool(out.accepted), "dynamic: bad quaternion accepted")
        check(same_tree(before, after), "dynamic: rejected frame moved state")
    if cfg.motion_model == "static":
        p = state.particles
        live = np.asarray(p.flags) != 0
        for v in (p.vx, p.vy, p.vz):
            check(not np.asarray(v)[live].any(), f"{name}: nonzero velocity")

    readout = jax.jit(dm.get_occupancy_map, static_argnums=(1, 2))
    occ, centers, _, state = readout(state, cfg, 0.2)
    occ = np.asarray(occ)
    centers = np.asarray(centers)[occ]
    t_last = float(np.asarray(frames[n_frames - 1].timestamp).ravel()[0])
    dist = sim.surface_distance(centers, sim.street_scene(0), t_last)
    on_surface = float(np.mean(dist <= 0.5)) if len(dist) else 0.0
    check(occ.sum() > 0, f"{name}: empty occupancy map")
    check(on_surface >= 0.9,
          f"{name}: only {on_surface:.3f} of occupied centres on surfaces")
    frame_ms = 1e3 * statistics.median(times[n_warm:])
    print(f"preset {name}: compile_s={compile_s:.2f} "
          f"median_frame_ms={frame_ms:.3f} frames={n_frames - n_warm} "
          f"alive={alive[-1]} accepted={all(accepted)} "
          f"occupied={int(occ.sum())} on_surface={on_surface:.4f}",
          flush=True)
    return state


# ------------------------------------------------- occupancy kernel vs XLA
def median_ms(fn, *args, n=5, batch=10):
    """Per-call time of ``fn`` with ``batch`` calls in flight between
    syncs (dispatch overlaps execution), median over ``n`` batches."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        for _ in range(batch):
            out = fn(*args)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / batch)
    return 1e3 * statistics.median(times)


def occupancy_kernel_check(name, cfg, particles, seed=0):
    """Compiled kernel vs ``_pool_pass_xla`` on a populated pool whose
    weights are rescaled at random and a tenth of whose particles are
    marked newborn, so culls, resampling and copy placement all occur."""

    rng = np.random.default_rng(seed)
    flags = np.asarray(particles.flags).copy()
    w = np.asarray(particles.weight).copy()
    live = flags != 0
    w[live] *= rng.uniform(0.0, 2.0, live.sum()).astype(np.float32)
    flags[live & (rng.random(flags.shape) < 0.1)] = 3
    p = dataclasses.replace(particles, flags=jnp.asarray(flags),
                            weight=jnp.asarray(w))

    xla = jax.jit(_pool_pass_xla, static_argnums=1)
    ref, ws_r, n_old_r, vs_r, static_r, moving_r = xla(p, cfg)
    fields, ws, n_old, vs, static_c, moving, counters = \
        occupancy_pool_pass(p, cfg)
    new_valid = np.asarray(ref.flags) != 0
    survivor = live & (w >= cfg.weight_cull_threshold)
    n_valid, n_culled, do_rs, n_dropped, n_filled = map(np.asarray, counters)
    check(np.array_equal(np.asarray(fields["flags"]), np.asarray(ref.flags)),
          f"{name}: kernel flags differ")
    check(np.array_equal(np.asarray(moving), np.asarray(moving_r)),
          f"{name}: kernel moving mask differs")
    check(np.array_equal(np.asarray(n_old), np.asarray(n_old_r)),
          f"{name}: kernel n_old differs")
    check(n_valid.sum() == survivor.sum()
          and n_culled.sum() == (live & ~survivor).sum()
          and do_rs.sum() == (survivor.sum(0) >= cfg.resample_min_count).sum()
          and n_dropped.sum() == (survivor & ~new_valid).sum()
          and n_filled.sum() == (~survivor & new_valid).sum(),
          f"{name}: kernel counters differ")
    worst = 0.0
    pairs = [(fields["weight"], ref.weight, 1e-9), (ws, ws_r, 0.0),
             (static_c, static_r, 0.0)]
    pairs += [(fields[f], getattr(ref, f), 0.0)
              for f in ("px", "py", "pz", "vx", "vy", "vz", "t")]
    pairs += list(zip(vs, vs_r, [0.0] * 3))
    for got, want, atol in pairs:
        got, want = np.asarray(got), np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol)
        worst = max(worst, float(np.max(
            np.abs(got - want) / np.maximum(np.abs(want), 1e-30))))
    t_kernel = median_ms(occupancy_pool_pass, p, cfg)
    t_xla = median_ms(xla, p, cfg)
    S, V = p.flags.shape
    print(f"occupancy kernel vs XLA [{name} pool S={S} V={V}, "
          f"resampled voxels={int(do_rs.sum())}, copies={int(n_filled.sum())}]: "
          f"flags/counters exact, max rel err={worst:.3e} "
          f"(rtol=1e-6 atol=1e-9); kernel_ms={t_kernel:.4f} "
          f"xla_ms={t_xla:.4f}", flush=True)


# ----------------------------------------- measurement update vs float64
def _identity_pass(ppos, pts, sigma, precision):
    """The expanded |a|^2 + |b|^2 - 2 a.b pair term (the earlier form)."""

    a, b = ppos / sigma, pts / sigma
    d2 = (jnp.sum(a * a, -1)[:, :, None] + jnp.sum(b * b, -1)[:, None, :]
          - 2.0 * jnp.einsum("bsi,bmi->bsm", a, b, precision=precision))
    return REF_PDF_CONST**3 * jnp.exp(-0.5 * jnp.maximum(d2, 0.0))


def entry_instructions(hlo: str) -> list[str]:
    """The instruction lines of the ENTRY computation of an HLO module's
    text: what the compiled program materializes (fused computations'
    internals are not among them)."""
    lines, inside = [], False
    for line in hlo.splitlines():
        if line.startswith("ENTRY"):
            inside = True
        elif inside and line.startswith("}"):
            break
        elif inside:
            lines.append(line)
    return lines


def _f64_passes(pos, w, pts, cinv, sigma, rows=128):
    c3 = (1.0 / math.sqrt(math.pi)) ** 3
    p1 = np.zeros(pts.shape[:2])
    p2 = np.zeros(pos.shape[:2])
    for lo in range(0, pos.shape[0], rows):
        sl = slice(lo, lo + rows)
        d = (pos[sl, :, None, :].astype(np.float64)
             - pts[sl, None, :, :].astype(np.float64)) / sigma
        g = c3 * np.exp(-0.5 * np.sum(d * d, -1))
        p1[sl] = np.einsum("psm,ps->pm", g, w[sl].astype(np.float64))
        p2[sl] = np.einsum("psm,pm->ps", g, cinv[sl].astype(np.float64))
    return p1, p2


def update_check(name, cfg, state, frame):
    """Pair passes on the dense tiles of a real frame: particles binned by
    ``register_fov`` from the preset's populated pool, observations binned
    by ``project_points`` from its last frame."""

    sigma = cfg.sigma_ob
    HI = jax.lax.Precision.HIGHEST

    @jax.jit
    def tiles(state, frame):
        valid = jnp.arange(frame.points.shape[0]) < frame.n_points
        obs = project_points(frame.points, valid, frame.sensor_pos,
                             frame.quat, cfg)
        _, fovbin, _ = register_fov(state.particles, cfg, frame.sensor_pos,
                                    frame.quat, jax.random.key(1))
        pts = gather_neighbors(obs.points, cfg, 0.0)
        mask = gather_neighbors(obs.mask, cfg, False)
        pw = fovbin.weight * fovbin.mask
        c_grid = scatter_neighbor_sum(
            pass1_sums(fovbin.pos, pw, pts, sigma), cfg) * cfg.p_detection
        c_grid = jnp.where(obs.mask, c_grid + cfg.kappa, 1.0)
        cinv = jnp.where(mask, 1.0 / gather_neighbors(c_grid, cfg, 1.0), 0.0)
        return fovbin.pos, pw, pts, cinv

    pos, pw, pts, cinv = tiles(state, frame)
    new1 = jax.jit(lambda a, w, b: pass1_sums(a, w, b, sigma))
    new2 = jax.jit(lambda a, b, c: pass2_sums(a, b, c, sigma))

    def old(precision):
        one = jax.jit(lambda a, w, b: jnp.einsum(
            "bsm,bs->bm", _identity_pass(a, b, sigma, precision), w,
            precision=precision))
        two = jax.jit(lambda a, b, c: jnp.einsum(
            "bsm,bm->bs", _identity_pass(a, b, sigma, precision), c,
            precision=precision))
        return one, two

    want1, want2 = _f64_passes(*map(np.asarray, (pos, pw, pts, cinv)), sigma)
    check(np.asarray(pw).sum() > 0 and want1.max() > 0,
          f"{name}: the frame binned no particles near observations")

    def rel(got, want):
        return float(np.abs(np.asarray(got, np.float64) - want).max()
                     / np.abs(want).max())

    err_new = (rel(new1(pos, pw, pts), want1), rel(new2(pos, pts, cinv), want2))
    old_default, old_high = old(jax.lax.Precision.DEFAULT), old(HI)
    err_old = (rel(old_default[0](pos, pw, pts), want1),
               rel(old_default[1](pos, pts, cinv), want2))
    check(max(err_new) <= 1e-4, f"{name}: update passes off by {err_new}")

    # the pair tile [rows, S_t, CK] must not reach device memory: no
    # top-level instruction of the compiled pass may produce it
    entry = entry_instructions(new1.lower(pos, pw, pts).compile().as_text())
    tile = "= f32[%d,%d,%d]" % (pos.shape[0], pos.shape[1], pts.shape[1])
    in_memory = any(tile in line for line in entry)
    n_fusion = sum(" fusion(" in line for line in entry)
    t_new = (median_ms(new1, pos, pw, pts), median_ms(new2, pos, pts, cinv))
    t_old = (median_ms(old_high[0], pos, pw, pts),
             median_ms(old_high[1], pos, pts, cinv))
    print(f"update passes vs float64 [{name} rows={pos.shape[0]} "
          f"S_t={pos.shape[1]} CK={pts.shape[1]}]: rel err pass1="
          f"{err_new[0]:.3e} pass2={err_new[1]:.3e} (limit 1e-4); expanded "
          f"form at default precision pass1={err_old[0]:.3e} "
          f"pass2={err_old[1]:.3e}; pair tile in memory={in_memory} "
          f"fusions(pass1)={n_fusion}; ms difference form "
          f"{t_new[0]:.4f}+{t_new[1]:.4f}, expanded form at HIGHEST "
          f"{t_old[0]:.4f}+{t_old[1]:.4f}", flush=True)


# ---------------------------------------------------- GPU vs CPU backend
BACKEND_RTOL, BACKEND_ATOL = 1e-4, 1e-5


def backend_check(label, cfg, n_frames=3):
    """Frames 1..n of the same program on the GPU and on the CPU backend,
    each frame stepped on both from the same state (the CPU run's).

    The CPU step takes the XLA pool pass (a Triton kernel has no CPU
    lowering), which the kernel check above holds element-exact.  Threefry
    bits are identical across backends, so only rounding differs.  It can
    still flip a discrete choice: newborn particles of equal weight put the
    resampling grid exactly on a cumulative-weight boundary, where the
    rounding of the slot-axis sum picks the copies, so the particle sets of
    such voxels may differ and free-running runs then drift apart.  Each
    frame's per-voxel ``weight_sum`` is the voxel's total before
    resampling, so it is held to rounding error: every voxel within
    ``rtol=BACKEND_RTOL, atol=BACKEND_ATOL`` (a 1-ulp perturbation of the
    input cloud moves it by <= 2e-5 relative on the CPU), and the occupied
    sets of the two maps differ in at most one voxel or 1% of their union.
    ``alive`` is reported, not held: a flipped tie changes the copy count."""

    gpu, cpu = jax.devices("gpu")[0], jax.devices("cpu")[0]
    xla_cfg = dataclasses.replace(cfg, use_pallas_occupancy=False)
    backends = {"gpu": (gpu, cfg), "cpu": (cpu, xla_cfg)}
    steps = {k: jax.jit(dm.make_step(c)) for k, (_, c) in backends.items()}
    readout = jax.jit(dm.get_occupancy_map, static_argnums=(1, 2))
    state = jax.device_put(dm.init_state(cfg, jax.random.key(0)), cpu)
    print(f"gpu vs cpu backend [{label} {cfg.nx}x{cfg.ny}x{cfg.nz}, each "
          f"frame from the cpu state] (limits: weight_sum rtol="
          f"{BACKEND_RTOL} atol={BACKEND_ATOL} in every voxel; occupied "
          f"sets differ in <= max(1, 1%) voxels):", flush=True)
    for i, frame in enumerate(street_frames(cfg, n_frames), 1):
        res = {}
        for k, (dev, c) in backends.items():
            s, out = steps[k](*jax.device_put((state, frame), dev))
            occ = readout(s, c, 0.2)[0]
            res[k] = (s, np.asarray(out.weight_sum), np.asarray(occ),
                      int(out.metrics["alive"]), bool(out.accepted))
        state, ws_c, occ_c, alive_c, acc_c = res["cpu"]
        _, ws_g, occ_g, alive_g, acc_g = res["gpu"]
        err = np.abs(ws_g - ws_c)
        held = (ws_g > 0) | (ws_c > 0)
        out_of_tol = int((err > BACKEND_ATOL + BACKEND_RTOL * np.abs(ws_c))
                         .sum())
        rel = float((err / np.maximum(np.abs(ws_c), 1e-30))[held].max()) \
            if held.any() else 0.0
        union = int((occ_g | occ_c).sum())
        occ_off = int((occ_g != occ_c).sum())
        print(f"  frame {i}: weight_sum max rel diff={rel:.3e} max abs diff="
              f"{float(err.max()):.3e}, {out_of_tol} of {int(held.sum())} "
              f"voxels out of tolerance; occupied gpu/cpu {int(occ_g.sum())}/"
              f"{int(occ_c.sum())}, {occ_off} differ; alive {alive_g}/"
              f"{alive_c}", flush=True)
        check(acc_g and acc_c, f"{label} frame {i}: rejected")
        check(out_of_tol == 0,
              f"{label} frame {i}: {out_of_tol} voxels' weight_sum differ")
        check(occ_off <= max(1, 0.01 * union),
              f"{label} frame {i}: {occ_off} occupied voxels differ")
    check(occ_c.sum() > 0, f"{label}: empty map")


# ------------------------------------------------------------ four GPUs
def four_gpu_check(n_frames=3, **size):
    """Map-parallel steps on a 4-GPU mesh vs the single-device step.

    GSPMD (``make_sharded_step``) and the shard_map pool path compute the
    same per-voxel sums as one device, in another order.  Each of their
    frames starts from the single-device state (rounding can flip a
    resampling tie, see ``backend_check``), and every voxel's
    ``weight_sum`` agrees to ``rtol=1e-4, atol=1e-5``; ``alive`` is
    reported.  The shard_map compact path orders cross-slab arrivals
    shard-major (a documented deviation) and keeps its own state, so it
    runs free and is held to the band of tests/test_compact_shard.py:
    alive and total weight within 5% after the last frame.  The programs
    compile concurrently."""
    from concurrent.futures import ThreadPoolExecutor

    mesh = make_mesh(4)
    flagship = dict(nz=40, particle_capacity=max(8192 * 4, 16384),
                    max_input_points=1024, max_clusters=8, **size)
    pool = dm.dsp_dynamic(**flagship)
    compact = {ex: dm.dsp_dynamic(layout="compact", mover_exchange=ex,
                                  **flagship)
               for ex in ("all_gather", "ring")}
    cases = [("pool gspmd", pool, make_sharded_step, "exact"),
             ("pool shard_map", pool, make_shardmap_step, "exact")]
    cases += [(f"compact shard_map {ex}", c, make_shardmap_step, "band")
              for ex, c in compact.items()]
    singles = {"pool": pool, "compact": compact["all_gather"]}

    frames = street_frames(pool, n_frames)
    jobs = {}
    with jax.default_device(jax.devices()[0]):
        for key, cfg in singles.items():
            state = dm.init_state(cfg, jax.random.key(0))
            jobs[key] = (jax.jit(dm.make_step(cfg)).lower(state, frames[0]),
                         state)
    for label, cfg, build, _ in cases:
        check(cfg.storage_voxels % 4 == 0, f"{label}: grid not divisible")
        state = shard_state(dm.init_state(cfg, jax.random.key(0)), mesh)
        jobs[label] = (build(cfg, mesh).lower(state, frames[0]), state)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool_ex:
        compiled = dict(zip(jobs, pool_ex.map(lambda j: j[0].compile(),
                                              jobs.values())))
    print(f"four gpus: {len(jobs)} programs compiled in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def play(key, teacher=None):
        """Per frame: the state after it (a mesh step donates its input,
        so only the last one stays alive), ``weight_sum`` and ``alive``.
        With ``teacher`` (single-device states), frame i starts from
        ``teacher[i]`` instead of the previous frame's state."""
        state, runs = jobs[key][1], []
        for i, f in enumerate(frames):
            if teacher is not None:  # a copy: the mesh step donates it
                state = shard_state(jax.tree.map(jnp.copy, teacher[i]), mesh)
            state, out = compiled[key](state, f)
            runs.append((state, np.asarray(state.weight_sum),
                         int(out.metrics["alive"])))
        return runs

    singles_run = {key: play(key) for key in singles}
    for label, cfg, _, rule in cases:
        single = singles_run[cfg.layout]
        teacher = [jobs[cfg.layout][1]] + [r[0] for r in single[:-1]]
        mesh_run = play(label, teacher if rule == "exact" else None)
        check(len(mesh_run[-1][0].particles.weight.sharding.device_set) == 4,
              f"{label}: state not distributed")
        for i, ((_, w1, a1), (_, w2, a2)) in enumerate(zip(single, mesh_run),
                                                       1):
            err = np.abs(w1 - w2)
            n_off = int((err > 1e-5 + 1e-4 * np.abs(w1)).sum())
            print(f"four gpus [{label}, {cfg.nx}x{cfg.ny}x{cfg.nz}, frame "
                  f"{i}]: alive single={a1} mesh={a2}; weight_sum max abs "
                  f"diff={float(err.max()):.3e}, {n_off} voxels out of "
                  f"tolerance; total single={w1.sum():.6f} mesh="
                  f"{w2.sum():.6f} ({rule})", flush=True)
            check(a1 > 0, f"{label}: empty map")
            if rule == "exact":
                check(n_off == 0, f"{label} frame {i}: weight_sum differs")
            elif i == n_frames:
                check(abs(a1 - a2) <= max(10, 0.05 * a1),
                      f"{label}: alive {a1} vs {a2}")
                check(abs(w1.sum() - w2.sum()) <= max(0.5, 0.05 * w1.sum()),
                      f"{label}: total weight {w1.sum()} vs {w2.sum()}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the sharded steps on a 4-GPU mesh")
    args = ap.parse_args(argv)

    n_gpus = 4 if args.four_gpus else 1
    devices = require_gpus(n_gpus)

    enable_compile_cache()
    jax.config.update("jax_threefry_partitionable", True)
    for line in card_lines():
        print(f"card: {line}", flush=True)

    if args.four_gpus:
        four_gpu_check()
    else:
        states = {}
        for name, (cfg, n_sensors) in dm.shipped_presets().items():
            states[name] = (cfg, run_preset(name, cfg, n_sensors))
        for name in ("dynamic", "static"):
            cfg, state = states[name]
            occupancy_kernel_check(name, cfg, state.particles)
        for name in ("static", "multi"):
            cfg, state = states[name]
            frame = street_frames(cfg, 13)[-1]
            update_check(name, cfg, state, frame)
        tiny = dict(nx=16, ny=16, nz=8, voxel_resolution=0.6,
                    max_input_points=256, mover_capacity=2048,
                    pyramid_slot_capacity=32, max_clusters=8)
        medium = dict(nx=40, ny=40, nz=20, max_input_points=2000,
                      mover_capacity=4096, max_clusters=8)
        for label, kw in (("tiny", tiny), ("medium", medium)):
            backend_check(label, dm.example_node_settings(
                dm.dsp_dynamic(**kw)))

    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
