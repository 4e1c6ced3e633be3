"""Behavioral parity vs the compiled reference (stochastic tolerance).

Builds the reference oracle from the UNMODIFIED headers in /root/reference
(tools/oracle), replays the same synthetic street sequence through both maps,
and compares occupancy in world space.  Because the two filters use different
RNG streams (and ours deliberately fixes the reference's non-reproducible
``srand(time(0))``), the comparison is distributional -- occupancy IoU-style
agreement within tolerance, not bitwise state (SURVEY.md section 7.3 item 6).

These tests are skipped if the oracle toolchain is unavailable.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest

REPO = Path(__file__).resolve().parents[1]
ORACLE = REPO / "tools" / "oracle"


def _have_toolchain():
    return shutil.which("g++") is not None and (
        Path("/root/reference/include/dsp_dynamic.h").exists()
    )


@pytest.fixture(scope="module")
def oracle_bins():
    if not _have_toolchain():
        pytest.skip("no g++ or reference checkout")
    if not (ORACLE / "bin" / "oracle_dynamic").exists():
        subprocess.run([str(ORACLE / "build.sh")], check=True)
    return ORACLE / "bin"


def _match_stats(ours: np.ndarray, ref: np.ndarray, tol: float):
    """Fraction of each set within ``tol`` of the other (chamfer-style)."""
    if len(ours) == 0 or len(ref) == 0:
        return 0.0, 0.0
    d = np.linalg.norm(ours[:, None, :] - ref[None, :, :], axis=-1)
    ours_matched = (d.min(axis=1) <= tol).mean()
    ref_matched = (d.min(axis=0) <= tol).mean()
    return ours_matched, ref_matched


@pytest.mark.slow
def test_occupancy_parity_dynamic(oracle_bins):
    sys.path.insert(0, str(ORACLE))
    from run_oracle import make_frames, run

    import dspmap_tpu as dm

    n_frames, max_points = 25, 3000
    frames = make_frames(n_frames, max_points, seed=4, dense=False)
    ref = run("dynamic", frames, max_points, threshold=0.2)

    cfg = dm.example_node_settings(dm.dsp_dynamic(max_input_points=max_points))
    state = dm.init_state(cfg, jax.random.key(0))
    step = jax.jit(dm.make_step(cfg))
    ours_per_frame = []
    for pts, n, pos, quat, t in frames:
        frame = dm.Frame(
            jnp.asarray(pts), jnp.int32(n), jnp.asarray(pos),
            jnp.asarray(quat), jnp.asarray(np.float32(t)),
        )
        state, out = step(state, frame)
        occ, centers, future, state = dm.get_occupancy_map(state, cfg, 0.2)
        ours_per_frame.append(
            (np.asarray(centers)[np.asarray(occ)], np.asarray(pos))
        )

    # compare the last few frames in world space, half-voxel + sub-voxel
    # window-quantization tolerance
    tol = cfg.voxel_resolution * 1.6
    fracs = []
    for k in range(-5, 0):
        ours_world, pos = ours_per_frame[k]
        ref_ego = ref["frames"][k]["ego_centers"]
        ref_world = ref_ego + frames[k][2]  # ego + sensor position
        m_ours, m_ref = _match_stats(ours_world, ref_world, tol)
        fracs.append((m_ours, m_ref, len(ours_world), len(ref_world)))
    m_ours = np.mean([f[0] for f in fracs])
    m_ref = np.mean([f[1] for f in fracs])
    # Most of what we mark occupied the reference marks occupied and vice
    # versa (stochastic filters, different RNG -> not exact)
    assert m_ours > 0.75, fracs
    assert m_ref > 0.75, fracs


@pytest.mark.slow
def test_occupancy_parity_static(oracle_bins):
    """Same comparison for the dsp_static variant (zero-velocity model)."""
    sys.path.insert(0, str(ORACLE))
    from run_oracle import make_frames, run

    import dspmap_tpu as dm

    n_frames, max_points = 20, 2000
    frames = make_frames(n_frames, max_points, seed=9, dense=False)
    ref = run("static", frames, max_points, threshold=0.2)

    # the static oracle's grid is 50x50x30 @ 0.2 m (dsp_static.h:38-42)
    cfg = dm.example_node_settings(dm.dsp_static(max_input_points=max_points))
    state = dm.init_state(cfg, jax.random.key(0))
    step = jax.jit(dm.make_step(cfg))
    ours = []
    for pts, n, pos, quat, t in frames:
        frame = dm.Frame(
            jnp.asarray(pts), jnp.int32(n), jnp.asarray(pos),
            jnp.asarray(quat), jnp.asarray(np.float32(t)),
        )
        state, out = step(state, frame)
        occ, centers, future, state = dm.get_occupancy_map(state, cfg, 0.2)
        ours.append(np.asarray(centers)[np.asarray(occ)])

    tol = cfg.voxel_resolution * 1.6
    fracs = []
    for k in range(-4, 0):
        ref_world = ref["frames"][k]["ego_centers"] + frames[k][2]
        m_ours, m_ref = _match_stats(ours[k], ref_world, tol)
        fracs.append((m_ours, m_ref, len(ours[k]), len(ref_world)))
    assert np.mean([f[0] for f in fracs]) > 0.7, fracs
    assert np.mean([f[1] for f in fracs]) > 0.7, fracs


@pytest.mark.slow
def test_occupancy_parity_multi_neighbors(oracle_bins):
    """Same comparison for the multiple-neighbors variant (1-degree
    pyramids, 5x5 update neighborhood, dsp_dynamic_multiple_neighbors.h).
    Reduced frame budget: the 1-degree oracle configuration is the heaviest
    (64,800 global pyramids on one CPU core)."""
    sys.path.insert(0, str(ORACLE))
    from run_oracle import make_frames, run

    import dspmap_tpu as dm

    n_frames, max_points = 15, 2000
    frames = make_frames(n_frames, max_points, seed=6, dense=False)
    ref = run("multi", frames, max_points, threshold=0.2)

    cfg = dm.example_node_settings(
        dm.dsp_dynamic_multi_neighbors(max_input_points=max_points)
    )
    state = dm.init_state(cfg, jax.random.key(0))
    step = jax.jit(dm.make_step(cfg))
    ours = []
    for pts, n, pos, quat, t in frames:
        frame = dm.Frame(
            jnp.asarray(pts), jnp.int32(n), jnp.asarray(pos),
            jnp.asarray(quat), jnp.asarray(np.float32(t)),
        )
        state, out = step(state, frame)
        occ, centers, future, state = dm.get_occupancy_map(state, cfg, 0.2)
        ours.append(np.asarray(centers)[np.asarray(occ)])

    tol = cfg.voxel_resolution * 1.6
    fracs = []
    for k in range(-4, 0):
        ref_world = ref["frames"][k]["ego_centers"] + frames[k][2]
        m_ours, m_ref = _match_stats(ours[k], ref_world, tol)
        fracs.append((m_ours, m_ref, len(ours[k]), len(ref_world)))
    assert np.mean([f[0] for f in fracs]) > 0.7, fracs
    assert np.mean([f[1] for f in fracs]) > 0.7, fracs


@pytest.mark.slow
def test_future_status_parity_dynamic(oracle_bins):
    """The accumulated future-status grids agree in where they put mass:
    compare the final-frame future grid (summed over horizons) as weighted
    point sets in world space."""
    sys.path.insert(0, str(ORACLE))
    from run_oracle import make_frames, run

    import dspmap_tpu as dm
    from dspmap_tpu import geometry

    n_frames, max_points = 20, 3000
    frames = make_frames(n_frames, max_points, seed=11, dense=False)
    ref = run("dynamic", frames, max_points, threshold=0.2)

    cfg = dm.example_node_settings(dm.dsp_dynamic(max_input_points=max_points))
    state = dm.init_state(cfg, jax.random.key(0))
    step = jax.jit(dm.make_step(cfg))
    for i, (pts, n, pos, quat, t) in enumerate(frames):
        frame = dm.Frame(jnp.asarray(pts), jnp.int32(n), jnp.asarray(pos),
                         jnp.asarray(quat), jnp.asarray(np.float32(t)))
        state, out = step(state, frame)
        if i < n_frames - 1:
            occ, centers, future, state = dm.get_occupancy_map(state, cfg, 0.2)

    # ours: ego-ordered future grid of the last frame
    occ, centers, future, state = dm.get_occupancy_map(state, cfg, 0.2)
    ours_f = np.asarray(future).sum(axis=1)
    ours_pts = np.asarray(centers)[ours_f > 0.2]

    # oracle: future grid in its ego voxel order
    dims = ref["dims"]
    res = ref["res"]
    ref_f = ref["future"].sum(axis=1)
    idx = np.nonzero(ref_f > 0.2)[0]
    x = idx % dims[0]
    y = (idx // dims[0]) % dims[1]
    z = idx // (dims[0] * dims[1])
    half = np.asarray([dims[0], dims[1], dims[2]]) * res / 2
    ego = np.column_stack([x, y, z]) * res + res / 2 - half
    ref_pts = ego + frames[-1][2]

    m_ours, m_ref = _match_stats(ours_pts, ref_pts, cfg.voxel_resolution * 2.0)
    assert m_ours > 0.6 and m_ref > 0.6, (m_ours, m_ref, len(ours_pts), len(ref_pts))


def _replay_ours(dm, jax, jnp, cfg, frames):
    state = dm.init_state(cfg, jax.random.key(0))
    step = jax.jit(dm.make_step(cfg))
    out_frames = []
    for pts, n, pos, quat, t in frames:
        frame = dm.Frame(
            jnp.asarray(pts), jnp.int32(n), jnp.asarray(pos),
            jnp.asarray(quat), jnp.asarray(np.float32(t)),
        )
        state, out = step(state, frame)
        occ, centers, future, state = dm.get_occupancy_map(state, cfg, 0.2)
        out_frames.append(np.asarray(centers)[np.asarray(occ)])
    return out_frames


@pytest.mark.slow
def test_occupancy_parity_occlusion_scene(oracle_bins):
    """Adversarial scene: a near wall (1-degree z-buffered rendering)
    shadows most of the corridor, with pedestrians in front of and behind
    it -- most pyramids carry a short max measured range with live
    particles beyond it, which drives the reference's occlusion skip
    (dsp_dynamic.h:759-765) far harder than the street scene."""
    sys.path.insert(0, str(ORACLE))
    from run_oracle import run

    import dspmap_tpu as dm
    from dspmap_tpu.utils import sim

    n_frames, max_points = 25, 3000
    cfg = dm.example_node_settings(dm.dsp_dynamic(max_input_points=max_points))
    frames = list(sim.occlusion_sequence(n_frames, cfg, seed=11))
    ref = run("dynamic", frames, max_points, threshold=0.2)
    ours = _replay_ours(dm, jax, jnp, cfg, frames)

    tol = cfg.voxel_resolution * 1.6
    fracs = []
    for k in range(-5, 0):
        ref_world = ref["frames"][k]["ego_centers"] + frames[k][2]
        m_ours, m_ref = _match_stats(ours[k], ref_world, tol)
        fracs.append((m_ours, m_ref, len(ours[k]), len(ref_world)))
    assert np.mean([f[0] for f in fracs]) > 0.7, fracs
    assert np.mean([f[1] for f in fracs]) > 0.7, fracs


@pytest.mark.slow
def test_occupancy_parity_fast_ego(oracle_bins):
    """Adversarial ego motion: 3 m/s translation with strong yaw
    oscillation -- large per-frame window shifts (rebin/mover churn) and
    FOV churn near the admission-control limits."""
    sys.path.insert(0, str(ORACLE))
    from run_oracle import run

    import dspmap_tpu as dm
    from dspmap_tpu.utils import sim

    n_frames, max_points = 25, 3000
    cfg = dm.example_node_settings(dm.dsp_dynamic(max_input_points=max_points))
    frames = list(sim.fast_ego_sequence(n_frames, cfg, seed=12))
    ref = run("dynamic", frames, max_points, threshold=0.2)
    ours = _replay_ours(dm, jax, jnp, cfg, frames)

    tol = cfg.voxel_resolution * 1.6
    fracs = []
    for k in range(-5, 0):
        ref_world = ref["frames"][k]["ego_centers"] + frames[k][2]
        m_ours, m_ref = _match_stats(ours[k], ref_world, tol)
        fracs.append((m_ours, m_ref, len(ours[k]), len(ref_world)))
    assert np.mean([f[0] for f in fracs]) > 0.7, fracs
    assert np.mean([f[1] for f in fracs]) > 0.7, fracs


@pytest.mark.slow
def test_multisensor_parity_vs_single_sensor_oracle(oracle_bins):
    """BASELINE config 5 anchor: two cameras yawed
    +-21 deg with 21-deg half-FOV each -- their FOVs tile the reference's
    single 42-deg camera -- must reproduce the full-FOV oracle's occupancy
    within the single-sensor tolerance band.  (Splitting the CLOUD while
    keeping full per-sensor FOVs would be wrong by construction: each
    sensor would legitimately observe the other half as empty and crush its
    weights -- the sequential-PHD miss term.)"""
    sys.path.insert(0, str(ORACLE))
    from run_oracle import make_frames, run

    import dspmap_tpu as dm
    from dspmap_tpu.models.pipeline import (init_multisensor_state,
                                            make_multisensor_step)

    n_frames, max_points = 25, 3000
    frames = make_frames(n_frames, max_points, seed=4, dense=False)
    ref = run("dynamic", frames, max_points, threshold=0.2)

    cfg = dm.example_node_settings(dm.dsp_dynamic(
        max_input_points=max_points, half_fov_h_deg=21,
    ))
    state = init_multisensor_state(cfg, 2, jax.random.key(0))
    step = jax.jit(make_multisensor_step(cfg, 2))

    def yaw_quat(deg):
        h = np.deg2rad(deg) / 2
        return np.array([np.cos(h), 0.0, 0.0, np.sin(h)], np.float32)

    def quat_mul(q, r):
        w1, x1, y1, z1 = q
        w2, x2, y2, z2 = r
        return np.array([
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ], np.float32)

    def yaw_rot(deg):
        a = np.deg2rad(deg)
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)

    ours_per_frame = []
    for pts, n, pos, quat, t in frames:
        # both sensors see the whole cloud, expressed in each sensor's
        # yawed body frame; project_points FOV-filters to each 21-deg half
        qa = quat_mul(quat, yaw_quat(+21.0))
        qb = quat_mul(quat, yaw_quat(-21.0))
        pa = pts @ yaw_rot(+21.0)  # R^T applied to rows
        pb = pts @ yaw_rot(-21.0)
        frame = dm.Frame(
            points=jnp.asarray(np.stack([pa, pb])),
            n_points=jnp.asarray([n, n], jnp.int32),
            sensor_pos=jnp.asarray(np.stack([pos, pos])),
            quat=jnp.asarray(np.stack([qa, qb])),
            timestamp=jnp.asarray([t, t], jnp.float32),
        )
        state, out = step(state, frame)
        occ, centers, future, state = dm.get_occupancy_map(state, cfg, 0.2)
        ours_per_frame.append(
            (np.asarray(centers)[np.asarray(occ)], np.asarray(pos))
        )

    tol = cfg.voxel_resolution * 1.6
    fracs = []
    for k in range(-5, 0):
        ours_world, pos = ours_per_frame[k]
        ref_world = ref["frames"][k]["ego_centers"] + frames[k][2]
        m_ours, m_ref = _match_stats(ours_world, ref_world, tol)
        fracs.append((m_ours, m_ref, len(ours_world), len(ref_world)))
    m_ours = np.mean([f[0] for f in fracs])
    m_ref = np.mean([f[1] for f in fracs])
    # same band as the single-sensor dynamic parity test: the fused map and
    # the single-camera reference see the same measurements
    assert m_ours > 0.75, fracs
    assert m_ref > 0.75, fracs


@pytest.mark.slow
def test_occupancy_parity_dynamic_compact_layout(oracle_bins):
    """The alive-proportional compact layout (cfg.layout='compact',
    ops/compact.py) against the unmodified-reference oracle -- same scene,
    band and protocol as the pool-layout dynamic test."""
    sys.path.insert(0, str(ORACLE))
    from run_oracle import make_frames, run

    import dspmap_tpu as dm

    n_frames, max_points = 25, 3000
    frames = make_frames(n_frames, max_points, seed=4, dense=False)
    ref = run("dynamic", frames, max_points, threshold=0.2)

    cfg = dm.example_node_settings(
        dm.dsp_dynamic(max_input_points=max_points, layout="compact")
    )
    state = dm.init_state(cfg, jax.random.key(0))
    step = jax.jit(dm.make_step(cfg))
    ours_per_frame = []
    for pts, n, pos, quat, t in frames:
        frame = dm.Frame(
            jnp.asarray(pts), jnp.int32(n), jnp.asarray(pos),
            jnp.asarray(quat), jnp.asarray(np.float32(t)),
        )
        state, out = step(state, frame)
        occ, centers, future, state = dm.get_occupancy_map(state, cfg, 0.2)
        ours_per_frame.append(
            (np.asarray(centers)[np.asarray(occ)], np.asarray(pos))
        )

    tol = cfg.voxel_resolution * 1.6
    fracs = []
    for k in range(-5, 0):
        ours_world, pos = ours_per_frame[k]
        ref_world = ref["frames"][k]["ego_centers"] + frames[k][2]
        m_ours, m_ref = _match_stats(ours_world, ref_world, tol)
        fracs.append((m_ours, m_ref, len(ours_world), len(ref_world)))
    m_ours = np.mean([f[0] for f in fracs])
    m_ref = np.mean([f[1] for f in fracs])
    assert m_ours > 0.75, fracs
    assert m_ref > 0.75, fracs
