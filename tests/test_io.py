"""IO subsystem: checkpoint round trip, particle CSV format, rosbag parsing
(against a synthetic bag written by the test), replay CLI."""

import struct
import pytest
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp

from dspmap_tpu import (
    dsp_dynamic, example_node_settings, init_state, make_step, Frame,
)
from dspmap_tpu.io import save_state, load_state, export_particles_csv
from dspmap_tpu.io import rosbag
from dspmap_tpu.utils import sim


def small_cfg(**kw):
    return example_node_settings(dsp_dynamic(
        nx=16, ny=16, nz=8, voxel_resolution=0.25,
        max_input_points=256, mover_capacity=2048,
        pyramid_slot_capacity=32, max_clusters=8,
        newborn_particles_per_point=4,
        **kw,
    ))


def _advance(cfg, state, n=3, seed=0):
    step = jax.jit(make_step(cfg))
    for pts, np_, pos, quat, t in sim.generate_sequence(n, cfg, seed=seed):
        state, out = step(state, Frame(jnp.asarray(pts), jnp.int32(np_),
                                       jnp.asarray(pos), jnp.asarray(quat),
                                       jnp.asarray(t)))
    return state, step


def test_checkpoint_roundtrip_resumes_identically(tmp_path):
    cfg = small_cfg()
    state, step = _advance(cfg, init_state(cfg, jax.random.key(0)))
    path = tmp_path / "ckpt.npz"
    save_state(state, path)
    restored = load_state(init_state(cfg, jax.random.key(1)), path)

    # bit-identical restore
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        if jax.dtypes.issubdtype(a.dtype, jax.dtypes.prng_key):
            np.testing.assert_array_equal(
                jax.random.key_data(a), jax.random.key_data(b))
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # resumed trajectory identical to uninterrupted one
    frames = list(sim.generate_sequence(5, cfg, seed=0))[3:]
    s_a, s_b = state, restored
    for pts, n, pos, quat, t in frames:
        f = Frame(jnp.asarray(pts), jnp.int32(n), jnp.asarray(pos),
                  jnp.asarray(quat), jnp.asarray(t))
        s_a, _ = step(s_a, f)
        s_b, _ = step(s_b, f)
    np.testing.assert_array_equal(
        np.asarray(s_a.particles.weight), np.asarray(s_b.particles.weight))


def test_particle_csv_format(tmp_path):
    cfg = small_cfg()
    # seed with random particles so the export is non-vacuous
    state = init_state(cfg, jax.random.key(0), init_particle_num=500,
                       init_weight=0.01)
    state, _ = _advance(cfg, state)
    path = tmp_path / "particles.csv"
    n = export_particles_csv(state, cfg, path)
    rows = np.loadtxt(path, delimiter=",").reshape(-1, 9)
    assert n > 50
    assert len(rows) == n == int(jnp.sum(state.particles.valid))
    # reference format: flag,vx,vy,vz,px,py,pz,weight,voxel_index
    assert set(np.unique(rows[:, 0])) <= {1.0, 15.0}
    assert (rows[:, 7] > 0).all()
    assert ((rows[:, 8] >= 0) & (rows[:, 8] < cfg.voxel_num)).all()
    # ego positions within the map half-extents
    half = np.asarray(cfg.half_extent)
    assert (np.abs(rows[:, 4:7]) <= half + cfg.voxel_resolution).all()


def _write_test_bag(path, n_frames=4):
    """Minimal unchunked ROS bag with PoseStamped + PointCloud2 messages."""
    def header(fields):
        out = b""
        for k, v in fields.items():
            f = k.encode() + b"=" + v
            out += struct.pack("<I", len(f)) + f
        return out

    def record(hfields, data):
        h = header(hfields)
        return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data

    def pc2(points, t):
        fields = [("x", 0), ("y", 4), ("z", 8)]
        fdata = b""
        for name, off in fields:
            fdata += struct.pack("<I", len(name)) + name.encode()
            fdata += struct.pack("<IBI", off, 7, 1)
        payload = points.astype("<f4").tobytes()
        msg = struct.pack("<I", 0) + struct.pack("<II", int(t), 0)
        msg += struct.pack("<I", 0)  # frame_id ""
        msg += struct.pack("<II", 1, len(points))
        msg += struct.pack("<I", len(fields)) + fdata
        msg += struct.pack("<B", 0)
        msg += struct.pack("<II", 12, 12 * len(points))
        msg += struct.pack("<I", len(payload)) + payload
        msg += struct.pack("<B", 1)  # is_dense
        return msg

    def pose(p, q_wxyz, t):
        msg = struct.pack("<I", 0) + struct.pack("<II", int(t), 0)
        msg += struct.pack("<I", 0)
        w, x, y, z = q_wxyz
        msg += struct.pack("<7d", p[0], p[1], p[2], x, y, z, w)
        return msg

    out = b"#ROSBAG V2.0\n"
    out += record(
        {"op": b"\x07", "conn": struct.pack("<I", 0),
         "topic": b"/camera_front/depth/points"},
        header({"type": b"sensor_msgs/PointCloud2"}),
    )
    out += record(
        {"op": b"\x07", "conn": struct.pack("<I", 1),
         "topic": b"/mavros/local_position/pose"},
        header({"type": b"geometry_msgs/PoseStamped"}),
    )
    rng = np.random.default_rng(0)
    for i in range(n_frames):
        t = 100 + i
        out += record(
            {"op": b"\x02", "conn": struct.pack("<I", 1),
             "time": struct.pack("<II", t, 0)},
            pose([0.1 * i, 0.0, 1.0], [1.0, 0, 0, 0], t),
        )
        # camera-frame points: z_cam forward 1-2 m
        cam = rng.uniform([-0.5, -0.5, 0.8], [0.5, 0.5, 2.0], (200, 3))
        out += record(
            {"op": b"\x02", "conn": struct.pack("<I", 0),
             "time": struct.pack("<II", t, 0)},
            pc2(cam.astype(np.float32), t),
        )
    Path(path).write_bytes(out)


def test_rosbag_roundtrip(tmp_path):
    cfg = small_cfg()
    bag = tmp_path / "test.bag"
    _write_test_bag(bag)
    frames = list(rosbag.bag_to_frames(bag, cfg))
    assert len(frames) >= 3
    pts, n, pos, quat, t = frames[1]
    assert n > 50
    # camera z (forward) became body x
    assert (pts[:n, 0] > 0.5).all()
    assert abs(float(t) - 1.0) < 1e-3  # stream-relative
    np.testing.assert_allclose(pos, [0.1, 0.0, 1.0], atol=1e-5)


def test_voxel_downsample_matches_leaf_centroids():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    ds = rosbag.voxel_downsample(pts, 0.25)
    keys_in = set(map(tuple, np.floor(pts / 0.25).astype(int)))
    keys_out = set(map(tuple, np.floor(ds / 0.25).astype(int)))
    assert keys_out == keys_in
    assert len(ds) == len(keys_in)


def test_replay_cli_runs(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "dspmap_tpu.io.replay", "--frames", "3",
         "--cpu", "--tiny", "--csv", str(tmp_path / "p.csv")],
        capture_output=True, text=True, timeout=900,
        cwd=Path(__file__).parents[1],
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "updates_per_sec" in out.stdout


def test_checkpoint_orbax_backend(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    cfg = small_cfg()
    state, _ = _advance(cfg, init_state(cfg, jax.random.key(3)))
    path = tmp_path / "orbax_ckpt"
    save_state(state, path, backend="orbax")
    restored = load_state(init_state(cfg, jax.random.key(4)), path,
                          backend="orbax")
    np.testing.assert_array_equal(
        np.asarray(state.particles.weight), np.asarray(restored.particles.weight)
    )
    np.testing.assert_array_equal(
        np.asarray(state.origin), np.asarray(restored.origin)
    )


def test_checkpoint_config_switch_sanitizer(tmp_path):
    """A state written under a free-motion config and restored under a
    clamped one violates the pipeline's velocity-clamp write-site invariant
    (vz==0 under limit-xy; the Pallas occupancy kernel's plane elision
    relies on it).  load_state(cfg=...) re-applies the clamp; without cfg
    the restore stays bit-exact."""
    import dataclasses

    cfg_free = small_cfg(limit_motion_to_xy_plane=False)
    state = init_state(cfg_free, jax.random.key(5),
                       init_particle_num=500, init_weight=0.05)
    assert float(np.abs(np.asarray(state.particles.vz)).max()) > 0.0
    path = tmp_path / "free.npz"
    save_state(state, path)

    cfg_clamped = small_cfg()  # limit_motion_to_xy_plane=True
    template = init_state(cfg_clamped, jax.random.key(0))
    restored = load_state(template, path, cfg=cfg_clamped)
    assert float(np.abs(np.asarray(restored.particles.vz)).max()) == 0.0
    np.testing.assert_array_equal(
        np.asarray(restored.particles.vx), np.asarray(state.particles.vx)
    )

    raw = load_state(template, path, sanitize=False)
    np.testing.assert_array_equal(
        np.asarray(raw.particles.vz), np.asarray(state.particles.vz)
    )
