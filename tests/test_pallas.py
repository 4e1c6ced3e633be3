"""The occupancy Pallas kernel (Triton route) vs the XLA pool pass, in
interpret mode on CPU; the compiled kernel is compared on the GPU by
chip_smoke.py.  Also the plain-JAX forms that replaced the earlier kernels:
the measurement-update pair passes and the compact layout's segmented
scans, each against a float64 / serial NumPy reference."""

import dataclasses
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import dspmap_tpu as dm
from dspmap_tpu.ops.occupancy import _pool_pass_xla
from dspmap_tpu.ops.pallas.occupancy import BLOCK, occupancy_pool_pass


def _cfg(**kw):
    base = dict(nx=16, ny=16, nz=8, max_input_points=128,
                mover_capacity=1024, pyramid_slot_capacity=16, max_clusters=4)
    base.update(kw)
    return dm.dsp_dynamic(**base)


@pytest.mark.parametrize("safety,mode", [
    (2, "limit_xy"),   # n_vel=2: vz plane elided from the kernel I/O
    (5, "limit_xy"),
    (2, "free"),       # n_vel=3: all velocity planes carried
    (2, "static"),     # n_vel=0: every velocity plane elided
])
def test_occupancy_kernel_matches_xla(safety, mode):
    """The occupancy kernel (ops/pallas/occupancy.py) is element-exact
    vs the XLA pool pass, including cull, newborn reset, systematic-resample
    copy placement and mass fold-back -- at both the x2 and the x5
    (dsp_static) slot safety factors and at every velocity-plane elision
    arm (the clamp-invariant planes left out of the kernel).  Inputs
    conform to the pipeline's clamp invariant per mode, which is what the
    elision's exactness is defined over."""
    kw = {}
    if mode == "free":
        kw.update(limit_motion_to_xy_plane=False)
    elif mode == "static":
        kw.update(motion_model="static", estimator_enabled=False)
    cfg = _cfg(voxel_slot_safety_factor=safety, **kw)
    rng = np.random.default_rng(safety)
    state = dm.init_state(cfg, jax.random.key(0))
    S, V = cfg.slots_per_voxel, cfg.voxel_num
    flags = np.zeros((S, V), np.int32)
    weights = np.zeros((S, V), np.float32)
    vx = np.zeros((S, V), np.float32)
    for c in rng.choice(V, size=300, replace=False):
        k = rng.integers(1, S + 1)
        slots = rng.choice(S, size=k, replace=False)
        flags[slots, c] = rng.choice([1, 1, 1, 3], size=k)
        weights[slots, c] = rng.uniform(0.0005, 1.0, size=k)
        vx[slots, c] = np.where(rng.random(k) < 0.3, 1.0, 0.0)
    vz = np.zeros((S, V), np.float32)
    if mode == "static":
        vx[:] = 0.0  # static-model invariant: all velocities zero
    elif mode == "free":
        vz = rng.normal(0, 0.4, (S, V)).astype(np.float32)
    p = dataclasses.replace(
        state.particles,
        flags=jnp.asarray(flags), weight=jnp.asarray(weights),
        vx=jnp.asarray(vx), vz=jnp.asarray(vz),
        px=jnp.asarray(rng.normal(0, 1, (S, V)), jnp.float32),
        t=jnp.asarray(rng.uniform(0, 5, (S, V)), jnp.float32),
    )
    ref, ws_r, n_old_r, vsum_r, static_r, moving_r = _pool_pass_xla(p, cfg)
    (fields, ws, n_old, vsum, static_c, moving,
     counters) = occupancy_pool_pass(p, cfg, interpret=True)
    # kernel-emitted stats counters match the mask-derived forms
    valid_in = flags != 0
    survivor = valid_in & (weights >= cfg.weight_cull_threshold)
    new_valid = np.asarray(ref.flags) != 0
    n_valid_v, n_culled_v, do_rs_v, n_dropped_v, n_filled_v = map(
        np.asarray, counters
    )
    assert n_valid_v.sum() == survivor.sum()
    assert n_culled_v.sum() == (valid_in & ~survivor).sum()
    assert do_rs_v.sum() == (
        survivor.sum(axis=0) >= cfg.resample_min_count
    ).sum()
    assert n_dropped_v.sum() == (survivor & ~new_valid).sum()
    assert n_filled_v.sum() == (~survivor & new_valid).sum()
    assert (n_valid_v - n_dropped_v + n_filled_v).sum() == new_valid.sum()
    np.testing.assert_array_equal(np.asarray(fields["flags"]),
                                  np.asarray(ref.flags))
    np.testing.assert_allclose(np.asarray(fields["weight"]),
                               np.asarray(ref.weight), rtol=1e-6, atol=1e-9)
    for f in ("px", "py", "pz", "vx", "vy", "vz", "t"):
        np.testing.assert_allclose(
            np.asarray(fields[f]), np.asarray(getattr(ref, f)),
            rtol=1e-6, err_msg=f,
        )
    np.testing.assert_allclose(np.asarray(ws), np.asarray(ws_r), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(moving), np.asarray(moving_r))
    np.testing.assert_allclose(np.asarray(static_c), np.asarray(static_r),
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(n_old).astype(np.int32),
                                  np.asarray(n_old_r).astype(np.int32))


@pytest.mark.parametrize(
    "scenario",
    ["no_resample", "multi_tile_mixed", "tail_tile", "no_resample_with_t"],
)
def test_occupancy_kernel_skip_branch(scenario):
    """Blocks in which no voxel resamples (every voxel holds fewer than
    resample_min_count survivors) must be element-exact too -- including the
    t-plane copy when ``record_particle_time``, the mixed case where some
    program blocks resample and others do not (V > BLOCK), and a V that is
    not a multiple of BLOCK, whose tail block masks its loads and stores."""
    kw = {}
    if scenario == "multi_tile_mixed":
        kw.update(nx=32, ny=32)  # V = 8192 -> 16 blocks
    elif scenario == "tail_tile":
        kw.update(nx=15)  # V = 1920 -> three full blocks + a 384 tail
    elif scenario == "no_resample_with_t":
        kw.update(record_particle_time=True)
    cfg = _cfg(**kw)
    S, V = cfg.slots_per_voxel, cfg.voxel_num
    if scenario == "tail_tile":
        assert V % BLOCK
    L = BLOCK
    rng = np.random.default_rng(3)
    flags = np.zeros((S, V), np.int32)
    weights = np.zeros((S, V), np.float32)
    vx = np.zeros((S, V), np.float32)
    resample_hi = min(V, L) if scenario in ("multi_tile_mixed", "tail_tile") else 0
    for c in rng.choice(V, size=min(300, V // 4), replace=False):
        if c < resample_hi:
            k = rng.integers(cfg.resample_min_count, S + 1)  # resampling voxel
        else:
            k = rng.integers(1, cfg.resample_min_count)  # below the threshold
        slots = rng.choice(S, size=k, replace=False)
        flags[slots, c] = rng.choice([1, 1, 1, 3], size=k)
        weights[slots, c] = rng.uniform(0.01, 1.0, size=k)
        vx[slots, c] = np.where(rng.random(k) < 0.3, 1.0, 0.0)
    # sanity: the populated pool exercises the intended branches
    survivors = ((flags != 0) & (weights >= cfg.weight_cull_threshold)).sum(0)
    if resample_hi:
        assert survivors[:resample_hi].max() >= cfg.resample_min_count
        assert survivors[resample_hi:].max() < cfg.resample_min_count
    else:
        assert survivors.max() < cfg.resample_min_count

    zeros = jnp.zeros((S, V), jnp.float32)
    p = dm.Particles(
        flags=jnp.asarray(flags), weight=jnp.asarray(weights),
        vx=jnp.asarray(vx), vy=zeros, vz=zeros,
        px=jnp.asarray(rng.normal(0, 1, (S, V)), jnp.float32),
        py=zeros, pz=zeros,
        t=jnp.asarray(rng.uniform(0, 5, (S, V)), jnp.float32),
    )
    ref, ws_r, n_old_r, vsum_r, static_r, moving_r = _pool_pass_xla(p, cfg)
    (fields, ws, n_old, vsum, static_c, moving,
     _counters) = occupancy_pool_pass(p, cfg, interpret=True)
    np.testing.assert_array_equal(np.asarray(fields["flags"]),
                                  np.asarray(ref.flags))
    np.testing.assert_allclose(np.asarray(fields["weight"]),
                               np.asarray(ref.weight), rtol=1e-6, atol=1e-9)
    for f in ("px", "py", "pz", "vx", "vy", "vz", "t"):
        np.testing.assert_allclose(
            np.asarray(fields[f]), np.asarray(getattr(ref, f)),
            rtol=1e-6, err_msg=f,
        )
    np.testing.assert_allclose(np.asarray(ws), np.asarray(ws_r), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(moving), np.asarray(moving_r))


def _update_inputs(seed, n_pyr, s_t, ck, centre):
    rng = np.random.default_rng(seed)
    pos = (centre + rng.normal(0, 0.3, (n_pyr, s_t, 3))).astype(np.float32)
    pts = (centre + rng.normal(0, 0.3, (n_pyr, ck, 3))).astype(np.float32)
    w = (rng.random((n_pyr, s_t))
         * (rng.random((n_pyr, s_t)) > 0.3)).astype(np.float32)
    cinv = (rng.random((n_pyr, ck))
            * (rng.random((n_pyr, ck)) > 0.5)).astype(np.float32)
    return pos, pts, w, cinv


def _update_f64(pos, pts, w, cinv, sigma):
    p64, q64 = pos.astype(np.float64), pts.astype(np.float64)
    d2 = (((p64[:, :, None, :] - q64[:, None, :, :]) / sigma) ** 2).sum(-1)
    g = (1.0 / math.sqrt(math.pi)) ** 3 * np.exp(-0.5 * d2)
    return (np.einsum("psm,ps->pm", g, w.astype(np.float64)),
            np.einsum("psm,pm->ps", g, cinv.astype(np.float64)))


@pytest.mark.parametrize("which", ["pass1", "pass2"])
def test_update_pass_far_coordinates_vs_float64(which):
    """The measurement update's pair passes (ops/update.pass1_sums and
    pass2_sums, as measurement_update calls them) at far coordinates, |x| ~ 10 m with
    sigma = 0.1 m, against a float64 NumPy evaluation.  The expanded form
    |a|^2 + |b|^2 - 2 a.b cancels here (|a/sigma|^2 ~ 3e4); the difference
    form holds a relative error far below 1e-4."""
    from dspmap_tpu.ops.update import pass1_sums, pass2_sums

    sigma = 0.1
    centre = np.array([9.5, -8.0, 1.5])
    pos, pts, w, cinv = _update_inputs(7, 56, 32, 288, centre)
    want1, want2 = _update_f64(pos, pts, w, cinv, sigma)
    pos, pts = jnp.asarray(pos), jnp.asarray(pts)
    if which == "pass1":
        got = np.asarray(pass1_sums(pos, jnp.asarray(w), pts, sigma))
        want = want1
    else:
        got = np.asarray(pass2_sums(pos, pts, jnp.asarray(cinv), sigma))
        want = want2
    assert want.max() > 0.1  # the pairs are close enough to matter
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= 1e-4, rel


def test_seg_scans_match_serial_loop():
    """ops/compact.seg_scans (run-local cumsums and run totals, a
    Hillis-Steele scan bounded by the longest live run) against a serial
    NumPy walk over fragmented runs and a dead tail."""
    from dspmap_tpu.ops.compact import seg_scans

    rng = np.random.default_rng(3)
    P, max_run = 1024, 32
    key = np.sort(rng.integers(0, 200, P))
    key[-100:] = 10**6
    key[100:110] = 7  # fragment a few runs (mid-frame disorder)
    is_start = np.concatenate([[True], key[1:] != key[:-1]])
    is_end = np.concatenate([key[1:] != key[:-1], [True]]) & (key < 10**6)
    cols = [rng.uniform(0, 1, P).astype(np.float32) for _ in range(3)]
    live = key < 10**6
    cols = [np.where(live, c, 0.0).astype(np.float32) for c in cols]
    his, tots = seg_scans([jnp.asarray(c) for c in cols],
                          jnp.asarray(is_start), jnp.asarray(is_end),
                          max_run, 2)

    for c in range(3):
        want = np.zeros(P, np.float64)
        for i in range(P):
            want[i] = cols[c][i] + (0.0 if is_start[i] else want[i - 1])
        np.testing.assert_allclose(np.asarray(his[c]), want, rtol=1e-6,
                                   atol=1e-6)
        if c < 2:
            tot = np.zeros(P, np.float64)
            for i in range(P - 1, -1, -1):
                tot[i] = want[i] if is_end[i] or i == P - 1 else tot[i + 1]
            np.testing.assert_allclose(np.asarray(tots[c])[live], tot[live],
                                       rtol=1e-6, atol=1e-6)
