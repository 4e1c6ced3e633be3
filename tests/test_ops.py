"""Kernel-level unit tests: insertion capacity semantics, compaction, and the
systematic-resampling bucketing vs a direct port of the reference's serial
walk (test-only oracle of dsp_dynamic.h:1004-1053)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from dspmap_tpu import MapConfig, dsp_dynamic, init_state
from dspmap_tpu import geometry
from dspmap_tpu.ops.common import compact_mask, sort_by_destination
from dspmap_tpu.ops.insert import insert_particles
from dspmap_tpu.ops.occupancy import occupancy_and_resample


def tiny_cfg(**kw) -> MapConfig:
    base = dict(
        nx=16, ny=16, nz=8,
        max_input_points=256,
        mover_capacity=4096,
        pyramid_slot_capacity=64,
        max_clusters=16,
    )
    base.update(kw)
    return dsp_dynamic(**base)


def test_compact_mask_order_and_overflow():
    mask = jnp.asarray([0, 1, 1, 0, 1, 0, 1, 1], bool)
    idx, valid, n, overflow = compact_mask(mask, 3)
    np.testing.assert_array_equal(np.asarray(idx), [1, 2, 4])
    assert np.asarray(valid).all()
    assert int(n) == 3 and int(overflow) == 2


def test_sort_by_destination_ranks():
    dest = jnp.asarray([5, 2, 5, 2, 2, 9])
    valid = jnp.asarray([1, 1, 1, 1, 0, 1], bool)
    order, sdest, ranks = sort_by_destination(dest, valid)
    np.testing.assert_array_equal(np.asarray(sdest)[:5], [2, 2, 5, 5, 9])
    np.testing.assert_array_equal(np.asarray(ranks)[:5], [0, 1, 0, 1, 0])
    # stability: first 2-destination candidate is index 1, then 3
    np.testing.assert_array_equal(np.asarray(order)[:2], [1, 3])


def test_insert_respects_capacity_and_order():
    cfg = tiny_cfg()
    state = init_state(cfg, jax.random.key(0))
    S = cfg.slots_per_voxel
    # all candidates into one voxel: the first S fit, the rest vanish
    M = S + 7
    center = jnp.asarray(state.sensor_pos)
    pos = jnp.tile(center, (M, 1))
    vel = jnp.zeros((M, 3))
    w = jnp.arange(1, M + 1, dtype=jnp.float32)
    p = insert_particles(
        state.particles, cfg,
        pos=pos, vel=vel, weight=w,
        valid=jnp.ones((M,), bool),
        origin=state.origin, flag=jnp.int32(3), t=0.0,
    )
    assert int(jnp.sum(p.valid)) == S
    cell = int(geometry.storage_index(geometry.world_voxel(center, cfg), cfg))
    got = np.sort(np.asarray(p.weight[:, cell]))
    # first-come order: weights 1..S survive
    np.testing.assert_allclose(got, np.arange(1, S + 1))


def test_insert_compact_bucket_exact():
    """The pre-allocation rank<S compaction path (ops/insert.py) is exact vs
    the full-size path, both when the eligible set fits the budget and when
    it overflows into the fallback branch."""
    cfg = tiny_cfg()
    state = init_state(cfg, jax.random.key(0))
    rng = np.random.default_rng(3)
    M = 512
    span = np.asarray(
        [cfg.nx, cfg.ny, cfg.nz], np.float32) * cfg.voxel_resolution
    pos = jnp.asarray(
        (rng.random((M, 3)) * 0.9 * span - 0.45 * span).astype(np.float32)
    ) + jnp.asarray(state.sensor_pos)
    vel = jnp.asarray(rng.normal(size=(M, 3)).astype(np.float32))
    w = jnp.asarray(rng.random(M).astype(np.float32))
    valid = jnp.asarray(rng.random(M) < 0.8)
    for budget in (64, 8):  # fits / overflows (rank<S survivors vs budget)
        full = insert_particles(
            state.particles, cfg, pos=pos, vel=vel, weight=w, valid=valid,
            origin=state.origin, flag=jnp.int32(3), t=1.5, compact_to=None,
        )
        bucketed = insert_particles(
            state.particles, cfg, pos=pos, vel=vel, weight=w, valid=valid,
            origin=state.origin, flag=jnp.int32(3), t=1.5, compact_to=budget,
        )
        for f in ("flags", "px", "py", "pz", "vx", "vy", "vz", "weight", "t"):
            np.testing.assert_array_equal(
                np.asarray(getattr(full, f)), np.asarray(getattr(bucketed, f)),
                err_msg=f"{f} budget={budget}",
            )


def test_insert_drops_out_of_window():
    cfg = tiny_cfg()
    state = init_state(cfg, jax.random.key(0))
    pos = jnp.asarray([[100.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    p = insert_particles(
        state.particles, cfg,
        pos=pos, vel=jnp.zeros((2, 3)), weight=jnp.ones((2,)),
        valid=jnp.ones((2,), bool),
        origin=state.origin, flag=jnp.int32(1), t=0.0,
    )
    assert int(jnp.sum(p.valid)) == 1


def test_update_tier_invariance():
    """The two-tier measurement update (dense tiles + spill paths) computes
    the same weights and birth normalizer as a full-capacity single-tier
    configuration -- the tiers are a processing layout, not an
    approximation (ops/update.py)."""
    from dspmap_tpu.ops.project import project_points
    from dspmap_tpu.ops.fov import register_fov
    from dspmap_tpu.ops.update import measurement_update

    base = dict(
        nx=16, ny=16, nz=8, max_input_points=256,
        pyramid_slot_capacity=64, max_obs_points_per_pyramid=32,
    )
    cfg_full = dsp_dynamic(
        **base, pyramid_dense_slots=64, obs_dense_points=32
    )
    cfg_small = dsp_dynamic(
        **base, pyramid_dense_slots=8, obs_dense_points=4,
        obs_spill_capacity=64, particle_spill_capacity=2048,
    )
    assert cfg_small.dense_slots == 8 and cfg_small.obs_dense == 4

    rng = np.random.default_rng(7)
    state = init_state(cfg_full, jax.random.key(0))
    sensor_pos = jnp.zeros(3)
    quat = jnp.asarray([1.0, 0.0, 0.0, 0.0])

    # clustered particles in front of the sensor (forces dense-tier spill)
    n_clusters, per = 25, 160
    centers = np.stack(
        [
            rng.uniform(0.6, 1.1, n_clusters),
            rng.uniform(-0.35, 0.35, n_clusters),
            rng.uniform(-0.2, 0.2, n_clusters),
        ],
        axis=-1,
    )
    pos = np.repeat(centers, per, 0) + rng.normal(0, 0.05, (n_clusters * per, 3))
    w = rng.uniform(0.01, 1.0, n_clusters * per).astype(np.float32)
    particles = insert_particles(
        state.particles, cfg_full,
        pos=jnp.asarray(pos, jnp.float32),
        vel=jnp.zeros((len(pos), 3)),
        weight=jnp.asarray(w),
        valid=jnp.ones((len(pos),), bool),
        origin=state.origin, flag=jnp.int32(1), t=0.0,
    )

    # clustered measurement points (forces obs-tier spill)
    pts = np.repeat(centers[:16], 16, 0) + rng.normal(0, 0.03, (256, 3))
    pts = jnp.asarray(pts, jnp.float32)
    pvalid = jnp.ones((256,), bool)

    results = {}
    for name, cfg in (("full", cfg_full), ("small", cfg_small)):
        obs = project_points(pts, pvalid, sensor_pos, quat, cfg)
        newp, fovbin, _ = register_fov(
            particles, cfg, sensor_pos, quat, jax.random.key(1)
        )
        outp, norm, stats = measurement_update(
            newp, fovbin, obs, cfg, jnp.float32(0.5), jnp.float32(1.0)
        )
        results[name] = (np.asarray(outp.weight), float(norm))
        if name == "small":
            # the spill paths must actually be exercised
            assert int(jnp.sum(fovbin.sp_mask)) > 100
            assert int(jnp.sum(obs.spill_pts_mask)) > 30
            assert int(fovbin.sp_overflow) == 0
            assert int(obs.spill_overflow) == 0

    w_full, n_full = results["full"]
    w_small, n_small = results["small"]
    np.testing.assert_allclose(w_small, w_full, rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(n_small, n_full, rtol=1e-4)


def _resample_oracle(weights, valid, max_ppv, min_count=5):
    """Direct port of the reference's serial resampling walk for one voxel
    (test oracle of dsp_dynamic.h:986-1055).  Returns final per-slot weights
    (0 = dead) ignoring slot identity of copies."""
    S = len(weights)
    w = weights.copy()
    alive = valid.copy()
    count = int(valid.sum())
    wsum = float(w[valid].sum())
    if count < min_count:
        return w * valid
    n_target = min(count, max_ppv)
    wa = wsum / n_target
    acc_ori, acc_new = 0.0, wa * 0.5
    out = np.zeros(S)
    free = list(np.nonzero(~valid)[0])
    copies = []
    for p in range(S):
        if not alive[p]:
            continue
        acc_ori += w[p]
        if acc_ori > acc_new:
            out[p] = wa
            acc_new += wa
            while acc_ori > acc_new:
                if free:
                    copies.append(wa)
                    free.pop(0)
                else:
                    out[p] += wa
                acc_new += wa
        else:
            out[p] = 0.0
            free.append(p)
    return np.concatenate([out, np.asarray(copies)]) if copies else out


def test_resample_matches_serial_oracle_mass_and_counts():
    cfg = tiny_cfg()
    rng = np.random.default_rng(3)
    state = init_state(cfg, jax.random.key(1))
    S, V = cfg.slots_per_voxel, cfg.voxel_num
    # populate a band of voxels with random particles
    n_vox = 50
    cells = rng.choice(V, size=n_vox, replace=False)
    flags = np.zeros((S, V), np.int32)
    weights = np.zeros((S, V), np.float32)
    for c in cells:
        k = rng.integers(1, S + 1)
        slots = rng.choice(S, size=k, replace=False)
        flags[slots, c] = 1
        weights[slots, c] = rng.uniform(0.002, 1.0, size=k)
    wv_all = np.asarray(geometry.storage_to_world_voxel(state.origin, cfg))
    centers = (wv_all + 0.5) * cfg.voxel_resolution
    p = dataclasses.replace(
        state.particles,
        flags=jnp.asarray(flags),
        weight=jnp.asarray(weights),
        px=jnp.broadcast_to(jnp.asarray(centers[:, 0]), (S, V)),
        py=jnp.broadcast_to(jnp.asarray(centers[:, 1]), (S, V)),
        pz=jnp.broadcast_to(jnp.asarray(centers[:, 2]), (S, V)),
    )
    new_p, wsum, vel_avg, future, stats = occupancy_and_resample(
        p, cfg, state.origin, state.future
    )
    new_w = np.asarray(new_p.weight)
    new_valid = np.asarray(new_p.valid)
    for c in cells:
        oracle = _resample_oracle(
            weights[:, c].astype(np.float64),
            flags[:, c] > 0,
            cfg.max_particles_per_voxel,
            cfg.resample_min_count,
        )
        got = new_w[:, c][new_valid[:, c]]
        # mass conservation & particle count match the serial walk
        np.testing.assert_allclose(
            got.sum(), oracle[oracle > 0].sum(), rtol=1e-4
        ), c
        assert len(got) == (oracle > 0).sum(), c
        # multiset of weights matches
        np.testing.assert_allclose(
            np.sort(got), np.sort(oracle[oracle > 0]), rtol=1e-4
        )
    # weight_sum equals the pre-resample sums
    np.testing.assert_allclose(
        np.asarray(wsum)[cells],
        np.asarray([weights[:, c][flags[:, c] > 0].sum() for c in cells]),
        rtol=1e-5,
    )
    # future accumulators: static particles contribute their weight at every
    # horizon into their own voxel
    fut = np.asarray(future)  # horizon-major [T, V]
    for c in cells:
        np.testing.assert_allclose(
            fut[:, c],
            np.full(cfg.n_horizons, weights[:, c][flags[:, c] > 0].sum()),
            rtol=1e-5,
        )


def test_pool_take_stacked_matches_pair_gathers():
    """One [F,S,V] window gather == F independent pair gathers, including
    integer lanes (which ride as exact f32 values -- small ints bitcast to
    f32 denormals that a device may silently flush to zero, so the
    bitcast formulation is forbidden; ops/common.py pool_take_stacked)."""
    from dspmap_tpu.ops.common import pool_take, pool_take_stacked

    rng = np.random.default_rng(3)
    S, V, N = 6, 515, 257
    planes = [
        jnp.asarray(rng.normal(size=(S, V)).astype(np.float32)),
        jnp.asarray(rng.integers(0, 1 << 17, (S, V)).astype(np.int32)),
        jnp.asarray(rng.integers(0, 1 << 20, (S, V)).astype(np.uint32)),
    ]
    flat = jnp.asarray(
        np.concatenate([rng.integers(0, S * V, N - 8),
                        np.full(8, S * V)]).astype(np.int32)
    )  # incl. the out-of-range sentinel (clamps)
    got = jax.jit(pool_take_stacked)(planes, flat)
    want = [pool_take(p, jnp.minimum(flat, S * V - 1)) for p in planes]
    for g, w, p in zip(got, want, planes):
        assert g.dtype == p.dtype
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
