"""Hand-scheduled shard_map fast path (parallel/shard_step.py): runs SPMD on
the virtual CPU mesh and agrees with the single-device step.

Cross-shard arrival order is shard-major (documented deviation,
ops/fov.py), so slot *placement* inside a voxel may legally differ from the
single-device run; every per-voxel aggregate and every global counter must
match exactly (uncontested capacities -- this scene's load is far below
them).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dspmap_tpu import dsp_dynamic, dsp_static, init_state, make_step, Frame
from dspmap_tpu.parallel import make_mesh, shard_state
from dspmap_tpu.parallel.shard_step import make_shardmap_step
from dspmap_tpu.utils import sim


def cfg_for(n_devices, base=dsp_dynamic):
    # 0.5 m voxels put the synthetic street scene's pillars and pedestrians
    # (x in [3, 8]) INSIDE the 8 x 8 m map -- with the default 0.15 m
    # resolution this grid spans only 2.4 m and every frame maps to an empty
    # pool, making the equivalence assertions vacuous.
    return base(
        nx=16, ny=16, nz=4 * n_devices, voxel_resolution=0.5,
        max_input_points=512,
        mover_capacity=2048,
        pyramid_slot_capacity=32,
        max_clusters=8,
        newborn_particles_per_point=4,
    )


def _frames(cfg, n=4, seed=5):
    return [
        Frame(jnp.asarray(p), jnp.int32(np_), jnp.asarray(pos),
              jnp.asarray(q), jnp.asarray(t))
        for p, np_, pos, q, t in sim.generate_sequence(n, cfg, seed=seed)
    ]


def _voxel_flag_counts(flags):
    f = np.asarray(flags)
    return np.stack([(f == k).sum(axis=0) for k in (1, 2, 3)])


@pytest.mark.parametrize("base", [dsp_dynamic, dsp_static])
@pytest.mark.parametrize("exchange", ["all_gather", "ring"])
def test_shardmap_step_matches_single_device(base, exchange):
    """Per-voxel equivalence of the shard_map step vs single device, for
    BOTH mover-exchange collectives: the full ``all_gather`` and the
    neighbor ``ppermute`` ring (hops=1 covers this scene -- slabs are 2 m
    thick and per-frame motion is ~0.2 m, so no mover crosses two slab
    boundaries; ``mover_overflow_killed`` equality asserts none were
    ring-dropped)."""
    import dataclasses

    n_dev = 4
    if len(jax.devices()) < n_dev:
        pytest.skip("not enough devices")
    cfg = dataclasses.replace(
        cfg_for(n_dev, base), mover_exchange=exchange
    ).validate()
    frames = _frames(cfg)

    s1 = init_state(cfg, jax.random.key(0))
    step1 = jax.jit(make_step(cfg))
    for f in frames:
        s1, o1 = step1(s1, f)

    mesh = make_mesh(n_dev)
    step2 = make_shardmap_step(cfg, mesh)
    s2 = shard_state(init_state(cfg, jax.random.key(0)), mesh)
    for f in frames:
        s2, o2 = step2(s2, f)

    assert bool(o1.accepted) and bool(o2.accepted)
    assert int(o1.metrics["alive"]) > 0  # non-vacuous: the map has particles
    np.testing.assert_allclose(
        np.asarray(s1.weight_sum), np.asarray(s2.weight_sum), rtol=1e-5,
        atol=1e-7,
    )
    np.testing.assert_allclose(
        np.asarray(s1.future), np.asarray(s2.future), rtol=1e-5, atol=1e-7
    )
    # per-voxel particle populations identical (slot order may permute)
    np.testing.assert_array_equal(
        _voxel_flag_counts(s1.particles.flags),
        _voxel_flag_counts(s2.particles.flags),
    )
    for k in ("alive", "born", "movers", "in_fov", "updated_particles",
              "culled", "mover_overflow_killed", "voxel_full_killed"):
        assert int(o1.metrics[k]) == int(o2.metrics[k]), k

    # the state really is distributed
    assert len(s2.particles.weight.sharding.device_set) == n_dev


def test_shardmap_noisy_path_matches_single_device_at_zero_sigma():
    """The noisy-propagation (separate propagate/rebin/register_fov) path
    under shard_map, pinned deterministic by sigma_v = 0.

    Tolerance story: the measurement update's C(z) normalizer is a full-pool
    sum on one device but a psum of per-slab partials under shard_map --
    same value up to summation order, i.e. ulps.  A particle whose weight
    sits exactly at a cull/resample threshold can amplify those ulps into a
    whole-particle difference in ONE voxel (observed: 1/4096 voxels, 0.3%).
    So: isolated flips are tolerated (<= 4 voxels), per-voxel weights match
    everywhere else, total mass matches to 1e-3, counters to +/-4."""
    import dataclasses

    n_dev = 4
    if len(jax.devices()) < n_dev:
        pytest.skip("not enough devices")
    cfg = dataclasses.replace(
        cfg_for(n_dev), limit_motion_to_xy_plane=False,
        velocity_noise_std=0.0,
    ).validate()
    frames = _frames(cfg)

    s1 = init_state(cfg, jax.random.key(0))
    step1 = jax.jit(make_step(cfg))
    for f in frames:
        s1, o1 = step1(s1, f)

    mesh = make_mesh(n_dev)
    step2 = make_shardmap_step(cfg, mesh)
    s2 = shard_state(init_state(cfg, jax.random.key(0)), mesh)
    for f in frames:
        s2, o2 = step2(s2, f)

    assert bool(o1.accepted) and bool(o2.accepted)
    assert int(o1.metrics["alive"]) > 0  # non-vacuous: the map has particles
    w1, w2 = np.asarray(s1.weight_sum), np.asarray(s2.weight_sum)
    flipped = ~np.isclose(w1, w2, rtol=1e-5, atol=1e-7)
    assert flipped.sum() <= 4, (np.nonzero(flipped)[0], w1[flipped],
                                w2[flipped])
    np.testing.assert_allclose(w1.sum(), w2.sum(), rtol=1e-3)
    c1 = _voxel_flag_counts(s1.particles.flags)
    c2 = _voxel_flag_counts(s2.particles.flags)
    assert (c1 != c2).any(axis=0).sum() <= 4
    for k in ("alive", "born", "movers", "in_fov", "updated_particles",
              "culled", "mover_overflow_killed", "voxel_full_killed"):
        assert abs(int(o1.metrics[k]) - int(o2.metrics[k])) <= 4, k


def test_shardmap_noisy_path_runs_with_noise():
    """sigma_v > 0 under shard_map: each slab folds the shard index into its
    noise key (models/pipeline.py) -- the step must run, stay finite, and
    keep a live population."""
    import dataclasses

    n_dev = 4
    if len(jax.devices()) < n_dev:
        pytest.skip("not enough devices")
    cfg = dataclasses.replace(
        cfg_for(n_dev), limit_motion_to_xy_plane=False,
        velocity_noise_std=0.1,
    ).validate()

    mesh = make_mesh(n_dev)
    step = make_shardmap_step(cfg, mesh)
    s = shard_state(init_state(cfg, jax.random.key(0)), mesh)
    for f in _frames(cfg, n=3):
        s, o = step(s, f)
    assert bool(o.accepted)
    assert int(o.metrics["alive"]) > 0
    assert np.isfinite(np.asarray(s.weight_sum)).all()
    assert np.isfinite(np.asarray(o.weight_sum)).all()
