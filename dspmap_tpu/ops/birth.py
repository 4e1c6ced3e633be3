"""Particle birth around observed points with Dempster-Shafer static/dynamic
arbitration (``mapAddNewBornParticlesByObservation``,
``include/dsp_dynamic.h:796-921``; zero-velocity form ``dsp_static.h:780-829``).

Semantics preserved:

* newborn weight ``w = w_b * sum_z 1/C(z)`` -- the paper's delayed
  weight-update trick (``dsp_dynamic.h:798-805``),
* per point, existing non-newborn particles in the point's voxel are
  classified by L1 speed (<0.1 static, <0.5 ambiguous, else dynamic) and the
  DS combination splits the 80% model quota between static and
  estimator-velocity newborns, with a floor on the static share
  (``dsp_dynamic.h:829-866``),
* birth categories by newborn index b (``dsp_dynamic.h:868-907``):
  ``b < n_static`` -> v=0;  else if the cluster velocity is known
  (``normal_x > -100``) and ``b < n_model`` -> v = v_est + 4*sigma_v*noise
  (v=0 for non-dynamic-cluster points);  else uniform random
  [-1.5,1.5]^2 x [-0.5,0.5] (v=0 for non-dynamic points),
* empty-voxel DS degenerates to the minimum static share, mirroring the
  reference's 0/0 -> NaN -> (int)NaN -> clamp-by-max path
  (``dsp_dynamic.h:851-866``; float->int of NaN is x86 INT_MIN, and
  ``max(min_static, INT_MIN)`` lands on the floor),
* jittered newborns falling outside the map are dropped, full voxels drop
  the surplus (``dsp_dynamic.h:875,911``).

Parallel deviation (documented): the reference classifies each point against
a pool that already contains earlier points' newborns inside the same loop
(excluded only by the flag test ``dsp_dynamic.h:830``); we classify every
point against the coherent pre-birth pool.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import MapConfig
from .. import geometry
from .insert import insert_particles
from ..state import FLAG_NEWBORN


def birth_table(cfg: MapConfig, key, est_points, est_vel, est_dynamic,
                w_static, w_mid, w_dyn, rt=None):
    """Dempster-Shafer arbitration + the newborn candidate table
    (``dsp_dynamic.h:850-907``), shared by both storage layouts.

    ``w_static/w_mid/w_dyn [P]`` are the per-point class weight sums of the
    point's voxel (computed by the caller from its layout).  Returns
    ``(pos [P, n_b, 3], vel [P, n_b, 3])``."""
    P = est_points.shape[0]
    n_b = cfg.newborn_particles_per_point
    sigma_p = cfg.position_noise_std if rt is None else rt.position_noise_std
    sigma_v = cfg.velocity_noise_std if rt is None else rt.velocity_noise_std

    total = w_static + w_mid + w_dyn
    p_static = (2.0 * w_static + w_mid) * 0.5
    p_dynamic = (2.0 * w_dyn + w_mid) * 0.5
    p_static_norm = jnp.where(total > 0.0, p_static / (p_static + p_dynamic), 0.0)

    n_model = cfg.model_newborns
    n_static = jnp.maximum(
        cfg.min_static_newborns,
        jnp.floor(n_model * p_static_norm).astype(jnp.int32),
    )  # [P]

    key_p, key_v, key_u = jax.random.split(key, 3)
    b = jnp.arange(n_b, dtype=jnp.int32)[None, :]  # [1, n_b]
    pos = (
        est_points[:, None, :]
        + jax.random.normal(key_p, (P, n_b, 3), jnp.float32) * sigma_p
    )

    if cfg.motion_model == "static":
        # dsp_static.h:804-824: every newborn is static, no DS arbitration.
        vel = jnp.zeros((P, n_b, 3), jnp.float32)
    else:
        vel_known = est_vel[:, 0] > -100.0  # sentinel test (dsp_dynamic.h:881)
        v_model = jnp.where(
            est_dynamic[:, None, None],
            est_vel[:, None, :]
            + cfg.estimator_newborn_noise_gain
            * sigma_v
            * jax.random.normal(key_v, (P, n_b, 3), jnp.float32),
            0.0,
        )
        span = jnp.asarray(
            [cfg.random_newborn_vxy, cfg.random_newborn_vxy, cfg.random_newborn_vz],
            jnp.float32,
        )
        v_random = jnp.where(
            est_dynamic[:, None, None],
            jax.random.uniform(key_u, (P, n_b, 3), jnp.float32, -1.0, 1.0) * span,
            0.0,
        )
        is_static_b = b < n_static[:, None]
        is_model_b = (~is_static_b) & vel_known[:, None] & (b < n_model)
        vel = jnp.where(
            is_static_b[:, :, None],
            0.0,
            jnp.where(is_model_b[:, :, None], v_model, v_random),
        )
        if cfg.limit_motion_to_xy_plane:
            vel = vel.at[:, :, 2].set(0.0)  # dsp_dynamic.h:905-907
    return pos, vel


def particle_birth_compact(
    particles,
    cfg: MapConfig,
    key: jax.Array,
    *,
    est_points: jnp.ndarray,
    est_vel: jnp.ndarray,
    est_dynamic: jnp.ndarray,
    est_valid: jnp.ndarray,
    norm_coeff: jnp.ndarray,
    origin: jnp.ndarray,
    update_time,
    rt=None,
    shard=None,
):
    """Particle birth over the compact layout (``cfg.layout == "compact"``,
    ops/compact.py): identical semantics to :func:`particle_birth`, but the
    per-voxel class-weight tables come from one O(alive) scatter-add instead
    of a slot-axis pool reduce, and insertion lands in free rows of the
    compact array (per-voxel capacity exact, global row budget counted).

    Shard_map fast path (``shard`` set): the class tables are computed from
    this shard's owned rows and the per-point sums ``psum``-combined; every
    shard derives the identical birth table from the identical RNG, and each
    newborn candidate is inserted only by the shard owning its jittered
    destination voxel (mirrors the pool path's sharded birth)."""
    from .compact import insert_compact, segment_table

    n_b = cfg.newborn_particles_per_point
    w_b = cfg.newborn_particle_weight if rt is None else rt.newborn_particle_weight
    w_new = w_b * norm_coeff  # dsp_dynamic.h:798-805
    # shard_map fast path: tables/cells are slab-local (see ops/compact.py)
    Vs = (cfg.storage_voxels if shard is None
          else cfg.storage_voxels // shard.n_shards)
    lo = 0 if shard is None else shard.lo
    Pts = est_points.shape[0]

    # --- per-voxel class tables (one O(alive) scatter-add) --------------
    considered = (particles.flags != 0) & (particles.flags != FLAG_NEWBORN)
    if cfg.motion_model == "static":
        v_planes = ()
    elif cfg.limit_motion_to_xy_plane:
        v_planes = (particles.vx, particles.vy)
    else:
        v_planes = (particles.vx, particles.vy, particles.vz)
    l1 = sum((jnp.abs(v) for v in v_planes),
             jnp.zeros_like(particles.weight))
    w_c = jnp.where(considered, particles.weight, 0.0)
    wx_, wy_, wz_ = geometry.world_voxel_planar(
        particles.px, particles.py, particles.pz, cfg
    )
    cell_p = geometry.storage_index_planar(wx_, wy_, wz_, cfg) - lo
    alive = particles.flags != 0
    w_static_v, w_mid_v, w_dyn_v, count_v = segment_table(
        cell_p, alive,
        (
            jnp.where(considered & (l1 < 0.1), w_c, 0.0),
            jnp.where(considered & (l1 >= 0.1) & (l1 < 0.5), w_c, 0.0),
            jnp.where(considered & (l1 >= 0.5), w_c, 0.0),
            alive,  # current occupancy (capacity baseline)
        ),
        Vs,
        max_run=cfg.slots_per_voxel,
    )

    wv = geometry.world_voxel(est_points, cfg)
    in_map = geometry.in_window(wv, origin, cfg)
    point_valid = est_valid & in_map
    cell_g = jnp.where(point_valid, geometry.storage_index(wv, cfg), 0)
    if shard is None:
        owned = point_valid
        cell = cell_g
    else:
        owned = point_valid & shard.owns(cell_g, Vs)
        cell = jnp.clip(cell_g - shard.lo, 0, Vs - 1)
    w_static = jnp.where(owned, w_static_v[cell], 0.0)
    w_mid = jnp.where(owned, w_mid_v[cell], 0.0)
    w_dyn = jnp.where(owned, w_dyn_v[cell], 0.0)
    if shard is not None:
        w_static, w_mid, w_dyn = jax.lax.psum(
            (w_static, w_mid, w_dyn), shard.axis
        )

    pos, vel = birth_table(
        cfg, key, est_points, est_vel, est_dynamic,
        w_static, w_mid, w_dyn, rt=rt,
    )
    births = Pts * n_b
    valid = jnp.broadcast_to(point_valid[:, None], (Pts, n_b)).ravel()
    new_particles, born, over = insert_compact(
        particles, cfg,
        pos=pos.reshape(births, 3),
        vel=vel.reshape(births, 3),
        weight=jnp.full((births,), w_new, jnp.float32),
        valid=valid,
        origin=origin,
        flag=FLAG_NEWBORN,
        t=update_time if cfg.record_particle_time else None,
        count_v=count_v,
        budget=cfg.birth_insert_budget,
        shard=shard,
    )
    stats = {
        "birth_candidates": jnp.sum(valid),
        "born": born,
        "newborn_weight": w_new,
        "pool_overflow": over,
    }
    return new_particles, stats


def particle_birth(
    particles,
    cfg: MapConfig,
    key: jax.Array,
    *,
    est_points: jnp.ndarray,  # [P, 3] world points from the estimator
    est_vel: jnp.ndarray,  # [P, 3] cluster velocity (sentinel < -100 if unknown)
    est_dynamic: jnp.ndarray,  # [P] bool: from a dynamic-candidate cluster
    est_valid: jnp.ndarray,  # [P] bool
    norm_coeff: jnp.ndarray,  # scalar: sum_z 1/C(z) from the update
    origin: jnp.ndarray,
    update_time,
    shard=None,  # common.ShardCtx inside the shard_map fast path
    rt=None,  # state.RuntimeParams: live-settable scalars (None -> cfg)
    pending=None,  # deferred mover payload (huge pools; insert.scatter_candidates)
):
    """Returns ``(new_particles, stats)``.

    Shard_map fast path (``shard`` set): the DS classification sums are
    computed from each shard's owned voxels and ``psum``-combined (the
    estimator points are replicated, so every shard derives the identical
    birth table from the identical RNG); each newborn candidate is then
    inserted only by the shard owning its jittered destination voxel.
    """
    P = est_points.shape[0]
    n_b = cfg.newborn_particles_per_point
    w_b = cfg.newborn_particle_weight if rt is None else rt.newborn_particle_weight
    sigma_p = cfg.position_noise_std if rt is None else rt.position_noise_std
    sigma_v = cfg.velocity_noise_std if rt is None else rt.velocity_noise_std

    # Newborn weight from the C-normalizer sum (dsp_dynamic.h:798-805);
    # ``norm_coeff`` is computed by the measurement update over both
    # observation tiers.
    w_new = w_b * norm_coeff

    # --- per-point DS classification (dsp_dynamic.h:827-866) -----------
    wv = geometry.world_voxel(est_points, cfg)
    in_map = geometry.in_window(wv, origin, cfg)
    point_valid = est_valid & in_map
    from .common import pool_sv

    cell_g = jnp.where(point_valid, geometry.storage_index(wv, cfg), 0)
    S_pool, V_local = pool_sv(particles.flags, cfg)
    if shard is None:
        cell = cell_g
        owned = point_valid
    else:
        owned = point_valid & shard.owns(cell_g, V_local)
        cell = jnp.clip(cell_g - shard.lo, 0, V_local - 1)

    # Per-VOXEL class-weight tables by one slot-axis reduce over the pool,
    # then cheap [P] row gathers -- the per-point column-gather form
    # (``particles.weight[:, cell]`` etc.) made XLA materialize a
    # dim-transposed {0,1} copy of all five pool planes to serve the [S, P]
    # column gathers.  The reduce reads the same planes sequentially
    # instead.
    # Flat mid-frame pools (state.flatten_pool) sum S contiguous [V] slices
    # instead of reshaping back to [S, V] (which would pay a relayout copy
    # per plane -- the cost the flat phase exists to avoid).
    # Velocity planes whose values are identically zero for every considered
    # particle (the write-site clamp invariant, models/pipeline.py: vz under
    # limit-xy per dsp_dynamic.h:661-663, all three under the static model
    # per dsp_static.h:640-646) drop out of the L1 speed -- skipping their
    # full-plane reads.
    if cfg.motion_model == "static":
        v_axes = ()
    elif cfg.limit_motion_to_xy_plane:
        v_axes = (0, 1)
    else:
        v_axes = (0, 1, 2)
    v_planes = tuple((particles.vx, particles.vy, particles.vz)[a]
                     for a in v_axes)
    if particles.flags.ndim == 1:
        w_static_v = jnp.zeros((V_local,), jnp.float32)
        w_mid_v = jnp.zeros((V_local,), jnp.float32)
        w_dyn_v = jnp.zeros((V_local,), jnp.float32)
        for s in range(S_pool):
            sl = slice(s * V_local, (s + 1) * V_local)
            fl = particles.flags[sl]
            l1 = sum((jnp.abs(v[sl]) for v in v_planes),
                     jnp.zeros((V_local,), jnp.float32))
            w_c = jnp.where(
                (fl != 0) & (fl != FLAG_NEWBORN), particles.weight[sl], 0.0
            )
            w_static_v = w_static_v + jnp.where(l1 < 0.1, w_c, 0.0)
            w_mid_v = w_mid_v + jnp.where((l1 >= 0.1) & (l1 < 0.5), w_c, 0.0)
            w_dyn_v = w_dyn_v + jnp.where(l1 >= 0.5, w_c, 0.0)
    else:
        considered = (particles.flags != 0) & (particles.flags != FLAG_NEWBORN)
        l1 = sum((jnp.abs(v) for v in v_planes),
                 jnp.zeros_like(particles.weight))  # [S, V]
        w_c = jnp.where(considered, particles.weight, 0.0)
        w_static_v = jnp.sum(jnp.where(l1 < 0.1, w_c, 0.0), axis=0)  # [V]
        w_mid_v = jnp.sum(jnp.where((l1 >= 0.1) & (l1 < 0.5), w_c, 0.0), axis=0)
        w_dyn_v = jnp.sum(jnp.where(l1 >= 0.5, w_c, 0.0), axis=0)
    if pending is not None:
        # Mover payload deferral (ops/fov.py, huge pools): the re-inserted
        # movers' six pos/vel plane scatters ride THIS op's insert below, so
        # the pool's velocity planes still hold the previous occupants'
        # stale values at the deferred slots -- but their flags are 1 and
        # their (post-update) weights are live, so the slot-axis reduce
        # above classified their weight by the STALE L1 speed.  Three
        # [M]->[V] scatter-adds move each deferred slot's weight from its
        # stale class to its true one ([M] ~ mover capacity; vastly cheaper
        # than the plane copies the deferral saves).  Float association
        # differs from the direct sum by ~1e-7 relative -- same class of
        # shift as any fusion re-association; the distributional parity
        # suites are the gate.  Reference: classification includes moved
        # particles with their true velocities (dsp_dynamic.h:827-866).
        e_flat, e_cols = pending
        assert particles.flags.ndim == 1  # deferral only on the flat path
        e_ok = e_flat < S_pool * V_local
        ef = jnp.where(e_ok, e_flat, 0)
        e_cell = ef % V_local
        w_p = jnp.where(e_ok, particles.weight[ef], 0.0)
        # Same plane subset as the slot-axis reduce above (v_axes): the
        # delta must subtract EXACTLY what the reduce added for these slots
        # (a stale-garbage vz at a dead-then-reused slot would otherwise
        # break the cancellation under limit-xy, where the reduce skips vz).
        stale_l1 = sum((jnp.abs(v[ef]) for v in v_planes),
                       jnp.zeros_like(w_p))
        true_l1 = sum((jnp.abs(e_cols[3 + a]) for a in v_axes),
                      jnp.zeros_like(w_p))

        def cls_delta(lo, hi):
            in_t = ((true_l1 >= lo) & (true_l1 < hi)).astype(jnp.float32)
            in_s = ((stale_l1 >= lo) & (stale_l1 < hi)).astype(jnp.float32)
            return w_p * (in_t - in_s)

        inf = jnp.float32(jnp.inf)
        w_static_v = w_static_v.at[e_cell].add(cls_delta(0.0, 0.1))
        w_mid_v = w_mid_v.at[e_cell].add(cls_delta(0.1, 0.5))
        w_dyn_v = w_dyn_v.at[e_cell].add(cls_delta(0.5, inf))

    w_static = jnp.where(owned, w_static_v[cell], 0.0)  # [P]
    w_mid = jnp.where(owned, w_mid_v[cell], 0.0)
    w_dyn = jnp.where(owned, w_dyn_v[cell], 0.0)
    if shard is not None:
        w_static, w_mid, w_dyn = jax.lax.psum(
            (w_static, w_mid, w_dyn), shard.axis
        )

    pos, vel = birth_table(
        cfg, key, est_points, est_vel, est_dynamic,
        w_static, w_mid, w_dyn, rt=rt,
    )
    births = P * n_b
    valid = jnp.broadcast_to(point_valid[:, None], (P, n_b)).ravel()
    new_particles = insert_particles(
        particles,
        cfg,
        pos=pos.reshape(births, 3),
        vel=vel.reshape(births, 3),
        weight=jnp.full((births,), w_new, jnp.float32),
        valid=valid,
        origin=origin,
        flag=FLAG_NEWBORN,
        t=update_time if cfg.record_particle_time else None,
        compact_to=cfg.birth_insert_budget,
        cell_base=0 if shard is None else shard.lo,
        extra=pending,
    )
    stats = {
        "birth_candidates": jnp.sum(valid),
        "born": jnp.sum(new_particles.newborn),
        "newborn_weight": w_new,
    }
    return new_particles, stats
