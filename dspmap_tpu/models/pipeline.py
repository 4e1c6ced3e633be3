"""The per-frame signal chain: one jittable ``step(state, frame)`` reproducing
``DSPMap::update`` (``include/dsp_dynamic.h:181-353``) end to end:

ingest -> velocity estimation -> prediction -> rebin -> FOV registration ->
measurement update -> particle birth -> occupancy/future/resample

(call-stack parity: SURVEY.md section 3.1).  The reference overlaps the
estimator on a worker thread (``dsp_dynamic.h:297,311``); in the traced graph
the estimator has no data dependence on prediction/update, so XLA is free to
schedule them concurrently -- same overlap, no thread.

Frame admission control matches the reference: invalid quaternion or a >10 m
ego jump or dt outside (0, 10] skips the frame wholesale
(``dsp_dynamic.h:193-208``) -- expressed as a ``lax.cond`` over the entire
step body so a skipped frame is the identity on state.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import MapConfig
from .. import geometry
from ..state import MapState, flatten_pool
from ..estimator import estimate_velocities
from ..ops.propagate import propagate
from ..ops.rebin import rebin
from ..ops.project import project_points
from ..ops.fov import register_fov, rebin_and_register
from ..ops.update import measurement_update
from ..ops.birth import particle_birth
from ..ops.occupancy import occupancy_and_resample
from ..ops.sweep import sweep


class Frame(NamedTuple):
    """One sensor frame (the arguments of ``DSPMap::update``,
    dsp_dynamic.h:181-184)."""

    points: jnp.ndarray  # f32 [P, 3] body-frame points (after axis remap)
    n_points: jnp.ndarray  # i32 scalar: valid prefix length of ``points``
    sensor_pos: jnp.ndarray  # f32 [3] world position
    quat: jnp.ndarray  # f32 [4] wxyz body->world attitude
    timestamp: jnp.ndarray  # f32 seconds (use stream-relative times)


class StepOutput(NamedTuple):
    accepted: jnp.ndarray  # bool: frame passed admission control
    weight_sum: jnp.ndarray  # f32 [V] per-voxel occupancy weight (storage order)
    metrics: dict  # scalar counters
    #: the estimator's clustered cloud with per-point velocities -- the
    #: getKMClusterResult surface (dsp_dynamic.h:441-445): points[P,3] world,
    #: vel[P,3] (< -100 = unmatched dynamic cluster), dynamic[P], valid[P]
    estimator_cloud: tuple


#: step metrics that are computed from replicated inputs inside the
#: shard_map fast path (psum-ing them would multiply by the mesh size);
#: every other counter is a per-shard partial sum.
_REPLICATED_METRICS = frozenset(
    {"valid_points", "newborn_weight", "birth_candidates",
     "obs_spill_overflow"}
)


def make_step(cfg: MapConfig, with_metrics: bool = True,
              admission_control: bool = True, shard=None):
    """Build the jittable per-frame transition for ``cfg``.

    ``with_metrics=False`` elides the ~20 observability reductions (about a
    millisecond per frame of mask sums over the pool) for
    latency-critical deployments; ``StepOutput.metrics`` then carries only
    ``alive`` (needed by callers) and zeros elsewhere.

    ``admission_control=False`` drops the frame-rejection ``lax.cond``
    wrapper (dsp_dynamic.h:193-208) and runs the body unconditionally --
    for profiling only: the cond swallows per-op source attribution in
    device traces (every fusion reports the cond's line).

    ``shard`` (an :class:`~..ops.common.ShardCtx`) builds the body for the
    hand-scheduled ``shard_map`` fast path (``parallel.shard_step``): state
    operands are this shard's slab, observations are replicated, and the
    cross-shard points (C-normalizer psum, mover/future-mover exchange,
    birth classification psum, metrics psum) run as explicit collectives.
    Noisy-propagation configurations fold the shard index into the
    pool-shaped noise keys so each slab draws independent noise (see the
    prediction branch below); their mover exchange runs in ``ops.rebin``.

    ``cfg.layout == "compact"`` builds the alive-proportional step instead
    (ops/compact.py): identical per-frame semantics over the ``[P]`` compact
    particle array -- the measurement update, estimator and ingest stages
    are shared verbatim; prediction/rebin/FOV/birth/occupancy run as
    O(alive) work.
    """
    cfg.validate()
    if cfg.layout == "compact":
        return _make_step_compact(cfg, with_metrics, admission_control, shard)

    def step(state: MapState, frame: Frame):
        q_ok = geometry.quaternion_is_valid(frame.quat)

        last_pos = jnp.where(
            state.initialized, state.last_sensor_pos, frame.sensor_pos
        )
        last_t = jnp.where(state.initialized, state.last_timestamp, frame.timestamp)
        delta_p = frame.sensor_pos - last_pos
        dt = frame.timestamp - last_t
        jump_ok = jnp.all(jnp.abs(delta_p) <= 10.0) & (dt >= 0.0) & (dt <= 10.0)
        accepted = q_ok & jump_ok

        def run(state: MapState):
            origin = geometry.window_origin(frame.sensor_pos, cfg)
            keys = jax.random.split(state.rng, 6)
            update_time = state.update_time + dt
            rt = state.params  # live-settable scalars (RuntimeParams)

            # -- ingest (dsp_dynamic.h:234-293) -------------------------
            point_valid = (
                jnp.arange(frame.points.shape[0], dtype=jnp.int32) < frame.n_points
            )
            obs = project_points(
                frame.points, point_valid, frame.sensor_pos, frame.quat, cfg
            )
            expected_newborn = (
                rt.newborn_particle_weight
                * obs.n_valid_points.astype(jnp.float32)
                * cfg.newborn_particles_per_point
            )  # dsp_dynamic.h:292

            # -- velocity estimation (dsp_dynamic.h:297,1377) -----------
            est_out, est_state = estimate_velocities(
                obs.cloud_world, obs.cloud_valid, state.estimator, cfg, dt, keys[0]
            )

            # -- prediction + rebin + FOV (dsp_dynamic.h:300,627-701,
            # 1232-1271).  Deterministic-prediction configurations (the
            # reference's own noise quirk makes limit-xy and static modes
            # noise-free, ops/propagate.py) take the fused-sweep path: one
            # pool pass computes advance, window masks and pyramid geometry.
            if cfg.limit_motion_to_xy_plane or cfg.motion_model == "static":
                # The reference's per-prediction velocity clamp (vz=0 under
                # LIMIT_MOVEMENT_IN_XY_PLANE, dsp_dynamic.h:661-663; v=0 in
                # the static model, dsp_static.h:640-646) is a no-op on
                # valid particles here -- every velocity write under these
                # configs already conforms: birth (ops/birth.py: static
                # model writes v=0, limit-xy zeroes the vz lane per
                # dsp_dynamic.h:905-907), mover and resample copies
                # (conforming -> conforming), and add_random_particles
                # (clamped at draw time, state.py).  The clamped planes are
                # therefore replaced with LITERAL zeros rather than a
                # masked ``where`` pass: a constant plane costs nothing
                # (XLA folds every pre-insert read of it away -- the sweep
                # advance, birth's L1 classification -- and fuses the
                # zero-fill into the insert scatters), while the ``where``
                # form would pay a full pool-plane read+write and force real
                # reads downstream.  Observable content is identical: valid
                # slots hold 0 either way, invalid slots are dead (every
                # consumer masks by flags; insert overwrites on reuse).
                if cfg.motion_model == "static":
                    zeros = jnp.zeros_like(state.particles.vx)
                    particles = dataclasses.replace(
                        state.particles, vx=zeros, vy=zeros, vz=zeros
                    )
                else:
                    particles = dataclasses.replace(
                        state.particles,
                        vz=jnp.zeros_like(state.particles.vz),
                    )
                sw = sweep(
                    particles, cfg, dt, origin, frame.sensor_pos, frame.quat,
                    cell_base=0 if shard is None else shard.lo,
                )
                particles = dataclasses.replace(
                    particles, px=sw.px, py=sw.py, pz=sw.pz, flags=sw.flags
                )
                # -- flat mid-frame phase (state.flatten_pool): every
                # scatter/gather site from here through birth runs on flat
                # [S*V] planes (native layout for XLA's linearized pool
                # scatters -- no tiled<->flat relayout copy pair per plane
                # per site); occupancy_and_resample converts back once.
                particles = flatten_pool(
                    particles,
                    skip=() if cfg.record_particle_time else ("t",),
                )
                # Re-issue the constant-zero velocity planes in flat form so
                # every flat-phase read of them stays constant-foldable.
                if cfg.motion_model == "static":
                    zf = jnp.zeros_like(particles.vx)
                    particles = dataclasses.replace(
                        particles, vx=zf, vy=zf, vz=zf
                    )
                elif cfg.limit_motion_to_xy_plane:
                    particles = dataclasses.replace(
                        particles, vz=jnp.zeros_like(particles.vz)
                    )
                sw = sw._replace(
                    tags=sw.tags.reshape(-1),
                    new_cell=sw.new_cell.reshape(-1),
                )
                particles, fovbin, future_movers, fov_stats, pending = (
                    rebin_and_register(
                        particles, cfg, sw, frame.sensor_pos, update_time,
                        shard=shard,
                    )
                )
                rebin_stats = {}
            else:
                # Pool-shaped noise under shard_map: each shard's slab must
                # draw DISTINCT noise (a replicated key would correlate the
                # slabs), so the propagation/FOV keys fold in the shard
                # index.  Binning and the measurement-update psum handle the
                # rest (SURVEY.md section 7.1.7).
                k_prop, k_fov = keys[1], keys[2]
                if shard is not None:
                    sid = jax.lax.axis_index(shard.axis)
                    k_prop = jax.random.fold_in(k_prop, sid)
                    k_fov = jax.random.fold_in(k_fov, sid)
                particles = propagate(state.particles, cfg, k_prop, dt, rt=rt)
                particles, rebin_stats = rebin(
                    particles, cfg, origin, update_time, shard=shard
                )
                particles, fovbin, fov_stats = register_fov(
                    particles, cfg, frame.sensor_pos, frame.quat, k_fov, rt=rt
                )
                future_movers = None
                pending = None

            # -- measurement update (dsp_dynamic.h:304,704-793) ---------
            particles, norm_coeff, upd_stats = measurement_update(
                particles, fovbin, obs, cfg, expected_newborn, update_time,
                axis_name=None if shard is None else shard.axis,
                rt=rt,
            )

            # -- particle birth (dsp_dynamic.h:315,796-921) -------------
            particles, birth_stats = particle_birth(
                particles,
                cfg,
                keys[3],
                est_points=est_out.points,
                est_vel=est_out.vel,
                est_dynamic=est_out.dynamic,
                est_valid=est_out.valid,
                norm_coeff=norm_coeff,
                origin=origin,
                update_time=update_time,
                shard=shard,
                rt=rt,
                pending=pending,
            )

            # -- occupancy + future + resample (dsp_dynamic.h:322,924) --
            particles, weight_sum, vel_avg, future, occ_stats = (
                occupancy_and_resample(
                    particles, cfg, origin, state.future, future_movers,
                    shard=shard,
                )
            )

            new_state = dataclasses.replace(
                state,
                particles=particles,
                weight_sum=weight_sum,
                vel_avg=vel_avg,
                future=future,
                rng=keys[5],
                sensor_pos=frame.sensor_pos,
                last_sensor_pos=frame.sensor_pos,
                origin=origin,
                update_time=update_time,
                last_timestamp=frame.timestamp,
                update_counter=state.update_counter + 1,
                initialized=jnp.asarray(True),
                estimator=est_state,
            )
            if with_metrics:
                metrics = {
                    "valid_points": obs.n_valid_points,
                    **rebin_stats,
                    **fov_stats,
                    **upd_stats,
                    **birth_stats,
                    **occ_stats,
                }
            else:
                metrics = {"alive": occ_stats["alive"]}
            if shard is not None:
                metrics = {
                    k: (v if k in _REPLICATED_METRICS
                        else jax.lax.psum(v, shard.axis))
                    for k, v in metrics.items()
                }
            cloud = (est_out.points, est_out.vel, est_out.dynamic, est_out.valid)
            return new_state, metrics, cloud

        def skip(state: MapState):
            shapes = jax.eval_shape(run, state)
            zeros = jax.tree.map(lambda x: jnp.zeros_like(x), shapes[1:])
            return (state,) + zeros

        if admission_control:
            new_state, metrics, cloud = jax.lax.cond(accepted, run, skip, state)
        else:
            new_state, metrics, cloud = run(state)
        return new_state, StepOutput(
            accepted=accepted,
            weight_sum=new_state.weight_sum,
            metrics=metrics,
            estimator_cloud=cloud,
        )

    return step


def _make_step_compact(cfg: MapConfig, with_metrics: bool = True,
                       admission_control: bool = True, shard=None):
    """The per-frame transition over the compact particle layout
    (``ops/compact.py``): same call order as the pool-layout step
    (``DSPMap::update``, dsp_dynamic.h:181-353) with every pool pass
    replaced by O(alive) sorts/segment scans/scatter-adds."""
    from ..ops.compact import (fov_geometry_compact, occupancy_compact,
                               rebin_compact, rebin_exchange_compact,
                               register_fov_compact, sweep_compact)
    from ..ops.birth import particle_birth_compact

    def step(state: MapState, frame: Frame):
        q_ok = geometry.quaternion_is_valid(frame.quat)
        last_pos = jnp.where(
            state.initialized, state.last_sensor_pos, frame.sensor_pos
        )
        last_t = jnp.where(state.initialized, state.last_timestamp, frame.timestamp)
        delta_p = frame.sensor_pos - last_pos
        dt = frame.timestamp - last_t
        jump_ok = jnp.all(jnp.abs(delta_p) <= 10.0) & (dt >= 0.0) & (dt <= 10.0)
        accepted = q_ok & jump_ok

        def run(state: MapState):
            origin = geometry.window_origin(frame.sensor_pos, cfg)
            keys = jax.random.split(state.rng, 6)
            update_time = state.update_time + dt
            rt = state.params

            # -- ingest (dsp_dynamic.h:234-293) -------------------------
            point_valid = (
                jnp.arange(frame.points.shape[0], dtype=jnp.int32) < frame.n_points
            )
            obs = project_points(
                frame.points, point_valid, frame.sensor_pos, frame.quat, cfg
            )
            expected_newborn = (
                rt.newborn_particle_weight
                * obs.n_valid_points.astype(jnp.float32)
                * cfg.newborn_particles_per_point
            )

            # -- velocity estimation (dsp_dynamic.h:297,1377) -----------
            est_out, est_state = estimate_velocities(
                obs.cloud_world, obs.cloud_valid, state.estimator, cfg, dt, keys[0]
            )

            # Velocity clamps as write-site invariants (see the pool-layout
            # branch): planes the clamp zeroes are literal zeros.
            particles = state.particles
            if cfg.motion_model == "static":
                z = jnp.zeros_like(particles.vx)
                particles = dataclasses.replace(particles, vx=z, vy=z, vz=z)
            elif cfg.limit_motion_to_xy_plane:
                particles = dataclasses.replace(
                    particles, vz=jnp.zeros_like(particles.vz)
                )

            # -- prediction + rebin + FOV (dsp_dynamic.h:627-701,1206-1279)
            k_sweep, k_fov = keys[1], keys[2]
            if shard is not None and not (
                cfg.limit_motion_to_xy_plane or cfg.motion_model == "static"
            ):
                # pool-shaped noise must differ per slab (see the pool
                # branch's shard note)
                sid = jax.lax.axis_index(shard.axis)
                k_sweep = jax.random.fold_in(k_sweep, sid)
                k_fov = jax.random.fold_in(k_fov, sid)
            particles, sw = sweep_compact(
                particles, cfg, dt, origin, frame.sensor_pos, frame.quat,
                k_sweep, rt=rt,
            )
            if shard is None:
                particles, _, rebin_stats = rebin_compact(particles, sw, cfg)
                pyr, fov_mask = sw.pyr, sw.fov
            else:
                particles, rebin_stats = rebin_exchange_compact(
                    particles, sw, cfg, shard
                )
                # arrivals changed the local population: recompute the FOV
                # geometry elementwise (cheap at [P_local])
                pyr, fov_mask = fov_geometry_compact(
                    particles, cfg, frame.sensor_pos, frame.quat
                )
            particles, fovbin, fov_stats = register_fov_compact(
                particles, cfg, pyr, fov_mask, frame.sensor_pos,
                key=k_fov, rt=rt,
            )

            # -- measurement update (dsp_dynamic.h:704-793) -------------
            particles, norm_coeff, upd_stats = measurement_update(
                particles, fovbin, obs, cfg, expected_newborn, update_time,
                axis_name=None if shard is None else shard.axis,
                rt=rt,
            )

            # -- particle birth (dsp_dynamic.h:796-921) -----------------
            particles, birth_stats = particle_birth_compact(
                particles, cfg, keys[3],
                est_points=est_out.points,
                est_vel=est_out.vel,
                est_dynamic=est_out.dynamic,
                est_valid=est_out.valid,
                norm_coeff=norm_coeff,
                origin=origin,
                update_time=update_time,
                rt=rt,
                shard=shard,
            )

            # -- occupancy + future + resample (dsp_dynamic.h:924-1057) -
            particles, weight_sum, vel_avg, future, occ_stats = (
                occupancy_compact(particles, cfg, origin, state.future,
                                  shard=shard)
            )

            new_state = dataclasses.replace(
                state,
                particles=particles,
                weight_sum=weight_sum,
                vel_avg=vel_avg,
                future=future,
                rng=keys[5],
                sensor_pos=frame.sensor_pos,
                last_sensor_pos=frame.sensor_pos,
                origin=origin,
                update_time=update_time,
                last_timestamp=frame.timestamp,
                update_counter=state.update_counter + 1,
                initialized=jnp.asarray(True),
                estimator=est_state,
            )
            if with_metrics:
                metrics = {
                    "valid_points": obs.n_valid_points,
                    **rebin_stats,
                    **fov_stats,
                    **upd_stats,
                    **birth_stats,
                    **occ_stats,
                }
                # birth + occupancy both report global-row-budget drops
                metrics["pool_overflow"] = (
                    birth_stats["pool_overflow"] + occ_stats["pool_overflow"]
                )
            else:
                metrics = {"alive": occ_stats["alive"]}
            if shard is not None:
                metrics = {
                    k: (v if k in _REPLICATED_METRICS
                        else jax.lax.psum(v, shard.axis))
                    for k, v in metrics.items()
                }
            cloud = (est_out.points, est_out.vel, est_out.dynamic, est_out.valid)
            return new_state, metrics, cloud

        def skip(state: MapState):
            shapes = jax.eval_shape(run, state)
            zeros = jax.tree.map(lambda x: jnp.zeros_like(x), shapes[1:])
            return (state,) + zeros

        if admission_control:
            new_state, metrics, cloud = jax.lax.cond(accepted, run, skip, state)
        else:
            new_state, metrics, cloud = run(state)
        return new_state, StepOutput(
            accepted=accepted,
            weight_sum=new_state.weight_sum,
            metrics=metrics,
            estimator_cloud=cloud,
        )

    return step


def make_multisensor_step(cfg: MapConfig, n_sensors: int):
    """Multi-sensor fusion: one map updated by ``n_sensors`` depth cameras.

    No reference counterpart (the reference is strictly single-sensor,
    SURVEY.md section 2.6); semantics follow the SMC-PHD composition rule:
    prediction/rebin once per frame, then the measurement stage (FOV
    registration -> update -> birth) applied *sequentially* per sensor via
    ``lax.scan`` -- each sensor updates the weights the previous one
    produced, which is the standard sequential multi-sensor PHD
    approximation -- then one occupancy/resample pass.

    ``step(state, frames)`` takes a Frame pytree whose leaves carry a leading
    ``[n_sensors]`` axis; all sensors share the frame's timestamp (taken from
    sensor 0).  Admission control is two-level: the *frame* is rejected only
    on a pose jump / bad timestamp / no usable sensor (sensor 0's pose is the
    vehicle pose, as in the reference's single-sensor gate,
    dsp_dynamic.h:193-208); each *sensor* with an invalid quaternion is
    individually skipped inside the scan (its measurement stage is the
    identity), so one bad camera degrades coverage instead of poisoning the
    shared step.

    ``cfg.layout == "compact"`` runs the same composition over the compact
    particle core (ops/compact.py): one sweep/rebin, per-sensor FOV geometry
    + registration + update + birth inside the scan, one occupancy pass.
    """
    cfg.validate()
    if cfg.layout == "compact":
        return _make_multisensor_step_compact(cfg, n_sensors)

    def step(state: MapState, frames: Frame):
        q_ok = jax.vmap(geometry.quaternion_is_valid)(frames.quat)  # [n]
        last_pos = jnp.where(
            state.initialized, state.last_sensor_pos, frames.sensor_pos[0]
        )
        last_t = jnp.where(
            state.initialized, state.last_timestamp, frames.timestamp[0]
        )
        delta_p = frames.sensor_pos[0] - last_pos
        dt = frames.timestamp[0] - last_t
        jump_ok = jnp.all(jnp.abs(delta_p) <= 10.0) & (dt >= 0.0) & (dt <= 10.0)
        accepted = jnp.any(q_ok) & jump_ok

        def run(state: MapState):
            origin = geometry.window_origin(frames.sensor_pos[0], cfg)
            keys = jax.random.split(state.rng, 4)
            update_time = state.update_time + dt
            rt = state.params

            particles = propagate(state.particles, cfg, keys[0], dt, rt=rt)
            particles, _ = rebin(particles, cfg, origin, update_time)

            def sensor_stage(carry, inp):
                particles, key = carry
                frame, est_state, sensor_ok = inp
                # the key advances whether or not the sensor is admitted, so
                # a flaky camera never perturbs the other sensors' draws
                key, k_est, k_fov, k_birth = jax.random.split(key, 4)

                def admit(operand):
                    particles, est_state = operand
                    point_valid = (
                        jnp.arange(frame.points.shape[0], dtype=jnp.int32)
                        < frame.n_points
                    )
                    obs = project_points(
                        frame.points, point_valid, frame.sensor_pos,
                        frame.quat, cfg
                    )
                    expected_newborn = (
                        rt.newborn_particle_weight
                        * obs.n_valid_points.astype(jnp.float32)
                        * cfg.newborn_particles_per_point
                    )
                    est_out, est_state = estimate_velocities(
                        obs.cloud_world, obs.cloud_valid, est_state, cfg, dt,
                        k_est
                    )
                    particles, fovbin, _ = register_fov(
                        particles, cfg, frame.sensor_pos, frame.quat, k_fov,
                        rt=rt,
                    )
                    particles, norm_coeff, _ = measurement_update(
                        particles, fovbin, obs, cfg, expected_newborn,
                        update_time, rt=rt,
                    )
                    particles, _ = particle_birth(
                        particles, cfg, k_birth,
                        est_points=est_out.points, est_vel=est_out.vel,
                        est_dynamic=est_out.dynamic, est_valid=est_out.valid,
                        norm_coeff=norm_coeff,
                        origin=origin, update_time=update_time,
                        rt=rt,
                    )
                    return particles, est_state

                # per-sensor admission: a bad quaternion skips this sensor's
                # measurement stage (identity), not the whole frame
                particles, est_state = jax.lax.cond(
                    sensor_ok, admit, lambda op: op, (particles, est_state)
                )
                return (particles, key), est_state

            # per-sensor estimator tracks: state.estimator leaves carry a
            # leading [n_sensors] axis (see init_multisensor_state)
            (particles, _), est_state = jax.lax.scan(
                sensor_stage,
                (particles, keys[1]),
                (frames, state.estimator, q_ok),
            )

            particles, weight_sum, vel_avg, future, occ_stats = (
                occupancy_and_resample(particles, cfg, origin, state.future)
            )
            new_state = dataclasses.replace(
                state,
                particles=particles,
                weight_sum=weight_sum,
                vel_avg=vel_avg,
                future=future,
                rng=keys[3],
                sensor_pos=frames.sensor_pos[0],
                last_sensor_pos=frames.sensor_pos[0],
                origin=origin,
                update_time=update_time,
                last_timestamp=frames.timestamp[0],
                update_counter=state.update_counter + 1,
                initialized=jnp.asarray(True),
                estimator=est_state,
            )
            return new_state, occ_stats

        def skip(state: MapState):
            zero = jax.tree.map(
                lambda x: jnp.zeros_like(x), jax.eval_shape(run, state)[1]
            )
            return state, zero

        new_state, metrics = jax.lax.cond(accepted, run, skip, state)
        return new_state, StepOutput(
            accepted=accepted, weight_sum=new_state.weight_sum, metrics=metrics,
            estimator_cloud=(),
        )

    return step


def _make_multisensor_step_compact(cfg: MapConfig, n_sensors: int):
    """Compact-layout multi-sensor fusion (see :func:`make_multisensor_step`
    for the composition semantics -- sequential per-sensor measurement
    stages, one shared prediction and occupancy pass)."""
    from ..ops.compact import (fov_geometry_compact, occupancy_compact,
                               rebin_compact, register_fov_compact,
                               sweep_compact)
    from ..ops.birth import particle_birth_compact

    def step(state: MapState, frames: Frame):
        q_ok = jax.vmap(geometry.quaternion_is_valid)(frames.quat)  # [n]
        last_pos = jnp.where(
            state.initialized, state.last_sensor_pos, frames.sensor_pos[0]
        )
        last_t = jnp.where(
            state.initialized, state.last_timestamp, frames.timestamp[0]
        )
        delta_p = frames.sensor_pos[0] - last_pos
        dt = frames.timestamp[0] - last_t
        jump_ok = jnp.all(jnp.abs(delta_p) <= 10.0) & (dt >= 0.0) & (dt <= 10.0)
        accepted = jnp.any(q_ok) & jump_ok

        def run(state: MapState):
            origin = geometry.window_origin(frames.sensor_pos[0], cfg)
            keys = jax.random.split(state.rng, 4)
            update_time = state.update_time + dt
            rt = state.params

            particles = state.particles
            if cfg.motion_model == "static":
                z = jnp.zeros_like(particles.vx)
                particles = dataclasses.replace(particles, vx=z, vy=z, vz=z)
            elif cfg.limit_motion_to_xy_plane:
                particles = dataclasses.replace(
                    particles, vz=jnp.zeros_like(particles.vz)
                )
            particles, sw = sweep_compact(
                particles, cfg, dt, origin, frames.sensor_pos[0],
                frames.quat[0], keys[0], rt=rt,
            )
            particles, _, _ = rebin_compact(particles, sw, cfg)

            def sensor_stage(carry, inp):
                particles, key = carry
                frame, est_state, sensor_ok = inp
                key, k_est, k_fov, k_birth = jax.random.split(key, 4)

                def admit(operand):
                    particles, est_state = operand
                    point_valid = (
                        jnp.arange(frame.points.shape[0], dtype=jnp.int32)
                        < frame.n_points
                    )
                    obs = project_points(
                        frame.points, point_valid, frame.sensor_pos,
                        frame.quat, cfg
                    )
                    expected_newborn = (
                        rt.newborn_particle_weight
                        * obs.n_valid_points.astype(jnp.float32)
                        * cfg.newborn_particles_per_point
                    )
                    est_out, est_state = estimate_velocities(
                        obs.cloud_world, obs.cloud_valid, est_state, cfg, dt,
                        k_est
                    )
                    pyr, fov_mask = fov_geometry_compact(
                        particles, cfg, frame.sensor_pos, frame.quat
                    )
                    p2, fovbin, _ = register_fov_compact(
                        particles, cfg, pyr, fov_mask, frame.sensor_pos,
                        key=k_fov, rt=rt,
                    )
                    p2, norm_coeff, _ = measurement_update(
                        p2, fovbin, obs, cfg, expected_newborn,
                        update_time, rt=rt,
                    )
                    p2, _ = particle_birth_compact(
                        p2, cfg, k_birth,
                        est_points=est_out.points, est_vel=est_out.vel,
                        est_dynamic=est_out.dynamic, est_valid=est_out.valid,
                        norm_coeff=norm_coeff,
                        origin=origin, update_time=update_time,
                        rt=rt,
                    )
                    return p2, est_state

                particles, est_state = jax.lax.cond(
                    sensor_ok, admit, lambda op: op, (particles, est_state)
                )
                return (particles, key), est_state

            (particles, _), est_state = jax.lax.scan(
                sensor_stage,
                (particles, keys[1]),
                (frames, state.estimator, q_ok),
            )

            particles, weight_sum, vel_avg, future, occ_stats = (
                occupancy_compact(particles, cfg, origin, state.future)
            )
            new_state = dataclasses.replace(
                state,
                particles=particles,
                weight_sum=weight_sum,
                vel_avg=vel_avg,
                future=future,
                rng=keys[3],
                sensor_pos=frames.sensor_pos[0],
                last_sensor_pos=frames.sensor_pos[0],
                origin=origin,
                update_time=update_time,
                last_timestamp=frames.timestamp[0],
                update_counter=state.update_counter + 1,
                initialized=jnp.asarray(True),
                estimator=est_state,
            )
            return new_state, occ_stats

        def skip(state: MapState):
            zero = jax.tree.map(
                lambda x: jnp.zeros_like(x), jax.eval_shape(run, state)[1]
            )
            return state, zero

        new_state, metrics = jax.lax.cond(accepted, run, skip, state)
        return new_state, StepOutput(
            accepted=accepted, weight_sum=new_state.weight_sum,
            metrics=metrics, estimator_cloud=(),
        )

    return step


def get_occupancy_map(state: MapState, cfg: MapConfig, threshold: float = 0.7):
    """Occupancy + future-status readout (``getOccupancyMapWithFutureStatus``,
    dsp_dynamic.h:405-426).

    Returns ``(occupied_mask[V], centers[V, 3], future[V, T], new_state)`` in
    the reference's ego voxel order (z-major, x-fastest from the window's low
    corner); ``centers`` are world-frame voxel centers.  The readout clears
    the future accumulators exactly like the reference (the documented
    destructive-readout contract, dsp_dynamic.h:420-424,429-438) -- made pure
    by returning the cleared state.  For the ego-ordered weights themselves
    use :func:`read_occupancy` which also returns them.
    """
    occupied, centers, future, weight, new_state = read_occupancy(
        state, cfg, threshold
    )
    return occupied, centers, future, new_state


def read_occupancy(state: MapState, cfg: MapConfig, threshold: float = 0.7):
    """Like :func:`get_occupancy_map` but additionally returns the ego-ordered
    per-voxel weight sums: ``(occupied, centers, future, weight, new_state)``."""
    gather = geometry.ego_grid_gather_indices(state.origin, cfg)
    weight = state.weight_sum[gather]
    occupied = weight > threshold
    wv = geometry.storage_to_world_voxel(state.origin, cfg)[gather]
    centers = geometry.voxel_center(wv, cfg)
    # internal grid is horizon-major [T, V] (state.MapState.future); the
    # public readout keeps the reference's [n, T] row order
    future = state.future[:, gather].T
    new_state = dataclasses.replace(state, future=jnp.zeros_like(state.future))
    return occupied, centers, future, weight, new_state


def clear_future_prediction(state: MapState) -> MapState:
    """``clearOccupancyMapPrediction`` (dsp_dynamic.h:429-438) for callers
    that skip the readout."""
    return dataclasses.replace(state, future=jnp.zeros_like(state.future))


# --- live runtime setters (dsp_dynamic.h:355-382) --------------------------
#
# The reference exposes mutating setters on the map object; here the same
# knobs ride :class:`~dspmap_tpu.state.RuntimeParams` inside ``MapState`` as
# traced f32 scalars, so flipping one between frames re-uses the compiled
# step (no re-jit -- asserted by tests/test_pipeline.py).  The reference
# pays a 2x10M-draw RNG-pool regeneration on setPredictionVariance
# (dsp_dynamic.h:1150-1160); keyed jax.random makes the new sigma effective
# immediately.


def _set_params(state: MapState, **kw) -> MapState:
    params = dataclasses.replace(
        state.params, **{k: jnp.float32(v) for k, v in kw.items()}
    )
    return dataclasses.replace(state, params=params)


def set_prediction_variance(state: MapState, position_std, velocity_std) -> MapState:
    """``setPredictionVariance`` (dsp_dynamic.h:355-360)."""
    return _set_params(
        state, position_noise_std=position_std, velocity_noise_std=velocity_std
    )


def set_observation_stddev(state: MapState, sigma_ob) -> MapState:
    """``setObservationStdDev`` (dsp_dynamic.h:362-365)."""
    return _set_params(state, sigma_ob=sigma_ob)


def set_newborn_particle_weight(state: MapState, weight) -> MapState:
    """``setNewBornParticleWeight`` (dsp_dynamic.h:367-370)."""
    return _set_params(state, newborn_particle_weight=weight)


def set_detection_probability(state: MapState, p_detection) -> MapState:
    """The ctor's P_d knob (dsp_dynamic.h:157) as a live setter."""
    return _set_params(state, p_detection=p_detection)


def set_clutter_intensity(state: MapState, kappa) -> MapState:
    """The ctor's kappa knob (dsp_dynamic.h:158) as a live setter."""
    return _set_params(state, kappa=kappa)


def init_multisensor_state(cfg: MapConfig, n_sensors: int, key, sensor_pos=(0.0, 0.0, 0.0)):
    """A MapState whose estimator tracks have a leading sensor axis, for
    :func:`make_multisensor_step`."""
    from ..state import init_state

    state = init_state(cfg, key, sensor_pos)
    est = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (n_sensors,) + x.shape).copy(),
        state.estimator,
    )
    return dataclasses.replace(state, estimator=est)
