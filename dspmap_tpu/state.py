"""Map state as a pure JAX pytree (the translation of the reference's
file-scope static arrays, ``include/dsp_dynamic.h:112-140``).

The reference holds exactly one map per process because all storage is static
globals (``dsp_dynamic.h:116-140``); here the entire filter state is a value,
so maps are first-class: checkpointable (it is just arrays), shardable
(``parallel/``), and vmappable (multi-map / multi-sensor).

Storage layout is slots-major SoA ``[S, V]`` (S = slots per voxel, V = voxel
count): per-voxel reductions -- weight sums, velocity means, resampling
cumsums -- become reductions/scans over the small leading axis with the long
voxel axis vectorized across lanes.  The reference's AoS
``voxels_with_particle[V][S][9]`` (``dsp_dynamic.h:116``) would put the
9-float record on the lane axis instead.

Flag encoding (cf. the reference's float flags, ``dsp_dynamic.h:112,1186,
1219,1027``): the reference distinguishes {0 invalid, 1 valid, 0.6
resample-copy, 7 just-moved, 15 newborn}, but 0.6 and 7 only exist to guard
its in-place sequential scans against double-processing; a functional update
has no such hazard.  What remains observable is {dead, valid, newborn}:
newborns are excluded from velocity averaging, future prediction
(``dsp_dynamic.h:944``) and birth-time Dempster-Shafer classification
(``dsp_dynamic.h:830``), and everything is reset to plain valid during
occupancy/resample (``dsp_dynamic.h:968``).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from .config import MapConfig

# int32 rather than uint8: every pool plane is one word per slot, so the
# flag plane takes the same scatter and gather paths as the f32 planes.
FLAG_DTYPE = jnp.int32
FLAG_DEAD = jnp.int32(0)
FLAG_VALID = jnp.int32(1)
FLAG_NEWBORN = jnp.int32(3)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["flags", "px", "py", "pz", "vx", "vy", "vz", "weight", "t"],
    meta_fields=[],
)
@dataclasses.dataclass
class Particles:
    """SoA particle pool, all fields ``[S, V]``.

    Mirrors the per-slot record {flag, vx, vy, vz, px, py, pz, weight,
    update_time} of ``dsp_dynamic.h:114-116``; positions/velocities are world
    frame (see geometry module docstring for the world-vs-ego deviation).
    """

    flags: jnp.ndarray  # int32 [S, V] (see FLAG_DTYPE note above)
    px: jnp.ndarray  # f32 [S, V]
    py: jnp.ndarray
    pz: jnp.ndarray
    vx: jnp.ndarray
    vy: jnp.ndarray
    vz: jnp.ndarray
    weight: jnp.ndarray
    t: jnp.ndarray  # last-update timestamp (CSV/analysis parity)

    @property
    def valid(self) -> jnp.ndarray:
        return self.flags != FLAG_DEAD

    @property
    def newborn(self) -> jnp.ndarray:
        return self.flags == FLAG_NEWBORN

    def pos(self) -> jnp.ndarray:
        """Stacked positions ``[S, V, 3]`` (materialize only when needed)."""
        return jnp.stack([self.px, self.py, self.pz], axis=-1)

    def vel(self) -> jnp.ndarray:
        return jnp.stack([self.vx, self.vy, self.vz], axis=-1)


def flatten_pool(p: Particles, skip: tuple = ()) -> Particles:
    """Ravel every pool plane to its flat ``[S*V]`` form.

    Mid-frame representation for the scatter-heavy stages (mover insertion
    -> measurement writeback -> birth insertion): XLA linearizes every pool
    scatter into a flat scatter regardless of the operand's logical shape,
    so the planes stay flat between the first scatter and the occupancy
    stage, where every scatter and every flat-index gather is native.  A
    row-major ``[S, V] -> [S*V]`` reshape is a bitcast on the GPU.

    ``skip`` names planes left in their 2-D form -- used for planes that
    are never touched during the flat phase (the write-only ``t`` plane
    when ``record_particle_time`` is off).
    Only planes genuinely untouched mid-frame may be skipped: a skipped
    plane stays 2-D, and the 1-D-assuming flat-phase call sites would
    mis-handle it far from the cause -- hence the guard below.  ``flags``
    can never be skipped (``unflatten_pool`` and ``pool_sv`` key off it)."""
    field_names = {f.name for f in dataclasses.fields(p)}
    if not (isinstance(skip, (tuple, frozenset, set))
            and set(skip) <= field_names - {"flags"}):
        raise ValueError(
            f"flatten_pool skip must be a tuple/set of pool field names "
            f"excluding 'flags'; got {skip!r}"
        )
    return dataclasses.replace(
        p, **{f.name: getattr(p, f.name).reshape(-1)
              for f in dataclasses.fields(p) if f.name not in skip}
    )


def unflatten_pool(p: Particles, slots: int) -> Particles:
    """Restore ``[S, V]`` planes from the flat mid-frame form (no-op on
    planes already 2-D, e.g. those skipped by :func:`flatten_pool`)."""
    if p.flags.ndim == 2:
        return p
    return dataclasses.replace(
        p, **{f.name: getattr(p, f.name).reshape(slots, -1)
              for f in dataclasses.fields(p)
              if getattr(p, f.name).ndim == 1}
    )


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "sigma_ob",
        "position_noise_std",
        "velocity_noise_std",
        "p_detection",
        "kappa",
        "newborn_particle_weight",
    ],
    meta_fields=[],
)
@dataclasses.dataclass
class RuntimeParams:
    """The reference's live setter surface (``dsp_dynamic.h:355-382``) as
    traced scalars riding in :class:`MapState`.

    These knobs are shape-free (they scale math, never sizes), so carrying
    them as f32 scalars lets callers flip them between frames through the
    pure setters in :mod:`dspmap_tpu.models.pipeline`
    (``set_prediction_variance`` / ``set_observation_stddev`` / ...) without
    re-jitting -- the reference regenerates its 2x10M-draw RNG pools on
    ``setPredictionVariance`` (``dsp_dynamic.h:1150-1160``); keyed
    ``jax.random`` makes the new sigma effective immediately at zero cost.
    Shape-affecting knobs (map dims, capacities, newborn count) remain
    static on :class:`~dspmap_tpu.config.MapConfig`.
    """

    sigma_ob: jnp.ndarray  # f32 scalar (setObservationStdDev, :362-365)
    position_noise_std: jnp.ndarray  # f32 scalar (setPredictionVariance, :355-360)
    velocity_noise_std: jnp.ndarray  # f32 scalar
    p_detection: jnp.ndarray  # f32 scalar (ctor param, :157)
    kappa: jnp.ndarray  # f32 scalar (ctor param, :158)
    newborn_particle_weight: jnp.ndarray  # f32 scalar (setNewBornParticleWeight, :367-370)

    @staticmethod
    def from_config(cfg: MapConfig) -> "RuntimeParams":
        import numpy as np

        return RuntimeParams(
            sigma_ob=np.float32(cfg.sigma_ob),
            position_noise_std=np.float32(cfg.position_noise_std),
            velocity_noise_std=np.float32(cfg.velocity_noise_std),
            p_detection=np.float32(cfg.p_detection),
            kappa=np.float32(cfg.kappa),
            newborn_particle_weight=np.float32(cfg.newborn_particle_weight),
        )


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["prev_centers", "prev_point_num", "prev_intensity", "prev_valid"],
    meta_fields=[],
)
@dataclasses.dataclass
class EstimatorState:
    """Previous-frame dynamic-cluster features for cross-frame association
    (the reference keeps these in a function-local static,
    ``dsp_dynamic.h:1401,1542``)."""

    prev_centers: jnp.ndarray  # f32 [C, 3]
    prev_point_num: jnp.ndarray  # i32 [C]
    prev_intensity: jnp.ndarray  # f32 [C] (visualization id carried across matches)
    prev_valid: jnp.ndarray  # bool [C]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "particles",
        "weight_sum",
        "vel_avg",
        "future",
        "rng",
        "sensor_pos",
        "last_sensor_pos",
        "origin",
        "update_time",
        "last_timestamp",
        "update_counter",
        "initialized",
        "estimator",
        "params",
    ],
    meta_fields=[],
)
@dataclasses.dataclass
class MapState:
    """Complete filter state threaded through :func:`dspmap_tpu.models.step`."""

    particles: Particles
    #: per-voxel weight sum (voxels_objects_number[:,0], dsp_dynamic.h:118-120)
    weight_sum: jnp.ndarray  # f32 [V]
    #: per-voxel mean velocity of old particles (voxels_objects_number[:,1:4])
    vel_avg: jnp.ndarray  # f32 [V, 3]
    #: future-status accumulators (voxels_objects_number[:,4:]); cleared by
    #: the occupancy readout exactly like the reference (dsp_dynamic.h:420-424).
    #: Horizon-major [T, V]: the per-frame mover scatter then linearizes to a
    #: native flat [T*V] scatter with no relayout of the grid.  Readouts
    #: transpose to the public [n, T] order.
    future: jnp.ndarray  # f32 [T, V]
    rng: jax.Array
    sensor_pos: jnp.ndarray  # f32 [3] (current_position, dsp_dynamic.h:131)
    last_sensor_pos: jnp.ndarray  # f32 [3]
    origin: jnp.ndarray  # i32 [3] map-window origin in world-voxel coords
    update_time: jnp.ndarray  # f32 scalar, cumulative map time
    last_timestamp: jnp.ndarray  # f64/f32 scalar
    update_counter: jnp.ndarray  # i32 scalar
    initialized: jnp.ndarray  # bool scalar (first-frame delta handling)
    estimator: EstimatorState
    #: live-settable filter scalars (see :class:`RuntimeParams`)
    params: RuntimeParams


def init_estimator_state(cfg: MapConfig) -> EstimatorState:
    import numpy as np

    c = cfg.max_clusters
    return EstimatorState(
        prev_centers=np.zeros((c, 3), np.float32),
        prev_point_num=np.zeros((c,), np.int32),
        prev_intensity=np.zeros((c,), np.float32),
        prev_valid=np.zeros((c,), bool),
    )


def init_state(
    cfg: MapConfig,
    key: jax.Array,
    sensor_pos=(0.0, 0.0, 0.0),
    init_particle_num: int = 0,
    init_weight: float = 0.01,
) -> MapState:
    """Fresh map centered at ``sensor_pos``.

    Optionally scatters ``init_particle_num`` uniform particles with velocity
    components in [-1, 1] (addRandomParticles, dsp_dynamic.h:594-624); the
    reference default constructor adds zero (dsp_dynamic.h:145,172).
    """
    import numpy as np

    s, v = cfg.slots_per_voxel, cfg.storage_voxels
    # Build on host with numpy (a fresh state is all zeros) and transfer in
    # one piece instead of dispatching one eager op per plane.
    sensor_np = np.asarray(sensor_pos, np.float32)
    half = np.asarray(cfg.half_extent, np.float32)
    origin_np = np.floor(
        (sensor_np - half) / cfg.voxel_resolution + 0.5
    ).astype(np.int32)
    # Compact layout (cfg.layout == "compact", ops/compact.py): the live
    # population rides one [P] SoA array instead of the [S, V] slot pool.
    shape = (cfg.compact_capacity,) if cfg.layout == "compact" else (s, v)
    zeros = lambda: np.zeros(shape, np.float32)
    particles = Particles(
        flags=np.zeros(shape, np.int32),
        px=zeros(), py=zeros(), pz=zeros(),
        vx=zeros(), vy=zeros(), vz=zeros(),
        weight=zeros(), t=zeros(),
    )
    state = MapState(
        particles=particles,
        weight_sum=np.zeros((v,), np.float32),
        vel_avg=np.zeros((v, 3), np.float32),
        future=np.zeros((cfg.n_horizons, v), np.float32),
        rng=key,
        sensor_pos=sensor_np,
        last_sensor_pos=sensor_np,
        origin=origin_np,
        update_time=np.float32(0.0),
        last_timestamp=np.float32(0.0),
        update_counter=np.int32(0),
        initialized=np.asarray(False),
        estimator=init_estimator_state(cfg),
        params=RuntimeParams.from_config(cfg),
    )
    state = jax.device_put(state)
    if init_particle_num > 0:
        state = add_random_particles(state, cfg, init_particle_num, init_weight)
    return state


def add_random_particles(
    state: MapState, cfg: MapConfig, num: int, avg_weight: float
) -> MapState:
    """Uniformly scatter ``num`` particles over the window (dsp_dynamic.h:594-624).

    The reference draws uniform positions and linear-probes each particle into
    its voxel, dropping on overflow; here we draw one candidate per (slot,
    voxel) cell directly and keep a random subset of exactly the same expected
    density -- an equivalent uniform scatter without the serial probe.
    """
    from .ops.insert import insert_particles  # local import to avoid cycle

    key, k1, k2, k3 = jax.random.split(state.rng, 4)
    half = jnp.asarray(cfg.half_extent, jnp.float32)
    pos = state.sensor_pos + jax.random.uniform(
        k1, (num, 3), jnp.float32, -1.0, 1.0
    ) * half
    vel = jax.random.uniform(k2, (num, 3), jnp.float32, -1.0, 1.0)
    # The reference clamps velocities inside every prediction pass BEFORE
    # they advance positions (vz=0 under LIMIT_MOVEMENT_IN_XY_PLANE,
    # dsp_dynamic.h:661-663; v=0 entirely in the static model,
    # dsp_static.h:640-646).  One exception exists for random-init pools:
    # the keep-still noise gate |vx*vy*vz| >= 1e-6 (dsp_dynamic.h:653) runs
    # BEFORE the vz clamp, so a random-init particle's nonzero vz triggers
    # one vx/vy noise draw at its first prediction there -- our statically
    # elided noise (see the documented noise-elision deviation in
    # ops/propagate.py) skips that single first-frame draw.  Beyond that
    # one draw the init velocity is unobservable, so clamping here -- at
    # the only write site that can produce a non-conforming velocity --
    # lets the pipeline maintain "velocities conform" as a write-site
    # invariant instead of re-clamping the whole pool every frame (a full
    # plane pass).
    if cfg.motion_model == "static":
        vel = jnp.zeros_like(vel)
    elif cfg.limit_motion_to_xy_plane:
        vel = vel.at[:, 2].set(0.0)
    weight = jnp.full((num,), avg_weight, jnp.float32)
    if cfg.layout == "compact":
        from . import geometry
        from .ops.compact import _scatter_add_cols, insert_compact

        wx, wy, wz = geometry.world_voxel_planar(
            state.particles.px, state.particles.py, state.particles.pz, cfg
        )
        cell = geometry.storage_index_planar(wx, wy, wz, cfg)
        alive = state.particles.flags != 0
        (count_v,) = _scatter_add_cols(cell, alive, (alive,),
                                       cfg.storage_voxels)
        particles, _, _ = insert_compact(
            state.particles, cfg,
            pos=pos, vel=vel, weight=weight,
            valid=jnp.ones((num,), bool),
            origin=state.origin,
            flag=FLAG_VALID,
            t=state.update_time if cfg.record_particle_time else None,
            count_v=count_v,
        )
    else:
        particles = insert_particles(
            state.particles,
            cfg,
            pos=pos,
            vel=vel,
            weight=weight,
            valid=jnp.ones((num,), bool),
            origin=state.origin,
            flag=FLAG_VALID,
            t=state.update_time,
        )
    return dataclasses.replace(state, particles=particles, rng=key)
