"""Initial velocity estimator: ground split, Euclidean clustering, cluster
filtering, cross-frame association and per-point velocity allocation
(``velocityEstimationThread``, ``include/dsp_dynamic.h:1377-1544``; the static
variant is a v=0 pass-through, ``include/dsp_static.h:1285-1309``).

The reference runs this on a separate CPU thread overlapped with prediction
(``dsp_dynamic.h:297,311``); here it is simply part of the jitted step graph
and XLA schedules it -- no thread, no shared mutable globals.

Pipeline parity, step by step:

1. points with world z <= voxel-filter resolution are ground/static
   (``:1387-1398``),
2. non-ground points cluster by Euclidean tolerance ``2*filter_res`` with
   size bounds [5, 10000] -- points in clusters smaller than 5 are *dropped
   entirely* (PCL returns no cluster for them, so they never reach the birth
   stage; ``:1406-1417``),
3. clusters with more than 200 points or centroid above 1.5 m are static
   (``:1436-1446``),
4. remaining (dynamic-candidate) clusters associate with the previous
   frame's via the gated distance cost matrix and an assignment solve
   (``:1449-1475``); matches get the finite-difference centroid velocity,
   zeroed if faster than 5 m/s (``:1477-1499``); unmatched keep the -10000
   sentinel,
5. every point carries its cluster's velocity; static/ground points carry
   v=0 with the non-dynamic marker (``:1503-1540``).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .config import MapConfig
from .state import EstimatorState
from .ops.cluster import euclidean_cluster
from .ops.assignment import solve_assignment
from .ops.common import compact_mask


class EstimatorOutput(NamedTuple):
    """Per-point birth input (the reference smuggles velocity in PCL normals
    and the dynamic marker in ``intensity``, dsp_dynamic.h:1510-1518; here the
    fields are explicit)."""

    points: jnp.ndarray  # [P, 3] world
    vel: jnp.ndarray  # [P, 3]; < -100 sentinel = dynamic but unmatched
    dynamic: jnp.ndarray  # [P] bool (reference: intensity > 0.01)
    valid: jnp.ndarray  # [P] bool (False = dropped by min-cluster-size)


def _passthrough(points, valid) -> EstimatorOutput:
    """Static-model estimator: every point static with v=0
    (dsp_static.h:1285-1309)."""
    return EstimatorOutput(
        points=points,
        vel=jnp.zeros_like(points),
        dynamic=jnp.zeros(points.shape[:1], bool),
        valid=valid,
    )


def estimate_velocities(
    cloud_world: jnp.ndarray,  # [P, 3] in-FOV points, world frame
    cloud_valid: jnp.ndarray,  # [P]
    est_state: EstimatorState,
    cfg: MapConfig,
    dt: jnp.ndarray,
    key: jax.Array,
):
    """Returns ``(EstimatorOutput, new EstimatorState)``."""
    if not cfg.estimator_enabled:
        return _passthrough(cloud_world, cloud_valid), est_state

    P = cloud_world.shape[0]
    C = cfg.max_clusters

    ground = cloud_world[:, 2] <= cfg.voxel_filter_resolution  # dsp_dynamic.h:1393
    nonground = cloud_valid & ~ground

    labels = euclidean_cluster(
        cloud_world, nonground, cfg.cluster_tolerance,
        cfg.cluster_propagation_iters,
    )  # [P] root index, P = invalid

    # Cluster features keyed by root point index.
    ones = nonground.astype(jnp.float32)
    size = (
        jnp.zeros((P + 1,), jnp.float32).at[labels].add(ones, mode="drop")
    )
    centroid = (
        jnp.zeros((P + 1, 3), jnp.float32)
        .at[labels]
        .add(cloud_world * ones[:, None], mode="drop")
    ) / jnp.maximum(size, 1.0)[:, None]

    my_size = size[jnp.minimum(labels, P)]
    my_centroid = centroid[jnp.minimum(labels, P)]
    big_enough = my_size >= cfg.cluster_min_points
    cluster_static = (my_size > cfg.dynamic_cluster_max_points) | (
        my_centroid[:, 2] > cfg.dynamic_cluster_max_height
    )  # dsp_dynamic.h:1436-1446
    dyn_point = nonground & big_enough & ~cluster_static
    static_point = (cloud_valid & ground) | (nonground & big_enough & cluster_static)
    dropped = nonground & ~big_enough  # PCL min-size drop

    # Compact dynamic-candidate cluster roots into C slots.
    is_dyn_root = (
        (labels == jnp.arange(P, dtype=jnp.int32))
        & nonground
        & big_enough
        & ~cluster_static
    )
    root_idx, slot_valid, n_clusters, _ = compact_mask(is_dyn_root, C)
    c_centers = centroid[root_idx] * slot_valid[:, None]
    c_sizes = jnp.where(slot_valid, size[root_idx], 0.0).astype(jnp.int32)

    # Map each point to its cluster slot.  Empty slots write out of range
    # (dropped), so the sentinel row P keeps C on every backend.
    slot_of_root = (
        jnp.full((P + 1,), C, jnp.int32)
        .at[jnp.where(slot_valid, root_idx, P + 1)]
        .set(jnp.arange(C, dtype=jnp.int32), mode="drop")
    )
    point_slot = slot_of_root[jnp.minimum(labels, P)]  # [P], C = none

    # --- association with previous frame (dsp_dynamic.h:1449-1475) ------
    prev = est_state
    dist = jnp.linalg.norm(
        c_centers[:, None, :] - prev.prev_centers[None, :, :], axis=-1
    )  # [C, C]
    gate = (
        (dist < cfg.assoc_distance_gate)
        & (
            jnp.abs(c_sizes[:, None] - prev.prev_point_num[None, :])
            <= cfg.assoc_point_num_gate
        )
    )
    cost = jnp.where(
        gate,
        dist / cfg.assoc_distance_gate * 1000.0,
        cfg.assoc_distance_gate * 5000.0,
    )
    dt_ok = (dt > 1e-5) & (dt < 10.0)  # dsp_dynamic.h:1455
    any_pairs = dt_ok & (n_clusters > 0) & jnp.any(prev.prev_valid)
    # The exact JV solve is a sequential while loop; skip it wholesale on
    # frames without clusters to match -- the common case in sparse scenes
    # (reference: the whole KM block is inside an if over non-empty cluster
    # vectors, dsp_dynamic.h:1454).
    assigned = jax.lax.cond(
        any_pairs,
        lambda: solve_assignment(cost, slot_valid, prev.prev_valid),
        lambda: jnp.full((C,), -1, jnp.int32),
    )

    matched = assigned >= 0
    safe_col = jnp.maximum(assigned, 0)
    matched = matched & gate[jnp.arange(C), safe_col]  # gate check post-solve
    c_vel = jnp.where(
        matched[:, None],
        (c_centers - prev.prev_centers[safe_col])
        / jnp.maximum(dt, 1e-6),
        -10000.0,
    )
    speed = jnp.linalg.norm(jnp.where(matched[:, None], c_vel, 0.0), axis=-1)
    c_vel = jnp.where(
        (speed > cfg.max_cluster_velocity)[:, None] & matched[:, None], 0.0, c_vel
    )  # dsp_dynamic.h:1490-1493

    key, sub = jax.random.split(key)
    fresh_intensity = jax.random.uniform(sub, (C,), jnp.float32, 0.1, 1.0)
    c_intensity = jnp.where(
        matched, prev.prev_intensity[safe_col], fresh_intensity
    )

    # --- per-point velocity allocation (dsp_dynamic.h:1503-1540) --------
    ext_vel = jnp.concatenate([c_vel, jnp.zeros((1, 3), jnp.float32)], axis=0)
    point_vel = jnp.where(
        dyn_point[:, None], ext_vel[jnp.minimum(point_slot, C)], 0.0
    )
    out = EstimatorOutput(
        points=cloud_world,
        vel=point_vel,
        dynamic=dyn_point,
        valid=static_point | dyn_point,
    )
    new_state = EstimatorState(
        prev_centers=c_centers,
        prev_point_num=c_sizes,
        prev_intensity=c_intensity,
        prev_valid=slot_valid,
    )
    return out, new_state
