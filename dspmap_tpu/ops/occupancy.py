"""Occupancy extraction, multi-horizon future prediction and per-voxel
systematic resampling (``mapOccupancyCalculationAndResample``,
``include/dsp_dynamic.h:924-1057``).

Reference semantics preserved:

* particles below the weight floor are removed first (``:941-942``),
* per-voxel weight sum counts every survivor incl. newborns (``:968-974``),
  mean velocity counts only old particles (``:944-948,976-984``),
* every old particle scatters its weight into the voxel containing
  ``p + v*tau`` for each horizon tau (``:950-964``),
* voxels with at least ``resample_min_count`` survivors are resampled to at
  most ``max_particles_per_voxel`` equal-weight particles by a systematic
  (low-variance) sweep with stride ``w_total/n`` and half-stride offset
  (``:1004-1053``); copies that find no free slot fold their weight back into
  the source so mass is conserved (``:1037-1041``),
* all surviving flags reset to plain valid (``:968``).

Formulation (see docs/DESIGN.md section 5): the in-voxel serial walk
becomes a cumsum over the slot axis; survivor/copy counts are closed-form
differences of ``ceil((cum - wa/2)/wa)``; copy placement and payload sourcing
are slots-deep select sweeps.  On the GPU the whole pool pass runs as one
Pallas kernel through Triton (``ops/pallas/occupancy.py``, element-exact vs
the XLA path and toggled by ``cfg.use_pallas_occupancy``); the future-status
scatter splits
the population: exactly-static particles (the overwhelming majority under
the reference's own zero-velocity birth policy) contribute to their own
voxel at every horizon with no scatter; moving old particles are compacted
once and scattered for all horizons in a single combined scatter-add.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..config import MapConfig
from .. import geometry
from .common import compact_mask, pool_take, select_rows
from ..state import FLAG_VALID


def _cumsum_rows(x):
    """Inclusive cumsum over the slot axis, added row by row in slot order."""
    rows = [x[0]]
    for s in range(1, x.shape[0]):
        rows.append(rows[-1] + x[s])
    return jnp.stack(rows)


def _pool_pass_xla(particles, cfg: MapConfig):
    """Cull + aggregates + resample, XLA formulation (CPU & fallback)."""
    S, V = particles.flags.shape

    # ---- weight cull (dsp_dynamic.h:941-942) ---------------------------
    flags = jnp.where(
        particles.valid & (particles.weight < cfg.weight_cull_threshold),
        jnp.int32(0),
        particles.flags,
    )
    valid = flags != 0
    newborn = flags == 3
    old = valid & ~newborn
    w = particles.weight

    # ---- per-voxel aggregates -----------------------------------------
    # Slot-order running weight sum: the resample grid below is read off
    # it, and the Pallas kernel sums in the same order, so both paths put
    # every copy at the same slot.
    wv_ = jnp.where(valid, w, 0.0)
    hi = _cumsum_rows(wv_)  # [S, V]
    lo = hi - wv_
    weight_sum = hi[-1]  # [V]
    n_old = jnp.sum(old, axis=0).astype(jnp.float32)
    vel_sums = tuple(
        jnp.sum(jnp.where(old, f, 0.0), axis=0)
        for f in (particles.vx, particles.vy, particles.vz)
    )
    moving = old & (
        (particles.vx != 0.0) | (particles.vy != 0.0) | (particles.vz != 0.0)
    )
    static_contrib = jnp.sum(jnp.where(old & ~moving, w, 0.0), axis=0)  # [V]

    # ---- systematic resampling (dsp_dynamic.h:986-1055) ----------------
    count = jnp.sum(valid, axis=0)  # [V]
    do_rs = count >= cfg.resample_min_count
    n_target = jnp.minimum(count, cfg.max_particles_per_voxel)
    wa = jnp.where(do_rs, weight_sum / jnp.maximum(n_target, 1), 1.0)  # [V]

    def n_grid(x):  # grid points wa*(k+1/2) strictly below x
        return jnp.maximum(jnp.ceil(x / wa - 0.5), 0.0).astype(jnp.int32)

    copies = jnp.where(valid & do_rs, n_grid(hi) - n_grid(lo), 0)  # [S, V]
    kept = valid & do_rs & (copies >= 1)
    dropped = valid & do_rs & (copies == 0)
    extra = jnp.maximum(copies - 1, 0)

    # Free-slot pool: dead slots plus freshly dropped ones.
    is_free = (~valid) | dropped
    free_rank = jnp.cumsum(is_free, axis=0, dtype=jnp.int32) - is_free
    total_free = jnp.sum(is_free, axis=0)  # [V]

    # Copy placement: free slot with rank r sources the particle j with
    # demand_end[j-1] <= r < demand_end[j]; computed as a slots-deep sweep.
    demand_end = jnp.cumsum(extra, axis=0)  # inclusive, [S, V]
    total_extra = demand_end[-1]  # [V]
    src_idx = jnp.zeros((S, V), jnp.int32)
    for j in range(S):
        src_idx = src_idx + (demand_end[j][None, :] <= free_rank)
    filled = is_free & (free_rank < jnp.minimum(total_extra, total_free)) & do_rs

    # Fold-back for copies that found no space (dsp_dynamic.h:1037-1041).
    demand_start = demand_end - extra
    placed = jnp.clip(total_free[None, :] - demand_start, 0, extra)
    unplaced = (extra - placed).astype(jnp.float32)

    new_w = jnp.where(kept, wa * (1.0 + unplaced), w)
    new_w = jnp.where(filled, wa, new_w)
    new_flags = jnp.where(valid, FLAG_VALID, flags)  # newborn reset (:968)
    new_flags = jnp.where(dropped, jnp.int32(0), new_flags)
    new_flags = jnp.where(filled, FLAG_VALID, new_flags)

    def place(field):
        return jnp.where(filled, select_rows(field, src_idx, S), field)

    new_particles = dataclasses.replace(
        particles,
        flags=new_flags,
        px=place(particles.px),
        py=place(particles.py),
        pz=place(particles.pz),
        vx=place(particles.vx),
        vy=place(particles.vy),
        vz=place(particles.vz),
        weight=new_w,
        t=place(particles.t) if cfg.record_particle_time else particles.t,
    )
    return new_particles, weight_sum, n_old, vel_sums, static_contrib, moving


def occupancy_and_resample(particles, cfg: MapConfig, origin: jnp.ndarray,
                           future_in, future_movers=None, shard=None):
    """Returns ``(new_particles, weight_sum[V], vel_avg[V,3], future[T,V], stats)``.

    ``future_movers`` optionally supplies the pre-compacted
    nonzero-velocity candidate set from :func:`~..fov.rebin_and_register`
    (``(flat, valid, n_dropped)``); velocities cannot change between the
    sweep and this stage on the fused-sweep configurations, so re-checking
    flags/newborn/cull here yields exactly the pool-compacted set without
    another pool-sized compaction.

    Shard_map fast path (``shard`` set): the cull/aggregate/resample pool
    pass is per-voxel and therefore shard-local; only the future-status
    scatter crosses slabs (a moving particle's predicted position can land
    anywhere), so the compacted mover columns are ``all_gather``-exchanged
    and each shard scatters the contributions whose predicted cell it owns.
    """
    # End of the flat mid-frame phase (state.flatten_pool): the pool pass
    # and its Pallas kernel work on [S, V] columns.  The future-mover
    # columns are gathered from the FLAT form -- native 1-D gathers.
    flat_form = particles if particles.flags.ndim == 1 else None
    if flat_form is not None:
        from ..state import unflatten_pool

        particles = unflatten_pool(particles, cfg.slots_per_voxel)
    S, V = particles.flags.shape
    T = cfg.n_horizons

    if cfg.use_pallas_occupancy and jax.default_backend() == "gpu":
        from .pallas.occupancy import occupancy_pool_pass

        (fields, weight_sum, n_old, vel_sums, static_contrib, moving,
         counters) = occupancy_pool_pass(
            particles, cfg, with_moving=future_movers is None
        )
        new_particles = dataclasses.replace(particles, **fields)
    else:
        new_particles, weight_sum, n_old, vel_sums, static_contrib, moving = (
            _pool_pass_xla(particles, cfg)
        )
        counters = None

    denom = jnp.maximum(n_old, 1.0)
    vel_avg = jnp.stack([s / denom for s in vel_sums], axis=-1) * (
        n_old > 0
    )[:, None]

    # ---- future-status prediction (dsp_dynamic.h:950-964) --------------
    # Horizon-major [T, V] grid (see state.MapState.future).
    future = future_in + static_contrib[None, :]

    # Mover buffers are small (<= mover_capacity = 8k), so separate gathers
    # beat a stacked row gather here: the pool-sized interleave pass cannot
    # amortize below ~16k rows (see gather_columns).
    src = flat_form if flat_form is not None else particles
    if future_movers is not None:
        fm_flat, fm_ok, fm_dropped = future_movers
        idx = jnp.minimum(fm_flat, S * V - 1)
        fl = pool_take(src.flags, idx)
        wgt = pool_take(src.weight, idx)
        sel = (
            fm_ok
            & (fl != 0)
            & (fl != 3)
            & (wgt >= cfg.weight_cull_threshold)
        )
        n_moving = jnp.sum(sel)
        n_overflow = fm_dropped
    else:
        idx, sel, n_moving, n_overflow = compact_mask(
            moving, cfg.mover_capacity
        )
        wgt = pool_take(src.weight, idx)
    m_px = pool_take(src.px, idx)
    m_py = pool_take(src.py, idx)
    m_pz = pool_take(src.pz, idx)
    m_vx = pool_take(src.vx, idx)
    m_vy = pool_take(src.vy, idx)
    m_vz = pool_take(src.vz, idx)
    m_w = jnp.where(sel, wgt, 0.0)

    if shard is not None:
        # Predicted cells can land in any slab: exchange the compacted
        # mover columns and let each shard scatter what it owns.
        (m_px, m_py, m_pz, m_vx, m_vy, m_vz, m_w, sel) = jax.tree.map(
            shard.gather_flat, (m_px, m_py, m_pz, m_vx, m_vy, m_vz, m_w, sel)
        )

    taus = jnp.asarray(cfg.prediction_horizons, jnp.float32)  # [T]
    fx = m_px[None, :] + m_vx[None, :] * taus[:, None]  # [T, D]
    fy = m_py[None, :] + m_vy[None, :] * taus[:, None]
    fz = m_pz[None, :] + m_vz[None, :] * taus[:, None]
    wx, wy, wz = geometry.world_voxel_planar(fx, fy, fz, cfg)
    ok = sel[None, :] & geometry.in_window_planar(wx, wy, wz, origin, cfg)
    cell = geometry.storage_index_planar(wx, wy, wz, cfg)  # [T, D]
    if shard is not None:
        ok = ok & shard.owns(cell, V)
        cell = cell - shard.lo
    # One flat [T*V] scatter-add: the [T, V] grid linearizes row-major so
    # ``t*V + cell`` is the native scatter index.  Duplicate (cell, horizon)
    # hits accumulate, so no unique-indices hint.
    idx = jnp.where(
        ok, cell + V * jnp.arange(T, dtype=jnp.int32)[:, None], T * V
    )  # [T, D]
    future = future.reshape(-1).at[idx.ravel()].add(
        jnp.broadcast_to(m_w[None, :], idx.shape).ravel(), mode="drop"
    ).reshape(T, V)

    if counters is not None:
        # Per-voxel counters emitted by the Pallas kernel from the masks it
        # holds in registers -- the mask-based forms below re-read the pool
        # planes.
        n_valid_v, n_culled_v, do_rs_v, n_dropped_v, n_filled_v = counters
        stats = {
            "alive": jnp.sum(
                n_valid_v - n_dropped_v + n_filled_v
            ).astype(jnp.int32),
            "culled": jnp.sum(n_culled_v).astype(jnp.int32),
            "resampled_voxels": jnp.sum(do_rs_v).astype(jnp.int32),
            "resample_dropped": jnp.sum(n_dropped_v).astype(jnp.int32),
            "resample_copies": jnp.sum(n_filled_v).astype(jnp.int32),
            "future_moving": n_moving,
            "future_overflow": n_overflow,
        }
    else:
        valid_in = particles.valid
        new_valid = new_particles.valid
        culled = jnp.sum(
            valid_in & (particles.weight < cfg.weight_cull_threshold)
        )
        survivor = valid_in & (particles.weight >= cfg.weight_cull_threshold)
        stats = {
            "alive": jnp.sum(new_valid),
            "culled": culled,
            "resampled_voxels": jnp.sum(
                jnp.sum(survivor, axis=0) >= cfg.resample_min_count
            ),
            "resample_dropped": jnp.sum(survivor & ~new_valid),
            "resample_copies": jnp.sum(~survivor & new_valid),
            "future_moving": n_moving,
            "future_overflow": n_overflow,
        }
    return new_particles, weight_sum, vel_avg, future, stats
