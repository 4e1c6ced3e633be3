"""Alive-proportional particle core: the whole per-frame cycle as O(alive)
work over one compact ``[P]`` SoA array (``cfg.layout == "compact"``).

The reference walks its full ``[V][S]`` slot pool once per stage
(``mapPrediction`` ``include/dsp_dynamic.h:627-701``, ``moveParticle``
``:1206-1279``, ``mapOccupancyCalculationAndResample`` ``:924-1057``); the
pool-layout translation (``ops/sweep.py`` / ``ops/fov.py`` /
``ops/occupancy.py``) streams the same 3.1M-slot planes.  But the
realized live population is ~21k particles, so >99% of every pool pass's
bytes are dead slots.  This module keeps the live set in a dense
``[P = cfg.compact_capacity]`` array (``state.Particles`` with 1-D planes)
and reproduces the identical per-voxel semantics with sorts, segment scans
and scatter-adds whose cost scales with the population:

* a particle's **storage cell** is derived from its world position
  (``geometry.storage_index_planar`` is toroidal and origin-free), so ego
  motion and self-motion never relocate rows -- relocation is just the cell
  value changing;
* **per-voxel slot capacity** (``S = cfg.slots_per_voxel``; drop-on-full,
  ``dsp_dynamic.h:1198-1200,1227-1229``) is enforced by within-voxel arrival
  ranks: stayers keep their claim, movers/newborns rank behind the current
  occupancy and die when it is exhausted -- the same survival semantics
  with the documented vacate-then-fill tie-breaking deviation of
  ``ops/rebin.py``;
* **pyramid capacity** (``dsp_dynamic.h:1256-1259``) is the same rank kill
  the pool layout applies, over the compacted in-FOV set;
* **occupancy/future/resample** (``dsp_dynamic.h:924-1057``) run over the
  population sorted by cell: per-voxel aggregates are one multi-column
  scatter-add, the in-voxel systematic-resampling walk is the closed-form
  cumulative-weight bucketing of ``ops/occupancy.py`` evaluated on segment
  scans, and the output is written as a fresh *defragmented* (cell-sorted)
  array -- there is no pool write-back at all.

Global row capacity ``P`` is a fixed-shape budget (like ``mover_capacity``):
when the frame's survivors + copies + newborns exceed it, the surplus is
dropped and counted (``pool_overflow`` / resample-copy clipping).  Per-voxel
capacity semantics are exact.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import MapConfig
from .. import geometry
from ..state import FLAG_NEWBORN, FLAG_VALID
from .common import (I32_MAX, compact_and_group, compact_mask, group_ranks,
                     sort_by_destination)


class CompactSweep(NamedTuple):
    """Per-row outcome of the fused advance/geometry pass."""

    cell: jnp.ndarray  # i32 [P] storage cell of the advanced position
    mover: jnp.ndarray  # bool [P]: cell changed this frame
    fov: jnp.ndarray  # bool [P]: alive & inside & in FOV
    moving: jnp.ndarray  # bool [P]: alive & nonzero velocity
    pyr: jnp.ndarray  # i32 [P] pyramid cell (garbage where ~fov)
    moved_out: jnp.ndarray  # bool [P]: left the window (killed)


def _scatter_add_cols(cell, valid, cols, n_cells):
    """One multi-column scatter-add ``[P] -> [n_cells, C]`` (XLA scatter cost
    is per index row, so C columns ride one pass; cf. ops/fov.py's stacked
    binning scatter)."""
    upd = jnp.stack([c.astype(jnp.float32) for c in cols], axis=-1)  # [P, C]
    idx = jnp.where(valid, cell, n_cells)
    out = (
        jnp.zeros((n_cells + 1, len(cols)), jnp.float32)
        .at[idx]
        .add(upd, mode="drop")[:n_cells]
    )
    return [out[:, i] for i in range(len(cols))]


def _reach(max_run: int) -> int:
    r = 1
    while r < max_run:
        r *= 2
    return r


def _seg_cumsum(x, is_start, max_run: int):
    """Inclusive within-run prefix sums (segmented Hillis-Steele scan):
    ``is_start`` marks run boundaries; sums reset at each boundary.

    Run-LOCAL float precision (each run's sums never touch other runs'
    mass -- a global cumsum + difference at run ends carries a relative
    error amplified by total/run mass, measured 3e-4 on the street scene,
    which systematically flips resample grid boundaries).  Only
    ``ceil(log2(max_run))`` shifted-add steps are needed because no run of
    *live* rows can exceed ``max_run`` (the per-voxel slot capacity S,
    strictly enforced at every insert/rebin site); longer runs exist only
    over dead rows, whose values are masked zeros -- a truncated sum of
    zeros is still zero.  ~6 steps vs log2(P)=16 levels of a general
    ``associative_scan``."""
    two_d = x.ndim == 2
    s = x
    b = is_start[:, None] if two_d else is_start
    b = jnp.broadcast_to(b, x.shape) if two_d else b
    d = 1
    R = _reach(max_run)
    while d < R:
        pad = [(d, 0)] + [(0, 0)] * (x.ndim - 1)
        ps = jnp.pad(s, pad)[:-d or None][: s.shape[0]]
        pb = jnp.pad(b, pad, constant_values=True)[: s.shape[0]]
        s = jnp.where(b, s, s + ps)
        b = b | pb
        d *= 2
    return s


def _fill_from_end(v, is_end, max_run: int):
    """Broadcast each run's END value backward to every row of the run
    (reverse hold-last-marked segmented scan, same short-run bound as
    :func:`_seg_cumsum`)."""
    two_d = v.ndim == 2
    s = v
    taken = is_end[:, None] if two_d else is_end
    taken = jnp.broadcast_to(taken, v.shape) if two_d else taken
    d = 1
    R = _reach(max_run)
    while d < R:
        pad = [(0, d)] + [(0, 0)] * (v.ndim - 1)
        ns = jnp.pad(s, pad)[d:]
        nt = jnp.pad(taken, pad)[d:]
        s = jnp.where(taken, s, ns)
        taken = taken | nt
        d *= 2
    return s


def seg_scans(cols, is_start, is_end, max_run: int, n_tot: int):
    """(hi per column, tot for the first ``n_tot`` columns): the segmented
    run-local cumsum of every column, and each run's total broadcast back
    over the run."""
    X = jnp.stack([c.astype(jnp.float32) for c in cols], axis=-1)
    hi = _seg_cumsum(X, is_start, max_run)
    his = [hi[:, i] for i in range(len(cols))]
    if n_tot == 0:
        return his, []
    tot = _fill_from_end(hi[:, :n_tot], is_end, max_run)
    return his, [tot[:, i] for i in range(n_tot)]


def segment_table(cell, valid, cols, n_cells, bucket: int = 16384,
                  max_run: int = 64):
    """Per-cell sums of ``cols`` into a ``[n_cells, C]`` table, exploiting the
    compact array's near-sortedness.

    A direct multi-column scatter-add pays per index row over the whole
    array; but the array is cell-sorted after every occupancy pass
    (the sort IS the defrag), and mid-frame disorder is only movers plus the
    newborn tail.  Maximal equal-key runs therefore number about the
    occupied-voxel count, and each run's partial sum is a difference of
    cumulative sums taken at its end row.  Pipeline: cumsums over the
    columns (cheap scans), run ends compacted to ``bucket`` rows, two
    bucket-sized row gathers of the stacked cum matrix, one bucket-sized
    scatter-ADD.  Exact for ARBITRARY key order (disorder only fragments
    runs, and partials of the same cell accumulate); sign-agnostic (no
    cummax fill on the data path).  A ``lax.switch`` widens the bucket
    (up to a full-width direct scatter-add) when runs overflow, so the
    result is exact in every regime.
    """
    P = cell.shape[0]
    C = len(cols)
    key = jnp.where(valid, cell, n_cells)
    nxt = jnp.concatenate([key[1:] != key[:-1], jnp.ones((1,), bool)])
    prv = jnp.concatenate([jnp.ones((1,), bool), key[1:] != key[:-1]])
    is_end = nxt & (key < n_cells)
    # SEGMENTED cumsum (run-local sums): a plain global cumsum + difference
    # at run ends loses precision catastrophically -- the difference of two
    # O(total-mass) values carries a relative error amplified by
    # total/run-mass (measured 3e-4 on the street scene), which flips
    # resample boundaries downstream.
    his, _ = seg_scans(
        [jnp.where(valid, c, 0) for c in cols], prv, nxt, max_run, 0
    )
    cums = jnp.stack(his, axis=-1)  # [P, C]
    n_ends = jnp.sum(is_end)

    def bucketed(bud):
        def run(_):
            e_i, e_ok, _, _ = compact_mask(is_end, bud)
            tbl = (
                jnp.zeros((n_cells + 1, C), jnp.float32)
                .at[jnp.where(e_ok, key[e_i], n_cells)]
                .add(cums[e_i], mode="drop")[:n_cells]
            )
            return tbl
        return run

    def direct(_):
        upd = jnp.stack(
            [jnp.where(valid, c, 0).astype(jnp.float32) for c in cols],
            axis=-1,
        )
        return (
            jnp.zeros((n_cells + 1, C), jnp.float32)
            .at[key]
            .add(upd, mode="drop")[:n_cells]
        )

    sizes = [bucket]
    while sizes[-1] * 2 < P:
        sizes.append(sizes[-1] * 2)
    case = jnp.searchsorted(jnp.asarray(sizes, jnp.int32), n_ends)
    tbl = jax.lax.switch(
        case, [bucketed(b) for b in sizes] + [direct], 0
    )
    return [tbl[:, i] for i in range(C)]


def _ends_table(cums, key, is_end, n_cells, X_direct, bucket: int = 16384):
    """Scatter per-run totals (``cums`` = segmented cumsums, read at run
    ends) into a ``[n_cells, C]`` table -- the tail half of
    :func:`segment_table` for callers that already hold the segmented
    cumsums.  ``X_direct`` supplies the raw per-row columns for the exact
    full-width fallback when run ends overflow the bucket ladder."""
    P = key.shape[0]
    C = cums.shape[1]
    n_ends = jnp.sum(is_end)

    def bucketed(bud):
        def run(_):
            e_i, e_ok, _, _ = compact_mask(is_end, bud)
            return (
                jnp.zeros((n_cells + 1, C), jnp.float32)
                .at[jnp.where(e_ok, key[e_i], n_cells)]
                .add(cums[e_i], mode="drop")[:n_cells]
            )
        return run

    def direct(_):
        return (
            jnp.zeros((n_cells + 1, C), jnp.float32)
            .at[key]
            .add(X_direct, mode="drop")[:n_cells]
        )

    sizes = [bucket]
    while sizes[-1] * 2 < P:
        sizes.append(sizes[-1] * 2)
    case = jnp.searchsorted(jnp.asarray(sizes, jnp.int32), n_ends)
    tbl = jax.lax.switch(case, [bucketed(b) for b in sizes] + [direct], 0)
    return [tbl[:, i] for i in range(C)]


def sweep_compact(particles, cfg: MapConfig, dt, origin, sensor_pos, quat,
                  key, rt=None):
    """Prediction advance + window test + cell/pyramid geometry, one [P] pass
    (``mapPrediction`` motion+bounds, ``dsp_dynamic.h:653-690``; pyramid
    membership of ``moveParticle``, ``:1232-1243``).

    Returns ``(new_particles, CompactSweep)``.  Velocity noise follows
    ops/propagate.py exactly, including the reference's keep-still quirk
    (``dsp_dynamic.h:653-659``) and its static elision under
    ``limit_motion_to_xy_plane``."""
    valid = particles.valid
    vx, vy, vz = particles.vx, particles.vy, particles.vz

    if cfg.motion_model == "static":
        px, py, pz = particles.px, particles.py, particles.pz
    else:
        if not cfg.limit_motion_to_xy_plane:
            sigma_v = (cfg.velocity_noise_std if rt is None
                       else rt.velocity_noise_std)
            noise = jax.random.normal(key, (3,) + vx.shape, jnp.float32) * sigma_v
            keep_still = jnp.abs(vx * vy * vz) < 1e-6  # dsp_dynamic.h:653
            jitter = valid & ~keep_still
            vx = jnp.where(jitter, vx + noise[0], vx)
            vy = jnp.where(jitter, vy + noise[1], vy)
            vz = jnp.where(jitter, vz + noise[2], vz)
        px = jnp.where(valid, particles.px + vx * dt, particles.px)
        py = jnp.where(valid, particles.py + vy * dt, particles.py)
        pz = jnp.where(valid, particles.pz + vz * dt, particles.pz)

    wx, wy, wz = geometry.world_voxel_planar(px, py, pz, cfg)
    inside = geometry.in_window_planar(wx, wy, wz, origin, cfg)
    moved_out = valid & ~inside  # dsp_dynamic.h:686-690
    alive = valid & inside
    flags = jnp.where(moved_out, jnp.int32(0), particles.flags)

    new_cell = geometry.storage_index_planar(wx, wy, wz, cfg)
    owx, owy, owz = geometry.world_voxel_planar(
        particles.px, particles.py, particles.pz, cfg
    )
    cur_cell = geometry.storage_index_planar(owx, owy, owz, cfg)
    mover = alive & (new_cell != cur_cell)

    Rm = geometry.rotation_matrix(geometry.quaternion_conjugate(quat))
    sx, sy, sz = geometry.rotate_planar(
        Rm, px - sensor_pos[0], py - sensor_pos[1], pz - sensor_pos[2]
    )
    pyr, in_fov = geometry.pyramid_index_planar(sx, sy, sz, cfg)
    fov = alive & in_fov
    moving = alive & ((vx != 0.0) | (vy != 0.0) | (vz != 0.0))

    new_particles = dataclasses.replace(
        particles, px=px, py=py, pz=pz, vx=vx, vy=vy, vz=vz, flags=flags
    )
    sw = CompactSweep(
        cell=jnp.where(alive, new_cell, cfg.storage_voxels),
        mover=mover, fov=fov, moving=moving, pyr=pyr, moved_out=moved_out,
    )
    return new_particles, sw


def rebin_compact(particles, sw: CompactSweep, cfg: MapConfig):
    """Voxel-capacity enforcement for relocated particles (the voxel half of
    ``moveParticle``, ``dsp_dynamic.h:1206-1230``): movers rank behind their
    destination voxel's stayers and die at rank >= S (drop-on-full,
    ``:1227-1229``).  Stayers never die here (they already hold a slot).

    Returns ``(new_particles, stay_count[Vs], stats)``; ``stay_count`` is
    per-voxel stayer occupancy, reused by callers.  Movers beyond
    ``cfg.mover_capacity`` are killed (the pool layout's budget semantics,
    ops/rebin.py; identified by an elementwise mover-rank cumsum, so the
    per-voxel <= S occupancy invariant is STRICT -- the short-run segmented
    scans rely on it)."""
    S = cfg.slots_per_voxel
    Vs = cfg.storage_voxels
    m_cap = cfg.mover_capacity
    alive = particles.flags != 0

    stayer = alive & ~sw.mover & (sw.cell < Vs)
    (stay_count,) = segment_table(sw.cell, stayer, (stayer,), Vs, max_run=S)

    mover = sw.mover & alive
    # buffer-overflow movers killed outright (drop-on-full accounting);
    # rank via plain cumsum keeps this elementwise
    m_rank = jnp.cumsum(mover.astype(jnp.int32)) - 1
    over_kill = mover & (m_rank >= m_cap)
    mover_in = mover & ~over_kill

    m_i, m_ok, n_mov, _ = compact_mask(mover_in, m_cap)
    m_cell = jnp.where(m_ok, sw.cell[m_i], Vs)
    order, sorted_cell, ranks = sort_by_destination(m_cell, m_ok)
    cell_safe = jnp.minimum(sorted_cell, Vs - 1)
    kill_sorted = (sorted_cell < Vs) & (
        stay_count[cell_safe].astype(jnp.int32) + ranks >= S
    )
    kill_rows = jnp.where(kill_sorted, m_i[order], particles.flags.shape[0])
    flags = jnp.where(over_kill, jnp.int32(0), particles.flags)
    flags = flags.at[kill_rows].set(jnp.int32(0), mode="drop")

    n_killed = jnp.sum(kill_sorted)
    stats = {
        "moved_out": jnp.sum(sw.moved_out),
        "movers": jnp.minimum(n_mov, m_cap),
        "mover_overflow_killed": jnp.sum(over_kill),
        "voxel_full_killed": n_killed,
    }
    return dataclasses.replace(particles, flags=flags), stay_count, stats


def rebin_exchange_compact(particles, sw: CompactSweep, cfg: MapConfig,
                           shard):
    """Sharded relocation for the compact layout: within-slab movers are
    capacity-checked in place (:func:`rebin_compact` semantics); cross-slab
    movers vacate their local row, ride an ``all_gather`` (or
    ``ppermute`` ring) of the compacted mover payload, and the owning shard
    lands them in free rows behind its stayers' and within-movers' claims --
    the bounded cross-slab traffic SURVEY.md section 7.1.7 names.  Arrival
    order is shard-major behind local movers (documented deviation, same
    class as the pool path's).  Returns ``(new_particles, stats)``."""
    P = particles.flags.shape[0]
    S = cfg.slots_per_voxel
    v_local = cfg.storage_voxels // shard.n_shards
    m_cap = cfg.mover_capacity
    alive = particles.flags != 0
    own = shard.owns(sw.cell, v_local)

    mover = sw.mover & alive
    within = mover & own
    cross = mover & ~own & (sw.cell < cfg.storage_voxels)

    stayer = alive & ~sw.mover
    (stay_count,) = segment_table(
        sw.cell - shard.lo, stayer, (stayer,), v_local, max_run=S
    )

    # within-slab capacity check (strict, as in rebin_compact)
    w_rank = jnp.cumsum(within.astype(jnp.int32)) - 1
    w_overkill = within & (w_rank >= m_cap)
    within = within & ~w_overkill
    w_i, w_ok, n_w, _ = compact_mask(within, m_cap)
    w_cell = jnp.where(w_ok, sw.cell[w_i] - shard.lo, v_local)
    order_w, sc_w, ranks_w = sort_by_destination(w_cell, w_ok)
    kill_w = (sc_w < v_local) & (
        stay_count[jnp.minimum(sc_w, v_local - 1)].astype(jnp.int32)
        + ranks_w >= S
    )
    kill_rows = jnp.where(kill_w, w_i[order_w], P)

    # cross-slab movers: vacate + exchange payload
    c_rank = jnp.cumsum(cross.astype(jnp.int32)) - 1
    c_overkill = cross & (c_rank >= m_cap)
    cross = cross & ~c_overkill
    c_i, c_ok, n_c, _ = compact_mask(cross, m_cap)
    exp = (
        jnp.where(c_ok, sw.cell[c_i], cfg.storage_voxels),
        particles.px[c_i], particles.py[c_i], particles.pz[c_i],
        particles.vx[c_i], particles.vy[c_i], particles.vz[c_i],
        jnp.where(c_ok, particles.weight[c_i], 0.0),
        c_ok,
    )
    flags = jnp.where(cross | c_overkill | w_overkill, jnp.int32(0),
                      particles.flags)
    flags = flags.at[kill_rows].set(jnp.int32(0), mode="drop")

    if cfg.mover_exchange == "ring":
        reach = shard.ring_reachable(
            jnp.maximum(exp[0], 0), v_local, cfg.ring_hops
        )
        ring_undelivered = jnp.sum(exp[-1] & ~reach)
        ex = lambda x: shard.gather_ring(x, cfg.ring_hops)  # noqa: E731
    else:
        ring_undelivered = jnp.int32(0)
        ex = shard.gather_flat
    (a_cell, a_px, a_py, a_pz, a_vx, a_vy, a_vz, a_w, a_ok) = jax.tree.map(
        ex, exp
    )
    own_arr = a_ok & shard.owns(a_cell, v_local)

    # land arrivals behind stayers + surviving within-movers: count the
    # within-survivors per voxel with a small scatter-add
    w_keep_sorted = (sc_w < v_local) & ~kill_w
    count_after = (
        stay_count.astype(jnp.int32)
        .at[jnp.where(w_keep_sorted, sc_w, v_local)]
        .add(1, mode="drop")
    )

    o_i, o_ok, n_own, o_over = compact_mask(own_arr, m_cap)
    cell_l = jnp.where(o_ok, a_cell[o_i] - shard.lo, v_local)
    order_a, sc_a, r_a = sort_by_destination(cell_l, o_ok)
    eligible = (sc_a < v_local) & (
        r_a < jnp.maximum(
            S - count_after[jnp.minimum(sc_a, v_local - 1)], 0
        )
    )
    free_rows, _, n_free, _ = compact_mask(flags == 0, m_cap)
    elig_rank = jnp.cumsum(eligible.astype(jnp.int32)) - 1
    land = eligible & (elig_rank < n_free)
    row = jnp.where(land, free_rows[jnp.clip(elig_rank, 0, m_cap - 1)], P)
    src = o_i[order_a]

    def put(plane, vals):
        return plane.at[row].set(vals, mode="drop", unique_indices=True)

    flags = put(flags, jnp.where(land, FLAG_VALID, 0))
    new_particles = dataclasses.replace(
        particles,
        flags=flags,
        px=put(particles.px, a_px[src]),
        py=put(particles.py, a_py[src]),
        pz=put(particles.pz, a_pz[src]),
        vx=put(particles.vx, a_vx[src]),
        vy=put(particles.vy, a_vy[src]),
        vz=put(particles.vz, a_vz[src]),
        weight=put(particles.weight, a_w[src]),
    )
    n_landed = jnp.sum(land)
    stats = {
        "moved_out": jnp.sum(sw.moved_out),
        "movers": n_w + n_c,
        "mover_overflow_killed": jnp.sum(w_overkill) + jnp.sum(c_overkill)
        + o_over + ring_undelivered,
        "voxel_full_killed": jnp.sum(kill_w) + (n_own - n_landed),
    }
    return new_particles, stats


def fov_geometry_compact(particles, cfg: MapConfig, sensor_pos, quat):
    """(pyramid cell [P], in-FOV mask [P]) of the compact set for one sensor
    pose -- the per-sensor half of :func:`sweep_compact`'s geometry, for
    multi-sensor steps that register against several poses per frame."""
    Rm = geometry.rotation_matrix(geometry.quaternion_conjugate(quat))
    sx, sy, sz = geometry.rotate_planar(
        Rm,
        particles.px - sensor_pos[0],
        particles.py - sensor_pos[1],
        particles.pz - sensor_pos[2],
    )
    pyr, in_fov = geometry.pyramid_index_planar(sx, sy, sz, cfg)
    return pyr, particles.valid & in_fov


def register_fov_compact(particles, cfg: MapConfig, pyr, fov_mask,
                         sensor_pos, key=None, rt=None):
    """FOV registration over the compact set: compaction + pyramid grouping,
    rank kill beyond the per-cell capacity (``dsp_dynamic.h:1256-1259``) and
    the dense+spill binning the measurement update consumes (same
    :class:`~.fov.FovBinning` layout; ``slot`` holds compact row indices,
    sentinel ``P``).

    ``pyr``/``fov_mask`` come from :class:`CompactSweep` (single-sensor) or
    :func:`fov_geometry_compact` (multi-sensor).  The extra in-FOV velocity
    perturbation (``dsp_dynamic.h:1261-1269``) applies on survivors for
    noisy configurations (statically dead under limit-xy / static, see
    ops/fov.py)."""
    from .fov import _bin_candidates

    f_cap = cfg.fov_buffer_capacity
    n_pyr = cfg.n_pyramids

    fov_alive = fov_mask & (particles.flags != 0)
    idx, cand_pyr, ranks, sel_valid, n_fov = compact_and_group(
        fov_alive, pyr, f_cap, n_pyr
    )
    flags, fovbin, stats = _bin_candidates(
        particles, cfg, sensor_pos, idx, cand_pyr, ranks, sel_valid,
        jnp.sum(fov_alive),
    )

    if cfg.limit_motion_to_xy_plane or cfg.motion_model == "static":
        vx, vy, vz = particles.vx, particles.vy, particles.vz
    else:
        alive_fov = fov_alive & (flags != 0)
        sigma_v = cfg.velocity_noise_std if rt is None else rt.velocity_noise_std
        noise = (
            jax.random.normal(key, (2,) + particles.vx.shape, jnp.float32)
            * sigma_v
        )
        keep_still = jnp.abs(particles.vx * particles.vy * particles.vz) < 1e-6
        jitter = alive_fov & ~keep_still
        vx = jnp.where(jitter, particles.vx + noise[0], particles.vx)
        vy = jnp.where(jitter, particles.vy + noise[1], particles.vy)
        vz = jnp.where(jitter, 0.0, particles.vz)

    new_particles = dataclasses.replace(
        particles, flags=flags, vx=vx, vy=vy, vz=vz
    )
    return new_particles, fovbin, stats


def insert_compact(particles, cfg: MapConfig, *, pos, vel, weight, valid,
                   origin, flag, t, count_v, budget: int | None = None,
                   shard=None):
    """Capacity-limited insertion into free rows of the compact array
    (``addAParticle``, ``dsp_dynamic.h:1183-1201``).

    ``count_v [Vs]``: current per-voxel occupancy (the capacity baseline).
    Candidates rank per destination voxel in arrival order and are eligible
    while ``rank < S - count_v[dest]`` (drop-on-full, ``:1198-1200``);
    eligible candidates land in free rows first-to-last.  Rows exhausted ->
    drop + count (``pool_overflow``; global-budget deviation, no reference
    analogue).  Returns ``(new_particles, n_born, n_dropped)``.

    ``shard``: candidates whose destination voxel this shard does not own
    are excluded (their owner inserts them); ``count_v`` is then the local
    slab's table."""
    P = particles.flags.shape[0]
    S = cfg.slots_per_voxel
    Vs = count_v.shape[0]
    M = pos.shape[0]

    wv = geometry.world_voxel(pos, cfg)
    inside = geometry.in_window(wv, origin, cfg)
    dest = geometry.storage_index(wv, cfg)
    valid = valid & inside
    if shard is not None:
        valid = valid & shard.owns(dest, Vs)
        dest = jnp.clip(dest - shard.lo, 0, Vs - 1)
    order, sorted_dest, ranks = sort_by_destination(dest, valid)
    # Pre-filter by the UNCONDITIONAL capacity bound (rank < S needs no
    # gather); the occupancy-dependent bound gathers ``count_v`` only for
    # the compacted bucket rows instead of an [M]-wide random gather.
    prefilter = (sorted_dest < I32_MAX) & (ranks < S)

    if budget is None:
        budget = M
    budget = min(budget, M)

    def branch(bud):
        def run(particles):
            c_pos, c_ok, _, _ = compact_mask(prefilter, bud)
            dest_c = jnp.minimum(sorted_dest[c_pos], Vs - 1)
            free_cap_c = jnp.maximum(
                S - count_v[dest_c].astype(jnp.int32), 0
            )
            eligible = c_ok & (ranks[c_pos] < free_cap_c)
            free_rows, free_ok, n_free, _ = compact_mask(
                particles.flags == 0, bud
            )
            elig_rank = jnp.cumsum(eligible.astype(jnp.int32)) - 1
            land = eligible & (elig_rank < n_free)
            row = jnp.where(
                land, free_rows[jnp.clip(elig_rank, 0, bud - 1)], P
            )
            src = order[c_pos]  # original candidate index
            pay = jnp.concatenate(
                [pos, vel, weight[:, None]], axis=1
            )[src]  # [bud, 7] contiguous row gather
            flags = particles.flags.at[row].set(
                jnp.broadcast_to(jnp.asarray(flag, jnp.int32), row.shape),
                mode="drop", unique_indices=True,
            )

            def put(plane, vals):
                return plane.at[row].set(vals, mode="drop",
                                         unique_indices=True)

            tt = particles.t if t is None else put(
                particles.t, jnp.broadcast_to(jnp.float32(t), row.shape))
            new = dataclasses.replace(
                particles,
                flags=flags,
                px=put(particles.px, pay[:, 0]),
                py=put(particles.py, pay[:, 1]),
                pz=put(particles.pz, pay[:, 2]),
                vx=put(particles.vx, pay[:, 3]),
                vy=put(particles.vy, pay[:, 4]),
                vz=put(particles.vz, pay[:, 5]),
                weight=put(particles.weight, pay[:, 6]),
                t=tt,
            )
            n_landed = jnp.sum(land)
            return new, n_landed, jnp.sum(eligible) - n_landed
        return run

    if budget < M:
        # Prefix-bucket ladder as in ops/insert.py: every budget-sized stage
        # (the two compactions, the payload row gather, the 8-9 row-indexed
        # scatters) runs at the smallest power-of-two bucket holding the
        # realized pre-filtered count; burst frames fall through to full
        # width.
        sizes = [budget]
        while sizes[0] > 2048:
            sizes.insert(0, sizes[0] // 2)
        n_pre = jnp.sum(prefilter)
        case = jnp.searchsorted(jnp.asarray(sizes, jnp.int32), n_pre)
        return jax.lax.switch(
            case, [branch(b) for b in sizes] + [branch(M)], particles
        )
    return branch(M)(particles)


def _run_fills(x_cols, is_start, is_end, max_run):
    """Per-row run-scan kit: returns ``(hi, tot)`` per column, where ``hi``
    is the inclusive within-run prefix sum at each row and ``tot`` the run's
    total broadcast to every row (:func:`seg_scans`)."""
    return seg_scans(x_cols, is_start, is_end, max_run, len(x_cols))


def occupancy_compact(particles, cfg: MapConfig, origin, future_in,
                      shard=None):
    """Cull + per-voxel aggregates + future scatter + systematic resampling
    over the compact set (``mapOccupancyCalculationAndResample``,
    ``dsp_dynamic.h:924-1057``).

    Semantics match ops/occupancy.py line for line: weight cull
    (``:941-942``), survivor weight sums / old-particle velocity means
    (``:944-948,968-984``), per-horizon future scatter of old particles
    (``:950-964``), per-voxel systematic resampling with mass-conserving
    fold-back (``:986-1055``) and the newborn flag reset (``:968``).

    O(alive) formulation: ONE stable sort by cell moves the live rows to a
    cell-grouped prefix (the sort IS the defrag -- dead rows sort to the
    tail), ONE [P, F] row gather realizes the sorted payload, and
    everything after is elementwise: the in-voxel systematic walk
    evaluates on run scans (:func:`_run_fills`), aggregates ride
    :func:`segment_table` (run ends == occupied voxels on the sorted
    array), and the output IS the sorted view
    with flag/weight edits -- resample copies land in the few dropped holes
    via one small scatter.  In-voxel order is compact-row order (the pool
    layout uses slot order, the reference its insert order -- all three
    arbitrary; the documented survival-semantics-not-scan-order deviation,
    SURVEY.md 7.3)."""
    P = particles.flags.shape[0]
    S = cfg.slots_per_voxel
    #: shard_map fast path: state tensors are this shard's slab; cells
    #: localize by the slab offset (every valid row is owned -- the
    #: rebin exchange maintains the invariant).
    Vs = future_in.shape[1]
    lo = 0 if shard is None else shard.lo
    T = cfg.n_horizons
    with_t = bool(cfg.record_particle_time)

    w = particles.weight
    valid_in = particles.valid
    culled = valid_in & (w < cfg.weight_cull_threshold)
    valid = valid_in & ~culled
    newborn = valid & (particles.flags == FLAG_NEWBORN)
    old = valid & ~newborn
    moving = old & (
        (particles.vx != 0.0) | (particles.vy != 0.0) | (particles.vz != 0.0)
    )

    wx, wy, wz = geometry.world_voxel_planar(
        particles.px, particles.py, particles.pz, cfg
    )
    cell = geometry.storage_index_planar(wx, wy, wz, cfg) - lo

    # ---- future-status movers (pre-resample weights, dsp_dynamic.h:950) --
    m_i, m_ok, n_moving, fm_over = compact_mask(moving, cfg.mover_capacity)
    m_px, m_py, m_pz = (particles.px[m_i], particles.py[m_i],
                        particles.pz[m_i])
    m_vx, m_vy, m_vz = (particles.vx[m_i], particles.vy[m_i],
                        particles.vz[m_i])
    m_w = jnp.where(m_ok, w[m_i], 0.0)
    if shard is not None:
        (m_px, m_py, m_pz, m_vx, m_vy, m_vz, m_w, m_ok) = jax.tree.map(
            shard.gather_flat, (m_px, m_py, m_pz, m_vx, m_vy, m_vz, m_w, m_ok)
        )

    # ---- the sort (defrag): valid rows first, grouped by cell ----------
    key = jnp.where(valid, cell, I32_MAX)
    iota = jnp.arange(P, dtype=jnp.int32)
    sorted_key, order = jax.lax.sort((key, iota), is_stable=True, num_keys=1)
    pay_cols = [particles.px, particles.py, particles.pz,
                particles.vx, particles.vy, particles.vz, w,
                newborn.astype(jnp.float32)]
    if with_t:
        pay_cols.append(particles.t)
    pay = jnp.stack(pay_cols, axis=-1)  # [P, F]
    spay = pay[order]  # ONE row gather
    valid_s = sorted_key < I32_MAX
    cell_s = jnp.where(valid_s, sorted_key, Vs)
    w_s = jnp.where(valid_s, spay[:, 6], 0.0)
    nb_s = valid_s & (spay[:, 7] > 0.0)
    old_s = valid_s & ~nb_s
    mv_s = old_s & (
        (spay[:, 3] != 0.0) | (spay[:, 4] != 0.0) | (spay[:, 5] != 0.0)
    )

    # ---- shared run boundaries (sorted: one run per occupied voxel) ----
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_key[1:] != sorted_key[:-1]]
    )
    is_end = jnp.concatenate(
        [sorted_key[1:] != sorted_key[:-1], jnp.ones((1,), bool)]
    ) & valid_s

    # ---- one segmented-scan set feeds BOTH the per-voxel aggregate table
    # (values read at run ends) and the resample walk (per-row prefixes) --
    # merging the former segment_table call's scan, mask and switch away.
    cols7 = [
        valid_s.astype(jnp.float32),
        w_s,
        old_s.astype(jnp.float32),
        jnp.where(old_s, spay[:, 3], 0.0),
        jnp.where(old_s, spay[:, 4], 0.0),
        jnp.where(old_s, spay[:, 5], 0.0),
        jnp.where(old_s & ~mv_s, w_s, 0.0),
    ]
    his7, tots2 = seg_scans(cols7, is_start, is_end, 2 * S, 2)
    hi_n, hi_w = his7[0], his7[1]
    tot_n, tot_w = tots2[0], tots2[1]

    weight_sum, n_old, svx, svy, svz, static_contrib = _ends_table(
        jnp.stack(his7[1:], axis=-1), cell_s, is_end, Vs,
        jnp.stack(cols7[1:], axis=-1),
    )
    denom = jnp.maximum(n_old, 1.0)
    vel_avg = jnp.stack([svx / denom, svy / denom, svz / denom], axis=-1) * (
        n_old > 0
    )[:, None]

    # ---- future grid (dsp_dynamic.h:950-964) ---------------------------
    future = future_in + static_contrib[None, :]
    taus = jnp.asarray(cfg.prediction_horizons, jnp.float32)
    fx = m_px[None, :] + m_vx[None, :] * taus[:, None]
    fy = m_py[None, :] + m_vy[None, :] * taus[:, None]
    fz = m_pz[None, :] + m_vz[None, :] * taus[:, None]
    fwx, fwy, fwz = geometry.world_voxel_planar(fx, fy, fz, cfg)
    ok = m_ok[None, :] & geometry.in_window_planar(fwx, fwy, fwz, origin, cfg)
    fcell = geometry.storage_index_planar(fwx, fwy, fwz, cfg)
    if shard is not None:
        ok = ok & shard.owns(fcell, Vs)
        fcell = fcell - shard.lo
    fidx = jnp.where(
        ok, fcell + Vs * jnp.arange(T, dtype=jnp.int32)[:, None], T * Vs
    )
    future = (
        future.reshape(-1)
        .at[fidx.ravel()]
        .add(jnp.broadcast_to(m_w[None, :], fidx.shape).ravel(), mode="drop")
        .reshape(T, Vs)
    )

    # ---- systematic resampling on run scans (dsp_dynamic.h:986-1055) ---
    do_rs = valid_s & (tot_n >= cfg.resample_min_count)
    n_target = jnp.minimum(tot_n, cfg.max_particles_per_voxel)
    wa = jnp.where(do_rs, tot_w / jnp.maximum(n_target, 1.0), 1.0)
    hi = hi_w
    lo = hi - w_s

    def n_grid(x):  # grid points wa*(k+1/2) strictly below x
        return jnp.maximum(jnp.ceil(x / wa - 0.5), 0.0).astype(jnp.int32)

    copies = jnp.where(do_rs, n_grid(hi) - n_grid(lo), 0)
    kept = do_rs & (copies >= 1)
    dropped = do_rs & (copies == 0)
    extra = jnp.maximum(copies - 1, 0)
    survivor = valid_s & ~dropped

    (hi_d, hi_e), (tot_d, tot_e) = _run_fills(
        [dropped.astype(jnp.float32), extra.astype(jnp.float32)],
        is_start, is_end, 2 * S,
    )
    demand_start = hi_e - extra
    total_free = jnp.maximum(S - tot_n + tot_d, 0.0)
    placed = jnp.clip(
        (total_free - demand_start).astype(jnp.int32), 0, extra
    )
    unplaced = (extra - placed).astype(jnp.float32)
    new_w = jnp.where(kept, wa * (1.0 + unplaced), w_s)

    # ---- in-place output on the sorted view ----------------------------
    n_surv = jnp.sum(survivor)
    flags_out = jnp.where(survivor, FLAG_VALID, jnp.int32(0))
    pay_out = spay.at[:, 6].set(jnp.where(survivor, new_w, 0.0))

    # resample copies into the dropped holes (few): one small scatter.
    copy_cap = min(cfg.mover_capacity, P)
    copy_start = jnp.cumsum(placed) - placed
    n_copies = jnp.sum(placed)
    cp_i, cp_ok, _, _ = compact_mask(placed > 0, copy_cap)
    src0 = (
        jnp.zeros((copy_cap,), jnp.int32)
        .at[jnp.where(cp_ok, copy_start[cp_i], copy_cap)]
        .max(cp_i, mode="drop", unique_indices=True)
    )
    src_fill = jax.lax.cummax(src0)  # sorted-row source per copy slot
    hole_i, hole_ok, n_holes, _ = compact_mask(~survivor, copy_cap)
    k = jnp.arange(copy_cap, dtype=jnp.int32)
    n_placed = jnp.minimum(jnp.minimum(n_copies, n_holes), copy_cap)
    make = k < n_placed
    target = jnp.where(make, hole_i, P)
    crow = pay_out[src_fill]  # [copy_cap, F] row gather
    crow = crow.at[:, 6].set(wa[src_fill])
    pay_out = pay_out.at[target].set(crow, mode="drop", unique_indices=True)
    flags_out = flags_out.at[target].set(FLAG_VALID, mode="drop",
                                         unique_indices=True)

    new_particles = dataclasses.replace(
        particles,
        flags=flags_out,
        px=pay_out[:, 0], py=pay_out[:, 1], pz=pay_out[:, 2],
        vx=pay_out[:, 3], vy=pay_out[:, 4], vz=pay_out[:, 5],
        weight=pay_out[:, 6],
        t=pay_out[:, 8] if with_t else particles.t,
    )

    stats = {
        "alive": n_surv + n_placed,
        "culled": jnp.sum(culled),
        "resampled_voxels": jnp.sum(is_end & do_rs).astype(jnp.int32),
        "resample_dropped": jnp.sum(dropped),
        "resample_copies": n_placed,
        "pool_overflow": n_copies - n_placed,
        "future_moving": jnp.minimum(n_moving, cfg.mover_capacity),
        "future_overflow": fm_over,
    }
    return new_particles, weight_sum, vel_avg, future, stats
