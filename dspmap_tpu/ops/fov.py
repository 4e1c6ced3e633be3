"""Particle registration into FOV pyramid cells.

The reference rebuilds its ``pyramids_in_fov`` back-pointer table during
prediction: every valid particle in the FOV is linear-probed into its pyramid
cell's slot list, vanishing if the cell is full, and receives an extra
velocity perturbation (``moveParticle``, ``include/dsp_dynamic.h:1232-1271``).

Here the table is recomputed per frame as dense gather tensors: in-FOV
particles are compacted AND pyramid-sorted in one stable sort keyed by
(in-FOV?, pyramid); rank overflow beyond the per-cell capacity kills the
particle (the pyramid-full vanish path, ``dsp_dynamic.h:1256-1259``).
Particles ranked below the dense processing tier (``cfg.dense_slots``) land
in the dense ``[n_pyramids, dense_slots]`` tiles the measurement update's
pair passes consume; ranks between the tier and the reference's kill
threshold (``cfg.pyramid_slots``) are compacted into a small *spill* buffer
the update processes exactly (see ops/update.py) -- a processing layout, not
a semantics change.  All binned-tensor scatters use unique indices; all
geometry runs on coordinate planes (no ``[..., 3]``
stacking).

Quirk preserved (``dsp_dynamic.h:1261-1269``): surviving in-FOV particles
with ``|vx*vy*vz| >= 1e-6`` get extra vx/vy noise and vz hard-zeroed -- the
vz zeroing here is unconditional in the reference, independent of
``LIMIT_MOVEMENT_IN_XY_PLANE``.  Under xy-limited configs vz is identically
zero, the product is zero, and the branch is statically dead -- elided
exactly (see ops/propagate.py docstring).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import MapConfig
from .. import geometry
from .common import (compact_and_group, compact_mask, pool_put, pool_sv,
                     pool_take, pool_take_stacked,
                     group_ranks, sort_by_destination)


#: prefix-bucket specialization of the rebin candidate chain (see
#: _rebin_chain); tests flip it off to compare against the full-width path.
_FOV_BUCKETS = True


class FovBinning(NamedTuple):
    """Dense + spill pyramid-binned view of the in-FOV particle population."""

    pos: jnp.ndarray  # f32 [n_pyr, S_t, 3] world positions (dense tier)
    weight: jnp.ndarray  # f32 [n_pyr, S_t]
    rng: jnp.ndarray  # f32 [n_pyr, S_t] ego range (occlusion test)
    mask: jnp.ndarray  # bool [n_pyr, S_t]
    slot: jnp.ndarray  # i32 [n_pyr, S_t] flat index into the [S, V] pool
    sp_pos: jnp.ndarray  # f32 [Psp, 3] spill tier (rank in [S_t, pyramid_slots))
    sp_weight: jnp.ndarray  # f32 [Psp]
    sp_rng: jnp.ndarray  # f32 [Psp]
    sp_pyr: jnp.ndarray  # i32 [Psp] pyramid cell (n_pyr sentinel)
    sp_mask: jnp.ndarray  # bool [Psp]
    sp_slot: jnp.ndarray  # i32 [Psp] flat pool index
    sp_overflow: jnp.ndarray  # i32 scalar: spill particles beyond capacity


def _bin_candidates(particles, cfg: MapConfig, sensor_pos, idx, cand_pyr,
                    ranks, sel_valid, n_fov, cols=None, apply_kill=True):
    """Shared two-tier binning: dense scatter + spill compaction + overflow
    kill flags, from the compacted (pyramid-sorted) candidate buffers.

    ``cols`` optionally supplies pre-gathered ``(px, py, pz, weight)``
    candidate columns (callers that already paid the pool gathers).
    ``apply_kill=False`` skips the kill flags scatter -- the caller merged
    the kill rows into an adjacent flags-plane write (rebin's mover
    scatter; one plane copy instead of two); the kill mask is still
    computed here for the stats.

    Layout-agnostic: ``idx`` are flat positions into the particle store and
    the drop sentinel is its total size -- ``S*V`` for the pool layout,
    ``P`` for the compact layout (ops/compact.py)."""
    total = particles.flags.size
    n_pyr, s_pyr, S_t = cfg.n_pyramids, cfg.pyramid_slots, cfg.dense_slots
    f_cap, p_cap = cfg.fov_buffer_capacity, cfg.particle_spill_capacity
    grid_cap = n_pyr * S_t

    keep = sel_valid & (ranks < S_t)
    spill_sel = sel_valid & (ranks >= S_t) & (ranks < s_pyr)
    kill = sel_valid & (ranks >= s_pyr)  # pyramid-cell overflow -> vanish

    # Kill overflow particles (dsp_dynamic.h:1256-1259).
    if apply_kill:
        kill_flat = jnp.where(kill, idx, total)
        flags = pool_put(particles.flags, kill_flat,
                         jnp.broadcast_to(jnp.int32(0), kill_flat.shape))
    else:
        flags = particles.flags

    if cols is None:
        if particles.flags.ndim == 1 and particles.flags.size < (1 << 20):
            # compact layout: the 4-plane stack costs four tiny [P] copies
            # and the window gather pays its per-row cost once for all
            # four fields (pool_take_stacked)
            px, py, pz, w = pool_take_stacked(
                [particles.px, particles.py, particles.pz,
                 particles.weight], idx,
            )
        else:
            px = pool_take(particles.px, idx)
            py = pool_take(particles.py, idx)
            pz = pool_take(particles.pz, idx)
            w = pool_take(particles.weight, idx)
    else:
        px, py, pz, w = cols
    rng_c = jnp.sqrt(
        (px - sensor_pos[0]) ** 2
        + (py - sensor_pos[1]) ** 2
        + (pz - sensor_pos[2]) ** 2
    )

    # Dense binned tensors: all scatters hit unique (pyramid, rank) cells.
    # One stacked [M, 7] scatter replaces five separate ones (scatter
    # index processing is per row).  The slot ids ride along bitcast to
    # f32 with bit 30 forced on: small integers bitcast to f32 DENORMALS,
    # which a device may flush to zero when a fusion routes the lane
    # through float datapaths.
    # Bit 30 makes the exponent field nonzero (a normal float) for any
    # id < 2^30; ids here are flat pool slots < S*V.
    cell = jnp.where(keep, cand_pyr * S_t + ranks, grid_cap)
    upd = jnp.stack(
        [px, py, pz, w, rng_c, keep.astype(jnp.float32),
         jax.lax.bitcast_convert_type(idx | 0x40000000, jnp.float32)],
        axis=-1
    )  # [M, 7]
    fill = jnp.zeros((7,), jnp.float32).at[6].set(
        jax.lax.bitcast_convert_type(jnp.int32(total) | 0x40000000,
                                     jnp.float32)
    )
    big = (
        jnp.broadcast_to(fill, (grid_cap + 1, 7))
        .at[cell]
        .set(upd, mode="drop", unique_indices=True)[:grid_cap]
    )
    bpos = big[:, 0:3].reshape(n_pyr, S_t, 3)
    bw = big[:, 3].reshape(n_pyr, S_t)
    brng = big[:, 4].reshape(n_pyr, S_t)
    bmask = (big[:, 5] > 0).reshape(n_pyr, S_t)
    bslot = (
        jax.lax.bitcast_convert_type(big[:, 6], jnp.int32) & ~0x40000000
    ).reshape(n_pyr, S_t)

    # Spill tier: ranks in [S_t, s_pyr) -- compacted, exact-path processed.
    if S_t < s_pyr:
        sp_i, sp_valid, _, sp_over = compact_mask(spill_sel, p_cap)
        sp_pos = jnp.where(
            sp_valid[:, None],
            jnp.stack([px[sp_i], py[sp_i], pz[sp_i]], axis=-1),
            0.0,
        )
        sp_w = jnp.where(sp_valid, w[sp_i], 0.0)
        sp_rng = jnp.where(sp_valid, rng_c[sp_i], 0.0)
        sp_pyr = jnp.where(sp_valid, cand_pyr[sp_i], n_pyr)
        sp_slot = jnp.where(sp_valid, idx[sp_i], total)
    else:
        sp_pos = jnp.zeros((p_cap, 3), jnp.float32)
        sp_w = jnp.zeros((p_cap,), jnp.float32)
        sp_rng = jnp.zeros((p_cap,), jnp.float32)
        sp_pyr = jnp.full((p_cap,), n_pyr, jnp.int32)
        sp_valid = jnp.zeros((p_cap,), bool)
        sp_slot = jnp.full((p_cap,), total, jnp.int32)
        sp_over = jnp.int32(0)

    fovbin = FovBinning(
        pos=bpos, weight=bw, rng=brng, mask=bmask, slot=bslot,
        sp_pos=sp_pos, sp_weight=sp_w, sp_rng=sp_rng, sp_pyr=sp_pyr,
        sp_mask=sp_valid, sp_slot=sp_slot, sp_overflow=sp_over,
    )
    stats = {
        "in_fov": jnp.minimum(n_fov, f_cap),
        "pyramid_full_killed": jnp.sum(kill),
        "fov_global_overflow": jnp.maximum(n_fov - f_cap, 0),
        "update_spill_overflow": sp_over,
    }
    return flags, fovbin, stats


def register_fov(
    particles,
    cfg: MapConfig,
    sensor_pos: jnp.ndarray,
    quat: jnp.ndarray,
    key: jax.Array,
    rt=None,  # state.RuntimeParams: traced velocity-noise sigma (None -> cfg)
):
    """Returns ``(new_particles, FovBinning, stats)``.

    ``new_particles`` reflects pyramid-overflow kills and the in-FOV velocity
    perturbation; the binning indexes into ``new_particles``.
    """
    n_pyr = cfg.n_pyramids
    f_cap = cfg.fov_buffer_capacity

    # Sensor-frame coordinates of every slot, on planes.
    Rm = geometry.rotation_matrix(geometry.quaternion_conjugate(quat))
    ex = particles.px - sensor_pos[0]
    ey = particles.py - sensor_pos[1]
    ez = particles.pz - sensor_pos[2]
    sx, sy, sz = geometry.rotate_planar(Rm, ex, ey, ez)
    pyr, in_fov = geometry.pyramid_index_planar(sx, sy, sz, cfg)
    fov_mask = particles.valid & in_fov  # [S, V]

    # Fused compaction + pyramid grouping (one stable sort over the pool).
    idx, cand_pyr, ranks, sel_valid, n_fov = compact_and_group(
        fov_mask, pyr, f_cap, n_pyr
    )

    flags, fovbin, stats = _bin_candidates(
        particles, cfg, sensor_pos, idx, cand_pyr, ranks, sel_valid, n_fov
    )

    # Extra in-FOV velocity noise on survivors (dsp_dynamic.h:1261-1269);
    # statically dead under xy-limited configs (vz == 0 for all particles).
    if cfg.limit_motion_to_xy_plane or cfg.motion_model == "static":
        vx, vy, vz = particles.vx, particles.vy, particles.vz
    else:
        alive_fov = fov_mask & (flags != 0)
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

    new_particles = dataclasses.replace(particles, flags=flags, vx=vx, vy=vy, vz=vz)
    return new_particles, fovbin, stats


def rebin_and_register(
    particles,
    cfg: MapConfig,
    sw,
    sensor_pos: jnp.ndarray,
    update_time,
    shard=None,
):
    """Fused relocation + FOV registration for the fused-sweep path
    (limit-xy / static configurations): ONE pool-sized compaction over
    ``mover | fov`` replaces the separate mover and FOV compactions.
    Covers ``moveParticle`` /
    ``removeParticle`` (dsp_dynamic.h:1206-1279,686-690) plus the
    ``pyramids_in_fov`` rebuild.

    Candidate ranks are computed by a small argsort whose output scatters
    back to buffer order, so no payload column is ever permuted; the dense
    pyramid tiles scatter straight from the combined buffer.

    Ordering deviation (documented): FOV candidates keep pre-relocation
    pool order (the separate-pass formulation ordered relocated movers by
    their new slots), so pyramid-overflow tie-breaking can differ when a
    cell exceeds the kill threshold -- same capacity bound, same
    conservation.

    Returns ``(new_particles, FovBinning, future_movers, stats, pending)``
    where ``future_movers = (flat[m_cap], valid[m_cap], n_dropped)`` is the
    compacted nonzero-velocity candidate set consumed by
    ``occupancy_and_resample`` (saving its own pool-sized compaction) and
    ``pending`` is the deferred mover payload for huge pools (None
    otherwise) -- consumed by :func:`~.birth.particle_birth`, which merges
    its plane scatters and corrects its DS classification for it.

    Shard_map fast path (``shard`` = :class:`~.common.ShardCtx`): the pool
    is this shard's slab and mover destinations are global, so the mover
    buffer is ``all_gather``-exchanged over the map axis and each shard
    re-inserts the arrivals it owns (cells in its slab) -- the bounded
    cross-slab traffic SURVEY.md section 7.1.7 names.  Arrival order across
    shards is shard-major (documented deviation from the single-pool flat
    order; it matters only when a voxel's slots are contested).  FOV
    registration then runs over local non-mover candidates plus the
    inserted arrivals (whose fov/moving/pyramid tags ride the exchange).
    """
    from .insert import allocate_slots, scatter_candidates

    S, V = pool_sv(particles.flags, cfg)
    n_pyr = cfg.n_pyramids
    cap = cfg.fov_buffer_capacity
    m_cap = cfg.mover_capacity

    idx_f, c_valid_f, n_sel, n_comb_over = compact_mask(sw.candidate, cap)
    total_movers = jnp.sum(sw.mover)
    total_fov = jnp.sum(sw.fov)

    # Vacate mover sources first, then fill (see ops/rebin.py docstring for
    # the documented parallel-semantics deviation).
    flags_vac = jnp.where(sw.mover, jnp.int32(0), particles.flags)
    vacated = dataclasses.replace(particles, flags=flags_vac)

    return _rebin_chain(
        particles, vacated, cfg, sw, sensor_pos, update_time, shard,
        idx_f, c_valid_f, n_sel, n_comb_over, total_movers, total_fov,
        allocate_slots, scatter_candidates,
    )


def _rebin_chain(particles, vacated, cfg, sw, sensor_pos, update_time,
                 shard, idx_f, c_valid_f, n_sel, n_comb_over,
                 total_movers, total_fov, allocate_slots,
                 scatter_candidates):
    """Candidate-buffer chain of :func:`rebin_and_register`, prefix-bucket
    specialized (shard-less path): every capacity-sized stage -- the 5-plane
    stacked gather, the FOV grouping sort, the rank scatters and the dense
    binning scatter -- runs at the smallest power-of-two bucket holding the
    realized candidate count instead of the full ``fov_buffer_capacity``
    (steady-state counts sit at ~1/3 of capacity; same lever as the birth
    insert's bucket switch, ops/insert.py)."""
    S, V = pool_sv(particles.flags, cfg)
    n_pyr = cfg.n_pyramids
    cap = cfg.fov_buffer_capacity
    m_cap = cfg.mover_capacity

    def chain(idx, c_valid, n_cand):
        return _rebin_chain_body(
            particles, vacated, cfg, sw, sensor_pos, update_time, shard,
            idx, c_valid, n_comb_over, total_movers, total_fov,
            allocate_slots, scatter_candidates, n_cand,
        )

    # Halving ladder plus 3/4 steps: realized steady-state candidate counts
    # sit just above a power-of-two on both the flagship (~13k vs 12288)
    # and multi (~17k vs 16384), which otherwise forces the full-width
    # branch every frame.
    sizes = [cap]
    while sizes[0] > (4096 if _FOV_BUCKETS else cap):
        sizes.insert(0, sizes[0] // 2)
    if _FOV_BUCKETS:
        sizes = sorted({*sizes, *(3 * s // 4 for s in sizes if
                                  3 * s // 4 >= 4096 and (3 * s) % 4 == 0)})
    if shard is not None or len(sizes) == 1:
        return chain(idx_f, c_valid_f, cap)
    case = jnp.minimum(
        jnp.searchsorted(jnp.asarray(sizes, jnp.int32), n_sel),
        len(sizes) - 1,
    )
    return jax.lax.switch(
        case,
        [lambda _, bs=bs: chain(idx_f[:bs], c_valid_f[:bs], bs)
         for bs in sizes],
        0,
    )


def _rebin_chain_body(particles, vacated, cfg, sw, sensor_pos, update_time,
                      shard, idx, c_valid, n_comb_over, total_movers,
                      total_fov, allocate_slots, scatter_candidates,
                      n_cand_cap):
    S, V = pool_sv(particles.flags, cfg)
    n_pyr = cfg.n_pyramids
    cap = n_cand_cap  # bucket width of the candidate buffer
    m_cap = cfg.mover_capacity

    # One window gather over a 5-plane stack: the per-row cost is paid once
    # for all five fields (vs five pair gathers at ~11 ns/row each;
    # common.pool_take_stacked).  compact_mask output is ascending, so the
    # gather advertises sorted indices.
    tags, px, py, pz, w = pool_take_stacked(
        [sw.tags, particles.px, particles.py, particles.pz,
         particles.weight], idx,
    )
    is_mover = ((tags & 1) != 0) & c_valid
    is_fov = ((tags & 2) != 0) & c_valid
    is_moving = ((tags & 4) != 0) & c_valid
    pyr = tags >> 4
    flat0 = jnp.where(c_valid, idx, S * V)

    # ---- movers: compact to the mover buffer and re-insert -------------
    # The destination cell is only consumed by the (much smaller) mover
    # buffer, so the ``new_cell`` plane is gathered at mover size rather
    # than combined-buffer size.
    mov_i, mov_ok, n_mov, mov_buf_over = compact_mask(is_mover, m_cap)
    mov_src = jnp.minimum(flat0[mov_i], S * V - 1)
    mov_cell = jnp.where(mov_ok, pool_take(sw.new_cell, mov_src), V)

    if shard is None:
        order, _, ranks_sorted = sort_by_destination(mov_cell, mov_ok)
        mov_ranks = (
            jnp.zeros((m_cap,), jnp.int32).at[order].set(ranks_sorted,
                                                         unique_indices=True)
        )
        safe_src = jnp.minimum(jnp.where(mov_ok, flat0[mov_i], S * V),
                               S * V - 1)
        new_flat, keep_ins = allocate_slots(
            vacated, mov_cell, mov_ranks, mov_ok, cfg=cfg
        )
        cols_m = (
            px[mov_i], py[mov_i], pz[mov_i],
            pool_take(particles.vx, safe_src),
            pool_take(particles.vy, safe_src),
            pool_take(particles.vz, safe_src),
            w[mov_i],
        )
        own_over = ring_undelivered = jnp.int32(0)
        n_arrivals = n_mov
    else:
        # Cross-slab exchange: every shard's mover buffer (payload + global
        # destination + sweep tags) is all_gathered, then this shard
        # compacts and inserts the arrivals whose destination cell it owns.
        exp = (
            mov_cell,
            px[mov_i], py[mov_i], pz[mov_i],
            pool_take(particles.vx, mov_src),
            pool_take(particles.vy, mov_src),
            pool_take(particles.vz, mov_src),
            w[mov_i],
            tags[mov_i],
            mov_ok & (mov_cell < cfg.voxel_num),
        )
        if cfg.mover_exchange == "ring":
            reach = shard.ring_reachable(
                jnp.maximum(exp[0], 0), V, cfg.ring_hops
            )
            ring_undelivered = jnp.sum(exp[-1] & ~reach)
            ex = lambda x: shard.gather_ring(x, cfg.ring_hops)  # noqa: E731
        else:
            ring_undelivered = jnp.int32(0)
            ex = shard.gather_flat
        (a_cell, a_px, a_py, a_pz, a_vx, a_vy, a_vz, a_w, a_tags, a_ok) = (
            jax.tree.map(ex, exp)
        )
        own = a_ok & shard.owns(a_cell, V)
        own_i, own_ok, n_own, own_over = compact_mask(own, m_cap)
        mov_cell = jnp.where(own_ok, a_cell[own_i] - shard.lo, V)
        ins_tags = jnp.where(own_ok, a_tags[own_i], 0)
        order, _, ranks_sorted = sort_by_destination(mov_cell, own_ok)
        mov_ranks = (
            jnp.zeros((m_cap,), jnp.int32).at[order].set(ranks_sorted,
                                                         unique_indices=True)
        )
        new_flat, keep_ins = allocate_slots(
            vacated, mov_cell, mov_ranks, own_ok, cfg=cfg
        )
        cols_m = (a_px[own_i], a_py[own_i], a_pz[own_i],
                  a_vx[own_i], a_vy[own_i], a_vz[own_i], a_w[own_i])
        n_arrivals = jnp.minimum(n_own, m_cap)

    # Huge-pool scatter merging (insert._DEFER_PAYLOAD_BYTES): where a
    # scatter site copies the planes it writes instead of updating them in
    # place, at >= 64 MB planes that copy dominates.  Defer the six pos/vel
    # plane scatters to ride particle birth's scatter site (disjoint slots,
    # one set of plane copies instead of two); flags+weight still scatter
    # here (slot allocation reads flags, the measurement writeback
    # reads/writes weight).  None of the shipped presets reaches the
    # threshold.
    from .insert import _DEFER_PAYLOAD_BYTES

    defer = S * V * 4 >= _DEFER_PAYLOAD_BYTES

    # ---- FOV registration from the combined buffer ---------------------
    if shard is None:
        # Remap relocated movers to their new flat slots; voxel-full-killed
        # movers get the sentinel and drop out of the FOV set.  The FOV
        # grouping runs BEFORE the mover scatter (it depends only on the
        # allocation), so the pyramid-overflow kill rows merge INTO the
        # mover flags scatter: one flags-plane write per frame instead of
        # two.
        flat = flat0.at[jnp.where(mov_ok, mov_i, cap)].set(
            jnp.where(keep_ins, new_flat, S * V), mode="drop"
        )
        fov_sel = is_fov & (flat < S * V)
        cand_pyr, cand_px, cand_py, cand_pz, cand_w = pyr, px, py, pz, w
        mv_sel = is_moving & (flat < S * V)
        n_cand = cap

        keys = jnp.where(fov_sel, cand_pyr, n_pyr)
        sorted_keys, f_order = jax.lax.sort(
            (keys, jnp.arange(n_cand, dtype=jnp.int32)), is_stable=True,
            num_keys=1,
        )
        f_ranks_sorted = group_ranks(sorted_keys)
        f_ranks = (
            jnp.zeros((n_cand,), jnp.int32).at[f_order].set(
                f_ranks_sorted, unique_indices=True)
        )
        kill = fov_sel & (f_ranks >= cfg.pyramid_slots)
        # movers in the kill set write 0 through their own scatter row;
        # non-mover kill rows concatenate into the same flags scatter
        # (disjoint by construction)
        killed_m = kill[jnp.minimum(mov_i, cap - 1)] & mov_ok
        mov_flag = jnp.where(killed_m, 0, 1).astype(jnp.int32)
        kill_nm = jnp.where(kill & ~is_mover, flat, S * V)
        flag_extra = (kill_nm, jnp.zeros((n_cand,), jnp.int32))
        apply_kill = False
    else:
        mov_flag = jnp.int32(1)
        flag_extra = None
        apply_kill = True

    if defer:
        new_particles, pending = scatter_candidates(
            vacated, new_flat, cols_m, mov_flag,
            update_time if cfg.record_particle_time else None,
            cfg=cfg, defer_payload=True, flag_extra=flag_extra,
        )
    else:
        pending = None
        new_particles = scatter_candidates(
            vacated, new_flat, cols_m, mov_flag,
            update_time if cfg.record_particle_time else None,
            cfg=cfg, flag_extra=flag_extra,
        )
    # keep_ins marks exactly the candidates whose scatter lands (in-bounds
    # destination with a free slot), so the insertion count is a
    # buffer-sized reduce -- NOT a before/after pool-wide alive diff (two
    # [S, V] reduces).
    n_inserted = jnp.sum(keep_ins)

    if shard is not None:
        # Local non-mover candidates plus this shard's inserted arrivals
        # (their fov/moving bits and pyramid cell rode the exchange).
        ins_fov = ((ins_tags >> 1) & 1) != 0
        ins_mv = ((ins_tags >> 2) & 1) != 0
        flat = jnp.concatenate([
            jnp.where(is_mover, S * V, jnp.minimum(flat0, S * V)),
            jnp.where(keep_ins, new_flat, S * V),
        ])
        fov_sel = jnp.concatenate([is_fov & ~is_mover, ins_fov & keep_ins])
        fov_sel = fov_sel & (flat < S * V)
        cand_pyr = jnp.concatenate([pyr, ins_tags >> 4])
        cand_px = jnp.concatenate([px, cols_m[0]])
        cand_py = jnp.concatenate([py, cols_m[1]])
        cand_pz = jnp.concatenate([pz, cols_m[2]])
        cand_w = jnp.concatenate([w, cols_m[6]])
        mv_sel = jnp.concatenate([is_moving & ~is_mover, ins_mv & keep_ins])
        mv_sel = mv_sel & (flat < S * V)
        n_cand = cap + m_cap

        keys = jnp.where(fov_sel, cand_pyr, n_pyr)
        sorted_keys, f_order = jax.lax.sort(
            (keys, jnp.arange(n_cand, dtype=jnp.int32)), is_stable=True,
            num_keys=1,
        )
        f_ranks_sorted = group_ranks(sorted_keys)
        f_ranks = (
            jnp.zeros((n_cand,), jnp.int32).at[f_order].set(
                f_ranks_sorted, unique_indices=True)
        )

    bin_flags, fovbin, stats = _bin_candidates(
        new_particles, cfg, sensor_pos, flat,
        keys, f_ranks, fov_sel,
        total_fov, cols=(cand_px, cand_py, cand_pz, cand_w),
        apply_kill=apply_kill,
    )
    out = dataclasses.replace(new_particles, flags=bin_flags)

    # Future-status mover candidates (superset; occupancy re-checks
    # flags/newborn/cull at its own pipeline point -- ops/occupancy.py).
    # Relocated movers are already remapped in ``flat``; killed ones carry
    # the sentinel and are dropped by occupancy's validity gather.
    fm_i, fm_ok, n_fm, fm_over = compact_mask(mv_sel, m_cap)
    future_movers = (
        jnp.where(fm_ok, flat[fm_i], S * V),
        fm_ok,
        (jnp.sum(sw.moving) - jnp.sum(is_moving)) + fm_over,
    )

    n_mov_cap = jnp.minimum(n_mov, m_cap)
    stats.update(
        moved_out=jnp.sum(sw.moved_out),
        movers=n_mov_cap,
        # movers lost to either the combined or the mover buffer vanish
        # (vacated, never re-inserted) -- both counted here
        mover_overflow_killed=(total_movers - jnp.sum(is_mover))
        + mov_buf_over + own_over + ring_undelivered,
        voxel_full_killed=n_arrivals - n_inserted,
        # FOV candidates dropped by the combined buffer (they keep their
        # weight but skip the measurement update this frame)
        fov_global_overflow=total_fov - jnp.sum(is_fov),
    )
    return out, fovbin, future_movers, stats, pending
