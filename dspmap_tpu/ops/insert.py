"""Capacity-limited particle insertion: the parallel replacement for the
reference's linear-probe slot search (``addAParticle``,
``include/dsp_dynamic.h:1183-1201`` and the voxel half of ``moveParticle``,
``:1206-1230``).

Semantics preserved: each voxel has a fixed slot capacity; candidates fill the
first free slots in arrival order; when a voxel is full the surplus candidates
silently vanish (drop-on-full, ``dsp_dynamic.h:1198-1200,1227-1229``).

Mechanism:

* free slots are found through a **bitmask rank lookup**: one pool pass packs
  per-voxel occupancy into u32 words, candidates gather their voxel's word(s)
  and select their rank-th empty slot with a short in-word bit select -- no
  [S, V] slot-axis sort.
* candidate *ranks* come from a destination argsort, but the payload is
  never permuted: the sorted ranks scatter back to the original candidate
  order (one [M] scatter) and all field scatters read the caller's original
  arrays -- no 100k x 7 payload gather.
* a scatter pays per index row, dropped sentinels included, so
  ``compact_to`` switches on a ``lax.cond`` bucket specialization: when
  the surviving candidates fit the budget they are compacted and scattered
  from the small buffer; otherwise the full-capacity scatter runs -- exact
  either way, the branch only picks the cheaper program.  Used by particle
  birth, whose 100k-candidate budget (5000 pts x 20, dsp_dynamic.h:68) is
  ~5-10x the steady-state insertion
  count (voxel capacity truncates the rest); only burst frames (e.g. the
  first) take the full path.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..config import MapConfig
from .. import geometry
from .common import (I32_MAX, compact_mask, group_ranks, pool_put, pool_sv,
                     sort_by_destination)

#: pool planes at/above this size engage the mover-payload deferral
#: (ops/fov.py): where a scatter site copies the planes it writes instead
#: of updating them in place, merging the mover re-insertion's six pos/vel
#: scatters into particle birth's saves six plane copies per frame.  Below
#: the threshold the extra index rows and the lost 8-plane scatter fusion
#: outweigh the copies.
_DEFER_PAYLOAD_BYTES = 64 << 20


def empty_slot_lookup(flags, cell, ranks, slots: int | None = None):
    """Per candidate, the id of the ``ranks``-th empty slot of voxel ``cell``.

    ``flags [S, V]`` (or flat ``[S*V]`` with ``slots=S``; the word pack then
    reads S contiguous slices -- no relayout, see ``state.flatten_pool``);
    ``cell``/``ranks`` ``[M]`` (cell must be in range).
    Returns ``(slot [M], n_empty [M])`` with ``slot = S`` when
    ``ranks >= n_empty``.  One pool pass packs the occupancy bitmask; the
    rank selection is an S-step select sweep over the gathered words.
    """
    if flags.ndim == 1:
        S = slots
        V = flags.shape[0] // S
        occ_row = lambda s: flags[s * V:(s + 1) * V] != 0
    else:
        S, V = flags.shape
        occ_row = lambda s: flags[s] != 0
    # Per-voxel EMPTY bitmask words (bit s set = slot s free; bits >= S in
    # the last word stay 0 so popcounts see only real slots).
    words = []
    for w in range((S + 31) // 32):
        lo, hi = w * 32, min((w + 1) * 32, S)
        acc = jnp.zeros((V,), jnp.uint32)
        for s in range(lo, hi):
            acc = acc | jnp.where(
                occ_row(s), jnp.uint32(0),
                jnp.uint32(1) << jnp.uint32(s - lo),
            )
        words.append(acc)
    cand_words = [w[cell] for w in words]  # [M] gathers

    # ranks-th empty slot: pick the word by cumulative popcount, then a
    # 5-step in-word bit select (common.select_bit) -- O(W + 5) steps
    # instead of an S-step bit sweep (S reaches 50-60 on the
    # static/multi variants' safety-factor slot depths).
    counts = [
        jax.lax.population_count(w).astype(ranks.dtype) for w in cand_words
    ]
    n_empty = counts[0]
    for c in counts[1:]:
        n_empty = n_empty + c
    sel_w = cand_words[0]
    rem = ranks
    base = jnp.zeros_like(ranks)
    cum = counts[0]
    for wi in range(1, len(cand_words)):
        go = ranks >= cum
        sel_w = jnp.where(go, cand_words[wi], sel_w)
        rem = jnp.where(go, ranks - cum, rem)
        base = jnp.where(go, wi * 32, base)
        cum = cum + counts[wi]
    from .common import select_bit

    lane = select_bit(sel_w, rem)
    slot = jnp.where(ranks < n_empty, base + lane, S)
    return slot, n_empty


def _allocate_from_flags(flags, cell, ranks, valid, S, V):
    """:func:`allocate_slots` on a bare flags plane (``[S, V]`` or flat
    ``[S*V]``) -- lets switch branches take only the plane they read."""
    in_bounds = valid & (cell < V)
    safe_cell = jnp.clip(cell, 0, V - 1)
    slot, n_empty = empty_slot_lookup(flags, safe_cell, ranks, slots=S)
    keep = in_bounds & (ranks < n_empty)
    flat = jnp.where(keep, slot * V + safe_cell, S * V)
    return flat, keep


def allocate_slots(particles, cell, ranks, valid, cfg=None):
    """Final flat pool position per candidate (``S*V`` sentinel when the
    voxel is full or the candidate invalid).  Returns ``(flat, keep)``.
    ``cfg`` is required when the pool is in its flat mid-frame form."""
    S, V = pool_sv(particles.flags, cfg)
    return _allocate_from_flags(particles.flags, cell, ranks, valid, S, V)


def scatter_candidates(
    particles, flat, payload_cols, flag, t, compact_to: int | None = None,
    cfg=None, defer_payload: bool = False, extra=None, flag_extra=None,
):
    """Write candidate payloads at their allocated flat positions.

    ``payload_cols`` is a tuple ``(px, py, pz, vx, vy, vz, weight)`` of [M]
    arrays in the caller's candidate order (never permuted here).

    ``flag`` may be a scalar or a per-candidate [M] array (e.g. movers
    killed by pyramid overflow write 0 directly).  ``flag_extra =
    (idx, vals)`` concatenates additional rows into the flags scatter only
    -- merging an adjacent flags-plane write (the rebin kill scatter) into
    this site's, which saves one plane write per frame.  Callers
    guarantee the merged index sets are disjoint.

    Huge-pool scatter merging (see ``_DEFER_PAYLOAD_BYTES``):
    ``defer_payload=True`` scatters only ``flags`` and ``weight`` (read
    downstream: slot allocation reads flags, the measurement writeback
    reads/writes weight) and returns ``(particles, pending)`` where
    ``pending = (flat, cols[0:6])``; the birth-site call passes it back as
    ``extra`` and the six pos/vel (+t) plane scatters run ONCE at the
    concatenated width.  Slot sets are disjoint by construction (birth's
    allocation sees the deferred slots' flags already set).  Birth's DS
    classification reads the velocity planes in between and applies an
    [M]-sized correction (ops/birth.py).
    """
    S, V = pool_sv(particles.flags, cfg)
    keep = flat < S * V

    def flags_scatter(flags_plane, s_flat):
        vals = jnp.broadcast_to(jnp.asarray(flag, jnp.int32), s_flat.shape)
        if flag_extra is not None:
            s_flat = jnp.concatenate([s_flat, flag_extra[0]])
            vals = jnp.concatenate([vals, flag_extra[1]])
        return pool_put(flags_plane, s_flat, vals)

    def scatter_all(particles, s_flat, cols, extra=extra):
        # (row, col) scatters into the native [S, V] layout (pool_put).
        if extra is not None:
            e_flat, e_cols = extra
            pv_flat = jnp.concatenate([s_flat, e_flat])
            pv_cols = [jnp.concatenate([cols[k], e_cols[k]])
                       for k in range(6)]
        else:
            pv_flat = s_flat
            pv_cols = list(cols[:6])

        def scat(field, vals):
            return pool_put(field, pv_flat, vals)

        flags = flags_scatter(particles.flags, s_flat)
        # t is write-only state (cfg.record_particle_time); callers pass
        # t=None to skip the plane scatter entirely.
        tt = particles.t if t is None else pool_put(
            particles.t, pv_flat,
            jnp.broadcast_to(jnp.float32(t), pv_flat.shape))
        return dataclasses.replace(
            particles,
            flags=flags,
            px=scat(particles.px, pv_cols[0]),
            py=scat(particles.py, pv_cols[1]),
            pz=scat(particles.pz, pv_cols[2]),
            vx=scat(particles.vx, pv_cols[3]),
            vy=scat(particles.vy, pv_cols[4]),
            vz=scat(particles.vz, pv_cols[5]),
            weight=pool_put(particles.weight, s_flat, cols[6]),
            t=tt,
        )

    if defer_payload:
        assert compact_to is None and extra is None
        flags = flags_scatter(particles.flags, flat)
        weight = pool_put(particles.weight, flat, payload_cols[6])
        new = dataclasses.replace(particles, flags=flags, weight=weight)
        return new, (flat, tuple(payload_cols[:6]))

    if compact_to is not None and compact_to < flat.shape[0]:
        # per-candidate flag arrays / merged kill rows don't compose with
        # the compacted re-indexing below; no caller needs both
        assert flag_extra is None and jnp.ndim(flag) == 0
        # Bucket specialization: compacted scatter when survivors fit the
        # budget (steady state), full scatter otherwise (burst frames).
        c_idx, c_valid, _, n_over = compact_mask(keep, compact_to)

        def small(particles):
            s_flat = jnp.where(c_valid, flat[c_idx], S * V)
            return scatter_all(
                particles, s_flat, tuple(c[c_idx] for c in payload_cols)
            )

        def big(particles):
            return scatter_all(particles, flat, payload_cols)

        return jax.lax.cond(n_over == 0, small, big, particles)
    return scatter_all(particles, flat, payload_cols)


def insert_sorted(
    particles,
    cfg: MapConfig,
    *,
    cell: jnp.ndarray,  # [M] destination storage cell, sorted; >= V invalid
    ranks: jnp.ndarray,  # [M] arrival rank within destination
    payload: jnp.ndarray,  # [M, 7] px,py,pz,vx,vy,vz,weight
    valid: jnp.ndarray,  # [M]
    flag,
    t,
    compact_to: int | None = None,
):
    """Insert destination-sorted candidates.

    Returns ``(new_pool, flat, keep)`` where ``flat`` is each candidate's
    final flat pool position (``S*V`` sentinel when dropped) and ``keep``
    the insertion mask.
    """
    flat, keep = allocate_slots(particles, cell, ranks, valid, cfg=cfg)
    cols = tuple(payload[:, i] for i in range(7))
    new = scatter_candidates(particles, flat, cols, flag, t, compact_to,
                             cfg=cfg)
    return new, flat, keep


def insert_particles(
    particles,
    cfg: MapConfig,
    *,
    pos: jnp.ndarray,  # [M, 3] world positions
    vel: jnp.ndarray,  # [M, 3]
    weight: jnp.ndarray,  # [M]
    valid: jnp.ndarray,  # [M] bool
    origin: jnp.ndarray,  # [3] window origin (world-voxel coords)
    flag,
    t,
    compact_to: int | None = None,
    cell_base=0,
    extra=None,
):
    """Insert unsorted candidates (ranks via a destination argsort).

    Candidates outside the map window are dropped (the reference's
    ``getParticleVoxelsIndex`` failure path, dsp_dynamic.h:875,1062-1074).

    ``cell_base`` (shard_map fast path): global storage cell of pool column
    0; candidates whose destination falls outside this shard's slab are
    dropped here and inserted by their owner shard instead.

    With ``compact_to``, candidates whose within-voxel arrival rank is
    ``>= S`` (they can NEVER insert -- the voxel has only S slots,
    dsp_dynamic.h:1198-1200) are dropped *before* allocation and the
    survivors compacted to the budget, so the empty-slot lookup, the payload
    gather (one stacked row gather) and the nine pool scatters all run at
    budget size instead of M.  When the eligible set overflows the budget
    (burst frames), a ``lax.cond`` falls back to the exact full-size path.
    """
    M = pos.shape[0]
    S, V = pool_sv(particles.flags, cfg)
    wv = geometry.world_voxel(pos, cfg)
    inside = geometry.in_window(wv, origin, cfg)
    dest = geometry.storage_index(wv, cfg) - cell_base
    valid = valid & inside & (dest >= 0) & (dest < V)

    order, sorted_dest, ranks_sorted = sort_by_destination(dest, valid)
    cols = (pos[:, 0], pos[:, 1], pos[:, 2], vel[:, 0], vel[:, 1], vel[:, 2],
            weight)
    payload = jnp.concatenate([pos, vel, weight[:, None]], axis=1)  # [M, 7]

    if compact_to is not None and compact_to < M:
        eligible = (sorted_dest < I32_MAX) & (ranks_sorted < S)
        c_pos, c_valid, n_elig, n_over = compact_mask(eligible, compact_to)

        def small(sz):
            # One window-2 gather fetches (clamped dest, source index) per
            # compacted position; one 7-wide contiguous row gather fetches
            # the whole payload -- replacing five budget-sized gathers
            # (same per-row economics as common.pool_take_stacked; both
            # int lanes ride as exact f32 values < 2^24).
            def branch(particles):
                dest_v = jnp.minimum(sorted_dest, V).astype(jnp.float32)
                pair = jnp.stack([dest_v, order.astype(jnp.float32)])
                got = jax.lax.gather(
                    pair, c_pos[:sz, None],
                    jax.lax.GatherDimensionNumbers(
                        offset_dims=(1,), collapsed_slice_dims=(1,),
                        start_index_map=(1,)),
                    slice_sizes=(2, 1),
                    mode=jax.lax.GatherScatterMode.CLIP,
                )  # [sz, 2]
                cell_c = jnp.where(c_valid[:sz],
                                   got[:, 0].astype(jnp.int32), V)
                src = got[:, 1].astype(jnp.int32)
                # compaction preserves sorted run order and keeps exactly
                # the first min(S, count) of each run, so ranks recompute
                # exactly from the compacted keys -- one fewer budget-sized
                # gather
                ranks_c = group_ranks(cell_c)
                flat_c, _ = allocate_slots(particles, cell_c, ranks_c,
                                           c_valid[:sz], cfg=cfg)
                pay_c = payload[src]  # [sz, 7] contiguous rows
                cols_c = tuple(pay_c[:, i] for i in range(7))
                return scatter_candidates(
                    particles, flat_c, cols_c, flag, t, None, cfg=cfg,
                    extra=extra,
                )
            return branch

        def big(particles):
            ranks = (
                jnp.zeros((M,), jnp.int32).at[order].set(
                    ranks_sorted, unique_indices=True
                )
            )
            flat, _ = allocate_slots(
                particles, jnp.where(valid, dest, V), ranks, valid, cfg=cfg
            )
            return scatter_candidates(particles, flat, cols, flag, t, None,
                                      cfg=cfg, extra=extra)

        # Prefix-bucket specialization: compaction packs the eligible set
        # into a prefix, so every budget-sized stage -- the payload
        # gathers, the empty-slot rank selection, and the 8-9 pool-plane
        # scatters (which pay per index row, dropped sentinels included)
        # -- runs at the smallest power-of-two bucket that holds the
        # realized eligible count instead of the full budget.  Burst
        # frames overflow to the exact full-size path.
        sizes = [compact_to]
        while sizes[0] > 4096:
            sizes.insert(0, sizes[0] // 2)
        case = jnp.searchsorted(jnp.asarray(sizes, jnp.int32), n_elig)
        case = jnp.where(n_over > 0, len(sizes), case)
        return jax.lax.switch(case, [small(s) for s in sizes] + [big],
                              particles)

    ranks = (
        jnp.zeros((M,), jnp.int32).at[order].set(ranks_sorted,
                                                 unique_indices=True)
    )
    flat, keep = allocate_slots(
        particles, jnp.where(valid, dest, V), ranks, valid, cfg=cfg
    )
    return scatter_candidates(particles, flat, cols, flag, t, compact_to,
                              cfg=cfg, extra=extra)
