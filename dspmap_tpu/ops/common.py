"""Fixed-shape building blocks: masked compaction and within-group ranking.

These primitives replace the reference's serial slot scans
(``include/dsp_dynamic.h:1183-1259``).  Masked compaction is expressed
through a u32 bitmask hierarchy -- one bandwidth-bound pack reduce +
``population_count`` prefix, then capacity-sized lookups (see
:func:`compact_mask`) -- so that no pool-sized scatter, sort or
``searchsorted`` runs per frame.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

I32_MAX = jnp.int32(2**31 - 1)


def pool_sv(plane: jnp.ndarray, cfg) -> tuple[int, int]:
    """``(S, V)`` of a pool plane in either the 2-D ``[S, V]`` or the flat
    ``[S*V]`` mid-frame form (``state.flatten_pool``).  ``V`` is derived
    from the plane size so sharded slabs (``V_local < storage_voxels``)
    resolve correctly."""
    if plane.ndim == 2:
        return plane.shape
    s = cfg.slots_per_voxel
    return s, plane.shape[0] // s


class ShardCtx(NamedTuple):
    """Map-axis SPMD context for the hand-scheduled ``shard_map`` fast path
    (SURVEY.md section 2.6/7.1.7; the reference has no distributed machinery).

    Inside ``shard_map`` every ``[S, V]``/``[V, ...]`` operand is this
    shard's contiguous slab of the storage grid; ``lo`` is the slab's first
    global storage cell, so ``global_cell - lo`` is the local column and
    ownership is ``0 <= global_cell - lo < V_local``.
    """

    axis: str  #: mesh axis name (collectives run over it)
    n_shards: int  #: static mesh size
    lo: jnp.ndarray  #: i32 global cell offset of this shard's slab

    def owns(self, cell: jnp.ndarray, v_local: int) -> jnp.ndarray:
        local = cell - self.lo
        return (local >= 0) & (local < v_local)

    def gather_flat(self, x: jnp.ndarray) -> jnp.ndarray:
        """``all_gather`` a per-shard buffer and flatten the shard axis
        (shard-major order -- the documented cross-shard arrival order)."""
        g = jax.lax.all_gather(x, self.axis)
        return g.reshape((-1,) + x.shape[1:])

    def gather_ring(self, x: jnp.ndarray, hops: int = 1) -> jnp.ndarray:
        """Neighbor exchange over the ring instead of the full all_gather:
        concatenate this shard's buffer with its ``hops`` nearest neighbors'
        in each direction (``ppermute``; SURVEY.md section 7.1.7's neighbor
        exchange).  Valid for per-frame movers because slabs are contiguous
        z-ranges of the z-major storage index (geometry.storage_index_planar)
        and the toroidal z-wrap maps onto the ring wrap -- one frame of
        self-motion crosses at most a few z-rows.  Movers whose destination
        slab is further than ``hops`` away are NOT delivered; the caller
        counts them as overflow kills (drop-on-full semantics).

        Traffic: ``2*hops`` buffers vs the all_gather's ``n_shards - 1``.
        """
        n = self.n_shards
        parts = [x]
        for h in range(1, min(hops, (n - 1) // 2) + 1):
            for sign in (1, -1):
                perm = [(i, (i + sign * h) % n) for i in range(n)]
                parts.append(jax.lax.ppermute(x, self.axis, perm))
        return jnp.concatenate(parts, axis=0)

    def ring_reachable(self, cell: jnp.ndarray, v_local: int,
                       hops: int) -> jnp.ndarray:
        """True where a global destination ``cell`` lies within ``hops``
        slabs of this shard's slab on the ring."""
        n = self.n_shards
        d = (cell // v_local - self.lo // v_local) % n
        return jnp.minimum(d, n - d) <= min(hops, (n - 1) // 2)


def pool_take(plane: jnp.ndarray, flat: jnp.ndarray) -> jnp.ndarray:
    """Gather flat pool positions from a 2D ``[S, V]`` plane by (row, col)
    pair instead of ``plane.ravel()[flat]``.  Out-of-range ``flat`` (the
    ``S*V`` sentinel) clamps, matching flat-gather semantics.

    1-D planes (the mid-frame FLAT pool representation, see
    ``state.flatten_pool``) gather directly."""
    if plane.ndim == 1:
        return plane[jnp.minimum(flat, plane.shape[0] - 1)]
    V = plane.shape[-1]
    return plane[flat // V, flat % V]


def pool_take_stacked(planes, flat: jnp.ndarray):
    """Gather the same flat pool positions from F ``[S, V]`` planes with ONE
    window gather over a ``[F, S, V]`` stack: each index fetches an
    ``(F, 1, 1)`` window, so the per-row index processing is paid once for
    all F fields.  The stack itself is F contiguous plane copies.
    Out-of-range ``flat`` clamps (CLIP), matching :func:`pool_take`.
    Returns one column per input plane, in order.

    No sorted-indices hint: compaction buffers carry garbage (possibly
    non-monotonic) index values in their invalid tail, and a violated
    ``indices_are_sorted`` would let the gather return wrong rows for VALID
    entries.

    Integer lanes ride as exact f32 VALUES (``astype``), not bitcasts:
    small-integer bit patterns are f32 denormals, which a device may flush
    to zero.  Exactness requires ``|v| < 2**24``; every pool integer here
    (tags < 2^17, cells < 2^23, flat slots <= S*V < 2^22) qualifies.

    Truly huge plane sets (>= 256 MB stacked) fall back to independent
    pair gathers: the F-plane stack copy scales with the POOL (e.g. 1 GB
    at large_urban), dwarfing the per-row gather saving.
    """
    if planes[0].ndim == 1:
        # FLAT pool planes: one [F, S*V] stack + (F, 1) window gather.
        n = planes[0].shape[0]
        if n * 4 * len(planes) >= (256 << 20) or flat.shape[0] < 16384:
            # Opt-outs: the stack copy scales with the POOL, so it cannot
            # pay off when the pool is huge (~1 GB at large_urban) or the
            # row count is small (below ~16k rows F separate 1-D gathers
            # move fewer bytes than a plane-sized stack).
            return [pool_take(p, jnp.clip(flat, 0, n - 1)) for p in planes]
        f32 = [
            p if p.dtype == jnp.float32 else p.astype(jnp.float32)
            for p in planes
        ]
        st = jnp.stack(f32)  # [F, S*V]
        safe = jnp.clip(flat, 0, n - 1)
        out = jax.lax.gather(
            st,
            safe[:, None],
            jax.lax.GatherDimensionNumbers(
                offset_dims=(1,),
                collapsed_slice_dims=(1,),
                start_index_map=(1,),
            ),
            slice_sizes=(len(planes), 1),
            mode=jax.lax.GatherScatterMode.PROMISE_IN_BOUNDS,
        )  # [N, F]
        cols = []
        for i, p in enumerate(planes):
            c = out[:, i]
            if p.dtype != jnp.float32:
                c = c.astype(p.dtype)
            cols.append(c)
        return cols
    V = planes[0].shape[-1]
    S = planes[0].shape[0]
    if planes[0].ndim == 2 and S * V * 4 * len(planes) >= (256 << 20):
        return [pool_take(p, jnp.clip(flat, 0, S * V - 1)) for p in planes]
    f32 = [
        p if p.dtype == jnp.float32 else p.astype(jnp.float32)
        for p in planes
    ]
    st = jnp.stack(f32)  # [F, S, V]
    safe = jnp.clip(flat, 0, S * V - 1)
    ids = jnp.stack([safe // V, safe % V], axis=1)
    out = jax.lax.gather(
        st,
        ids,
        jax.lax.GatherDimensionNumbers(
            offset_dims=(1,),
            collapsed_slice_dims=(1, 2),
            start_index_map=(1, 2),
        ),
        slice_sizes=(len(planes), 1, 1),
        mode=jax.lax.GatherScatterMode.PROMISE_IN_BOUNDS,
    )  # [N, F]
    cols = []
    for i, p in enumerate(planes):
        c = out[:, i]
        if p.dtype != jnp.float32:
            c = c.astype(p.dtype)
        cols.append(c)
    return cols


def pool_put(plane: jnp.ndarray, flat: jnp.ndarray, vals) -> jnp.ndarray:
    """Scatter ``vals`` at flat pool positions of a 2D ``[S, V]`` plane by
    (row, col) pair; drops out-of-range rows (the ``S*V`` drop sentinel).
    Avoids a ravel-scatter-reshape relayout pair.

    1-D planes (mid-frame FLAT pool, ``state.flatten_pool``) scatter
    natively -- no relayout exists on either side, which is the point of
    the flat mid-frame representation."""
    if plane.ndim == 1:
        return plane.at[flat].set(vals, mode="drop", unique_indices=True)
    V = plane.shape[-1]
    return plane.at[flat // V, flat % V].set(
        vals, mode="drop", unique_indices=True
    )


def select_bit(w: jnp.ndarray, off: jnp.ndarray) -> jnp.ndarray:
    """Position of the ``off``-th set bit of each u32 in ``w`` (garbage when
    ``off >= popcount(w)`` -- callers mask).  Binary search by half-word
    population counts: 5 popcount+select steps instead of a 32-step bit
    sweep."""
    lane = jnp.zeros_like(off)
    rem = off
    for half in (16, 8, 4, 2, 1):
        low = jnp.uint32((1 << half) - 1)
        cnt = jax.lax.population_count(w & low).astype(rem.dtype)
        hi = rem >= cnt
        lane = lane + jnp.where(hi, half, 0)
        rem = rem - jnp.where(hi, cnt, 0)
        w = jnp.where(hi, w >> jnp.uint32(half), w)
    return lane


def compact_mask(mask: jnp.ndarray, capacity: int):
    """Compact the True positions of a flat boolean ``mask`` into a fixed-size
    index buffer (first-to-last order).

    Returns ``(indices[capacity], valid[capacity], n_selected, n_overflow)``.
    True elements beyond ``capacity`` are counted in ``n_overflow`` (the
    caller decides whether overflow means "drop" or "kill", mirroring the
    reference's drop-on-full semantics, dsp_dynamic.h:1198-1200).

    Implementation (bitmask hierarchy): pack the mask into u32 words (one
    bandwidth-bound reduce), per-word counts via ``population_count``,
    locate each output position's source word from the count prefix, then
    two ``capacity``-sized gathers and a 5-step in-register bit-select.
    """
    mask = mask.ravel()
    n = mask.size
    W = 32
    pad = (-n) % W
    if pad:
        mask = jnp.concatenate([mask, jnp.zeros((pad,), mask.dtype)])
    bits = mask.reshape(-1, W)
    n_words = bits.shape[0]
    # Pack by a [Nw, 32] x [32, 2] f32 matmul: both 16-bit halves in one
    # product (each half < 2^16, exact in f32).  Default precision is exact
    # here even where it means TF32: the operands are 0/1 and powers of two
    # <= 2^15, which TF32 holds exactly, and the products accumulate in f32.
    wcols = np.zeros((W, 2), np.float32)
    wcols[:16, 0] = (1 << np.arange(16)).astype(np.float32)
    wcols[16:, 1] = (1 << np.arange(16)).astype(np.float32)
    halves = jnp.dot(
        bits.astype(jnp.float32), jnp.asarray(wcols),
        preferred_element_type=jnp.float32,
    )  # [Nw, 2]
    words = halves[:, 0].astype(jnp.uint32) | (
        halves[:, 1].astype(jnp.uint32) << 16
    )
    counts = jax.lax.population_count(words).astype(jnp.int32)

    out_pos = jnp.arange(capacity, dtype=jnp.int32)
    B = 32
    if n_words <= 8192:
        # Output position -> source word via scatter + forward fill: each
        # nonempty word scatters its index at its output start, cummax fills
        # the runs.  Cost scales with n_words.
        ends = jnp.cumsum(counts)
        n_selected = ends[-1]
        starts = ends - counts
        word_of = jnp.zeros((capacity,), jnp.int32).at[
            jnp.where(counts > 0, starts, capacity)
        ].max(
            jnp.arange(n_words, dtype=jnp.int32), mode="drop",
            unique_indices=True,
        )
        word_of = jax.lax.cummax(word_of)
        off = out_pos - starts[word_of]
    else:
        # Two-level hierarchy for pool-sized masks: the flat scatter above
        # scales with the word count, so words are grouped into 32-word
        # blocks and only n_blocks entries are scattered; the word within
        # the block is then found from the block's count row by a
        # strictly-lower-triangular prefix matmul + a masked max (prefix is
        # non-decreasing, so the largest masked prefix IS the selected
        # word's start) -- replacing a 32-step scalar scan over the row.
        bpad = (-n_words) % B
        counts2 = (jnp.concatenate([counts, jnp.zeros((bpad,), jnp.int32)])
                   if bpad else counts).reshape(-1, B)
        n_blocks = counts2.shape[0]
        block_counts = jnp.sum(counts2, axis=1)
        block_ends = jnp.cumsum(block_counts)
        n_selected = block_ends[-1]
        block_starts = block_ends - block_counts
        block_of = jnp.zeros((capacity,), jnp.int32).at[
            jnp.where(block_counts > 0, block_starts, capacity)
        ].max(
            jnp.arange(n_blocks, dtype=jnp.int32), mode="drop",
            unique_indices=True,
        )
        block_of = jax.lax.cummax(block_of)
        off_blk = out_pos - block_starts[block_of]
        crow = counts2[block_of]  # [capacity, B] native row gather
        # word within block: largest w with pref[w] = sum(crow[:w]) <= off_blk
        # (counts <= 32 and block sums <= 1024: exact in f32, and exact in
        # TF32 too, so default precision cannot round them)
        tri = jnp.asarray(np.triu(np.ones((B, B), np.float32), k=1))
        pref = jnp.dot(crow.astype(jnp.float32), tri,
                       preferred_element_type=jnp.float32)  # [capacity, B]
        le = pref <= off_blk[:, None].astype(jnp.float32)
        win = jnp.sum(le, axis=1).astype(jnp.int32) - 1
        off = off_blk - jnp.max(
            jnp.where(le, pref, 0.0), axis=1
        ).astype(jnp.int32)
        word_of = jnp.minimum(block_of * B + win, n_words - 1)
    w = words[word_of]
    lane = select_bit(w, off)
    indices = word_of * W + lane

    valid = out_pos < n_selected
    n_kept = jnp.minimum(n_selected, capacity)
    return (
        jnp.where(valid, indices, 0),
        valid,
        n_kept,
        n_selected - n_kept,
    )


def compact_and_group(mask: jnp.ndarray, group: jnp.ndarray, capacity: int,
                      n_groups: int):
    """Fused compaction + stable grouping: select ``mask`` positions and order
    them by ``group`` id (stable within a group).

    Returns ``(indices[capacity], group_ids[capacity], ranks[capacity],
    valid[capacity], n_selected)`` where ``ranks`` is each entry's arrival
    rank within its group and invalid entries carry group id ``n_groups``.

    Hierarchical compaction (see :func:`compact_mask`) followed by a small
    stable sort of the compacted entries by group id.
    """
    c_idx, c_valid, n_kept, n_over = compact_mask(mask, capacity)
    g = jnp.where(c_valid, pool_take(group, c_idx).astype(jnp.int32),
                  n_groups)
    sorted_group, indices = jax.lax.sort((g, c_idx), is_stable=True,
                                         num_keys=1)
    valid = sorted_group < n_groups
    ranks = group_ranks(sorted_group)
    return indices, sorted_group, ranks, valid, n_kept + n_over


def group_ranks(sorted_keys: jnp.ndarray) -> jnp.ndarray:
    """Rank of each element within its run of equal keys (keys must be sorted).

    ``rank[i] = i - start_of_run(i)``; run starts are found by comparing
    neighbors and propagated with a cumulative max -- one scan, no
    searchsorted.
    """
    n = sorted_keys.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_keys[1:] != sorted_keys[:-1]]
    )
    run_start = jax.lax.cummax(jnp.where(is_start, idx, 0))
    return idx - run_start


def sort_by_destination(dest: jnp.ndarray, valid: jnp.ndarray):
    """Stable-sort candidate indices by destination id, invalid entries last.

    Returns ``(order, sorted_dest, ranks)``; ``sorted_dest`` has invalid
    entries replaced by ``INT32_MAX`` sentinels and ``ranks`` is the
    within-destination arrival rank (stable = original candidate order,
    matching the reference's first-come slot filling).
    """
    keys = jnp.where(valid, dest, I32_MAX)
    # One multi-operand stable sort carries the permutation alongside the
    # keys -- the earlier argsort + ``keys[order]`` formulation paid a
    # capacity-sized random gather just to read the sorted keys back out.
    iota = jnp.arange(keys.shape[0], dtype=jnp.int32)
    sorted_dest, order = jax.lax.sort((keys, iota), is_stable=True,
                                      num_keys=1)
    ranks = group_ranks(sorted_dest)
    return order, sorted_dest, ranks


def segment_counts(ids: jnp.ndarray, valid: jnp.ndarray, num_segments: int) -> jnp.ndarray:
    """Count of valid entries per segment id (scatter-add of ones)."""
    safe = jnp.where(valid, ids, num_segments)
    return (
        jnp.zeros((num_segments + 1,), jnp.int32)
        .at[safe]
        .add(1, mode="drop")[:num_segments]
    )


def select_rows(table: jnp.ndarray, row_idx: jnp.ndarray, n_rows: int):
    """``out[...] = table[row_idx[...], ...]`` for a *small* leading axis.

    An ``n_rows``-step select sweep instead of a per-element gather: a
    dense elementwise pass per row, which XLA fuses into one loop.
    """
    extra = table.ndim - row_idx.ndim
    if extra > 0:
        row_idx = row_idx.reshape(row_idx.shape + (1,) * extra)
    out = jnp.where(row_idx == 0, table[0], jnp.zeros((), table.dtype))
    for j in range(1, n_rows):
        out = jnp.where(row_idx == j, table[j], out)
    return out
