"""Voxel reassignment after motion: move-or-vanish semantics of
``moveParticle`` / ``removeParticle`` (``include/dsp_dynamic.h:1206-1279,
686-690``) without the serial relocation pass.

In the world-frame toroidal layout a particle's storage cell only changes when
its *own* motion crosses a voxel face (bounded by v_max * dt per frame), so
the mover set is small.  Pipeline: (1) kill particles that left the map window
(``dsp_dynamic.h:686-690``); (2) identify movers (storage cell changed);
(3) compact + destination-sort the movers in ONE stable sort keyed by
(mover?, destination); (4) vacate their source slots; (5) re-insert with the
shared capacity-limited insertion, which reproduces the voxel-full vanish path
(``dsp_dynamic.h:1227-1229``).

Parallel-semantics deviation (documented): the reference relocates particles
one at a time in storage order, so a mover can occupy a slot another particle
vacates later in the same pass (or fail because a later vacancy has not
happened yet).  Here all movers vacate first, then fill -- same capacity
bound, same conservation, different tie-breaking when voxels are nearly full.
Movers beyond ``cfg.mover_capacity`` (a fixed-shape budget with no reference
analogue) are killed and counted.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..config import MapConfig
from .. import geometry
from .common import (
    compact_and_group, compact_mask, pool_take, pool_take_stacked,
    sort_by_destination,
)
from .insert import insert_sorted


def rebin(particles, cfg: MapConfig, origin: jnp.ndarray, t, shard=None):
    """Re-home particles whose world voxel changed; kill window leavers.

    Returns ``(new_particles, stats)`` with scalar counters (analogues of the
    reference's moves_out / voxel_full counters, dsp_dynamic.h:629-699).

    Shard_map fast path (``shard`` = :class:`~.common.ShardCtx`): the pool is
    this shard's slab and mover destinations are global, so the compacted
    mover buffer (payload + global destination) is ``all_gather``-exchanged
    over the map axis and each shard re-inserts the arrivals whose
    destination cell it owns -- the same exchange :func:`~.fov
    .rebin_and_register` performs on the fused-sweep path, here for the
    noisy-propagation (separate-pass) configurations.
    """
    S, V = particles.flags.shape
    m_cap = cfg.mover_capacity
    valid = particles.valid

    wx, wy, wz = geometry.world_voxel_planar(
        particles.px, particles.py, particles.pz, cfg
    )
    inside = geometry.in_window_planar(wx, wy, wz, origin, cfg) & valid
    moved_out = valid & ~inside

    new_cell = geometry.storage_index_planar(wx, wy, wz, cfg)  # [S, V] global
    cell_base = jnp.int32(0) if shard is None else shard.lo
    current_cell = cell_base + jnp.broadcast_to(
        jnp.arange(V, dtype=jnp.int32)[None, :], (S, V)
    )
    mover = inside & (new_cell != current_cell)

    # Vacate: movers and window leavers leave their source slots.
    flags = jnp.where(mover | moved_out, jnp.int32(0), particles.flags)
    vacated = dataclasses.replace(particles, flags=flags)

    if shard is None:
        idx, cell, ranks, sel_valid, n_movers = compact_and_group(
            mover, new_cell, m_cap, V
        )
        payload = jnp.stack(
            pool_take_stacked(
                [particles.px, particles.py, particles.pz,
                 particles.vx, particles.vy, particles.vz,
                 particles.weight], idx,
            ),
            axis=-1,
        )
        new_particles, _, ins_keep = insert_sorted(
            vacated, cfg,
            cell=cell, ranks=ranks, payload=payload, valid=sel_valid,
            flag=jnp.int32(1), t=t if cfg.record_particle_time else None,
        )
        n_kept = jnp.minimum(n_movers, m_cap)
        n_arrivals = n_kept
        over = n_movers - n_kept
    else:
        # Local compaction (unordered), then the cross-slab exchange.
        idx, ok, n_local, buf_over = compact_mask(mover, m_cap)
        cols = pool_take_stacked(
            [particles.px, particles.py, particles.pz,
             particles.vx, particles.vy, particles.vz,
             particles.weight], idx,
        )
        dest = jnp.where(ok, pool_take(new_cell, idx), jnp.int32(-1))
        if cfg.mover_exchange == "ring":
            reach = shard.ring_reachable(jnp.maximum(dest, 0), V,
                                         cfg.ring_hops)
            ring_undelivered = jnp.sum(ok & ~reach)
            ex = lambda x: shard.gather_ring(x, cfg.ring_hops)  # noqa: E731
        else:
            ring_undelivered = jnp.int32(0)
            ex = shard.gather_flat
        exchanged = jax.tree.map(ex, (dest, ok) + tuple(cols))
        a_dest, a_ok = exchanged[0], exchanged[1]
        a_cols = exchanged[2:]
        own = a_ok & shard.owns(a_dest, V)
        own_i, own_ok, n_own, own_over = compact_mask(own, m_cap)
        cell_local = jnp.where(own_ok, a_dest[own_i] - shard.lo, V)
        order, sorted_cell, ranks_sorted = sort_by_destination(
            cell_local, own_ok
        )
        payload = jnp.stack([c[own_i][order] for c in a_cols], axis=-1)
        new_particles, _, ins_keep = insert_sorted(
            vacated, cfg,
            cell=jnp.minimum(sorted_cell, V), ranks=ranks_sorted,
            payload=payload, valid=sorted_cell < V,
            flag=jnp.int32(1), t=t if cfg.record_particle_time else None,
        )
        n_kept = n_local
        n_arrivals = n_own
        over = buf_over + own_over + ring_undelivered

    stats = {
        "moved_out": jnp.sum(moved_out),
        "movers": n_kept,
        "mover_overflow_killed": over,
        # insertion keep mask counts the landed arrivals exactly -- not a
        # before/after pool-wide alive diff (two [S, V] reduces)
        "voxel_full_killed": n_arrivals - jnp.sum(ins_keep),
    }
    return new_particles, stats
