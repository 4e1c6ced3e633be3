"""The fused per-slot sweep: prediction advance + window/rebin masks + FOV
pyramid geometry computed in one pass over the particle pool.

These are the three full-pool elementwise stages of the frame
(``mapPrediction``'s motion + bounds test, ``dsp_dynamic.h:653-690``, and the
pyramid membership of ``moveParticle``, ``:1232-1243``).  Computing them
together lets XLA fuse them into one read + one write of the pool.

Scope note: the fused path covers the ``limit_motion_to_xy_plane`` and
static-model configurations, where the reference's own noise quirk makes
prediction deterministic (see ops/propagate.py); the general noisy path keeps
the separate-stage implementation.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..config import MapConfig
from .. import geometry


class SweepOut(NamedTuple):
    px: jnp.ndarray  # advanced positions [S, V]
    py: jnp.ndarray
    pz: jnp.ndarray
    flags: jnp.ndarray  # u8: 0 where the particle left the window
    new_cell: jnp.ndarray  # i32 storage cell of the advanced position
    #: i32 pack of the five discrete per-slot outcomes:
    #: ``mover | fov<<1 | moving<<2 | moved_out<<3 | pyramid_cell<<4``,
    #: zero when no outcome bit is set.  One plane instead of five: the
    #: candidate gather touches a single pool plane and the bool planes
    #: never materialize in device memory -- every other consumer is a
    #: fused elementwise/reduction op on the properties below.
    tags: jnp.ndarray

    @property
    def mover(self) -> jnp.ndarray:  # bool: storage cell changed
        return (self.tags & 1) != 0

    @property
    def fov(self) -> jnp.ndarray:  # bool: valid & inside & in FOV
        return (self.tags & 2) != 0

    @property
    def moving(self) -> jnp.ndarray:
        #: valid & inside & nonzero velocity -- the future-status scatter's
        #: candidate superset (occupancy re-checks flags/newborn/cull at its
        #: own point in the frame; velocities cannot change in between on
        #: the fused-sweep configurations)
        return (self.tags & 4) != 0

    @property
    def moved_out(self) -> jnp.ndarray:  # bool: valid & left the window
        return (self.tags & 8) != 0

    @property
    def pyr(self) -> jnp.ndarray:  # i32 pyramid cell (clipped; 0 when dead)
        return self.tags >> 4

    @property
    def candidate(self) -> jnp.ndarray:  # bool: mover | fov | moving
        return (self.tags & 7) != 0


def sweep(
    particles, cfg: MapConfig, dt, origin, sensor_pos, quat, cell_base=0
) -> SweepOut:
    """Advance, bounds-test and pyramid-tag every slot of the pool.

    ``cell_base`` is the global storage cell of column 0 -- nonzero only
    inside the ``shard_map`` fast path, where the pool is a slab of the
    grid (``new_cell`` stays global either way)."""
    S, V = particles.flags.shape
    valid = particles.valid

    if cfg.motion_model == "static":
        px, py, pz = particles.px, particles.py, particles.pz
    else:
        px = jnp.where(valid, particles.px + particles.vx * dt, particles.px)
        py = jnp.where(valid, particles.py + particles.vy * dt, particles.py)
        pz = jnp.where(valid, particles.pz + particles.vz * dt, particles.pz)

    wx, wy, wz = geometry.world_voxel_planar(px, py, pz, cfg)
    rx, ry, rz = wx - origin[0], wy - origin[1], wz - origin[2]
    inside = (
        (rx >= 0) & (rx < cfg.nx)
        & (ry >= 0) & (ry < cfg.ny)
        & (rz >= 0) & (rz < cfg.nz)
    )
    moved_out = valid & ~inside
    flags = jnp.where(moved_out, jnp.int32(0), particles.flags)

    new_cell = geometry.storage_index_from_rel(rx, ry, rz, origin, cfg)
    current = jnp.broadcast_to(
        cell_base + jnp.arange(V, dtype=jnp.int32)[None, :], (S, V)
    )
    mover = valid & inside & (new_cell != current)

    Rm = geometry.rotation_matrix(geometry.quaternion_conjugate(quat))
    sx, sy, sz = geometry.rotate_planar(
        Rm, px - sensor_pos[0], py - sensor_pos[1], pz - sensor_pos[2]
    )
    pyr, in_fov = geometry.pyramid_index_planar(sx, sy, sz, cfg)
    fov = valid & inside & in_fov

    moving = (
        valid
        & inside
        & (
            (particles.vx != 0.0)
            | (particles.vy != 0.0)
            | (particles.vz != 0.0)
        )
    )
    packed = (
        mover.astype(jnp.int32)
        | (fov.astype(jnp.int32) << 1)
        | (moving.astype(jnp.int32) << 2)
        | (moved_out.astype(jnp.int32) << 3)
        | (pyr << 4)
    )
    tags = jnp.where(mover | fov | moving | moved_out, packed, 0)
    return SweepOut(px, py, pz, flags, new_cell, tags)
