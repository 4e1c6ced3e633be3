"""Pallas kernel (Triton route) for the occupancy/cull/aggregate/resample
pool pass (``mapOccupancyCalculationAndResample``, dsp_dynamic.h:924-1057).

The pass is column-wise over voxels: every per-voxel quantity depends only
on that voxel's ``S`` slots.  One program handles a block of ``L`` voxels
and walks the slot rows in order, carrying the per-voxel sums and prefix
sums in registers, so the pool is read about once and written once:

1. aggregates: cull, weight sum, old/moving counts, velocity sums, static
   contribution, the per-voxel stats counters;
2. demand: the systematic-resampling copy counts and their running total
   ``demand_end`` per slot, written to a scratch plane;
3. placement: each free slot of rank ``r`` takes a copy of the particle
   ``j`` with ``demand_end[j-1] <= r < demand_end[j]``, found by a binary
   search over the scratch rows, and the payload is gathered from the
   source row (L1/L2-resident by then).

The math is that of ``ops/occupancy._pool_pass_xla``, summed in the same
slot order, so the two agree element for element (tests/test_pallas.py in
interpret mode; the chip smoke test on the GPU).  The future-status scatter
and the frame stats stay outside (they need global gathers/scatters).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ...config import MapConfig

#: voxels per program and warps per program: one or two voxels per thread
#: keeps enough threads in flight to hide the row loads' latency
BLOCK = 256
NUM_WARPS = 4


def _n_vel(cfg: MapConfig) -> int:
    """Velocity planes the kernel reads.  Planes the pipeline's clamp
    invariant makes identically zero (vz under limit-xy,
    dsp_dynamic.h:661-663; all three in the static model,
    dsp_static.h:640-646) are left out; the wrapper substitutes the
    particles' own planes and zero sums."""
    if cfg.motion_model == "static":
        return 0
    return 2 if cfg.limit_motion_to_xy_plane else 3


def _kernel(*refs, cfg: MapConfig, S: int, V: int, L: int, n_vel: int,
            with_t: bool, with_moving: bool):
    n_fields = 3 + n_vel + with_t  # px, py, pz, velocities, [t]
    flags_ref, w_ref = refs[0], refs[1]
    field_refs = refs[2:2 + n_fields]
    vel_refs = field_refs[3:3 + n_vel]
    outs = refs[2 + n_fields:]
    oflags_ref, ow_ref = outs[0], outs[1]
    ofield_refs = outs[2:2 + n_fields]
    k = 2 + n_fields
    omoving_ref = outs[k] if with_moving else None
    k += with_moving
    de_ref = outs[k]
    ows_ref, onold_ref = outs[k + 1], outs[k + 2]
    ovs_refs = outs[k + 3:k + 3 + n_vel]
    (ostatic_ref, onvalid_ref, onculled_ref, odors_ref, ondropped_ref,
     onfilled_ref) = outs[k + 3 + n_vel:]

    cols = pl.program_id(0) * L + jnp.arange(L, dtype=jnp.int32)
    m = cols < V
    thr = cfg.weight_cull_threshold

    def ld(ref, s):
        return plgpu.load(ref.at[s, cols], mask=m, other=0)

    def st(ref, s, x):
        plgpu.store(ref.at[s, cols], x, mask=m)

    def slot_state(s):
        f = ld(flags_ref, s)
        w = ld(w_ref, s)
        cull = (f != 0) & (w < thr)
        valid = (f != 0) & ~cull
        return f, w, cull, valid

    zf = jnp.zeros((L,), jnp.float32)

    # ---- 1. aggregates ---------------------------------------------------
    def agg_row(s, c):
        ws, n_old, static, count, n_cull, vs = c
        f, w, cull, valid = slot_state(s)
        old = valid & (f != 3)
        vels = [ld(r, s) for r in vel_refs]
        moving = jnp.zeros((L,), jnp.bool_)
        for v in vels:
            moving = moving | (v != 0.0)
        moving = old & moving
        if with_moving:
            st(omoving_ref, s, moving.astype(jnp.int8))
        return (
            ws + jnp.where(valid, w, 0.0),
            n_old + jnp.where(old, 1.0, 0.0),
            static + jnp.where(old & ~moving, w, 0.0),
            count + jnp.where(valid, 1.0, 0.0),
            n_cull + jnp.where(cull, 1.0, 0.0),
            tuple(a + jnp.where(old, v, 0.0) for a, v in zip(vs, vels)),
        )

    ws, n_old, static, count, n_cull, vs = jax.lax.fori_loop(
        0, S, agg_row, (zf, zf, zf, zf, zf, (zf,) * n_vel)
    )

    def st_vec(ref, x):
        plgpu.store(ref.at[cols], x, mask=m)

    for ref, x in zip((ows_ref, onold_ref, ostatic_ref, onvalid_ref,
                       onculled_ref, *ovs_refs),
                      (ws, n_old, static, count, n_cull, *vs)):
        st_vec(ref, x)

    # ---- systematic resampling (dsp_dynamic.h:986-1055) ------------------
    do_rs = count >= cfg.resample_min_count
    st_vec(odors_ref, jnp.where(do_rs, 1.0, 0.0))
    n_target = jnp.minimum(count, float(cfg.max_particles_per_voxel))
    wa = jnp.where(do_rs, ws / jnp.maximum(n_target, 1.0), 1.0)

    def n_grid(x):  # grid points wa*(k+1/2) strictly below x
        return jnp.maximum(jnp.ceil(x / wa - 0.5), 0.0)

    def demand(s, hi):
        """Copy decision of slot ``s`` given the running weight prefix."""
        f, w, cull, valid = slot_state(s)
        wv = jnp.where(valid, w, 0.0)
        hi = hi + wv
        lo = hi - wv
        rs = valid & do_rs
        copies = jnp.where(rs, n_grid(hi) - n_grid(lo), 0.0)
        kept = rs & (copies >= 1.0)
        dropped = rs & (copies == 0.0)
        extra = jnp.maximum(copies - 1.0, 0.0).astype(jnp.int32)
        is_free = ~valid | dropped
        return f, w, cull, valid, hi, kept, dropped, extra, is_free

    # ---- 2. demand prefix per slot -> scratch plane ----------------------
    zi = jnp.zeros((L,), jnp.int32)

    def demand_row(s, c):
        hi, de, n_free = c
        *_, hi, _, _, extra, is_free = demand(s, hi)
        de = de + extra
        st(de_ref, s, de)
        return hi, de, n_free + is_free.astype(jnp.int32)

    # Blocks where no voxel resamples (most of a street-scene pool) skip
    # the demand pass: no slot gets a copy there.
    any_rs = jnp.max(jnp.where(m & do_rs, 1, 0)) > 0
    total_extra, total_free = jax.lax.cond(
        any_rs,
        lambda: jax.lax.fori_loop(0, S, demand_row, (zf, zi, zi))[1:],
        lambda: (zi, zi),
    )
    n_fill = jnp.minimum(total_extra, total_free)

    # ---- 3. placement ----------------------------------------------------
    steps = max(S, 1).bit_length()  # binary search over S+1 outcomes

    def place_row(s, c):
        hi, de, free_rank, n_drop, n_filled = c
        f, w, cull, valid, hi, kept, dropped, extra, is_free = demand(s, hi)
        filled = is_free & (free_rank < n_fill) & do_rs

        def copies_in():
            # source row: number of j with demand_end[j] <= free_rank
            lo_j, hi_j = zi, zi + S
            for _ in range(steps):
                mid = (lo_j + hi_j) >> 1
                live = m & filled & (lo_j < hi_j)
                d = plgpu.load(de_ref.at[jnp.minimum(mid, S - 1), cols],
                               mask=live, other=0)
                right = live & (d <= free_rank)
                lo_j = jnp.where(right, mid + 1, lo_j)
                hi_j = jnp.where(live & ~right, mid, hi_j)
            src = jnp.minimum(lo_j, S - 1)
            return tuple(plgpu.load(f_ref.at[src, cols], mask=m & filled,
                                    other=0.0) for f_ref in field_refs)

        # copies are rare: rows of a block with none skip the search
        cps = jax.lax.cond(jnp.max(jnp.where(filled, 1, 0)) > 0, copies_in,
                           lambda: (zf,) * n_fields)

        # fold-back for copies that found no space (dsp_dynamic.h:1037-1041)
        placed = jnp.clip(total_free - de, 0, extra)
        unplaced = (extra - placed).astype(jnp.float32)
        new_w = jnp.where(kept, wa * (1.0 + unplaced), w)
        new_w = jnp.where(filled, wa, new_w)
        new_f = jnp.where(valid, 1, jnp.where(cull, 0, f))
        new_f = jnp.where(dropped, 0, new_f)
        new_f = jnp.where(filled, 1, new_f)
        st(oflags_ref, s, new_f)
        st(ow_ref, s, new_w)
        for f_ref, o_ref, cp in zip(field_refs, ofield_refs, cps):
            st(o_ref, s, jnp.where(filled, cp, ld(f_ref, s)))
        return (
            hi,
            de + extra,
            free_rank + is_free.astype(jnp.int32),
            n_drop + jnp.where(dropped & ~filled, 1.0, 0.0),
            n_filled + jnp.where(filled & ~valid, 1.0, 0.0),
        )

    *_, n_drop, n_filled = jax.lax.fori_loop(
        0, S, place_row, (zf, zi, zi, zf, zf)
    )
    st_vec(ondropped_ref, n_drop)
    st_vec(onfilled_ref, n_filled)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "interpret", "with_moving", "block", "num_warps"),
)
def occupancy_pool_pass(particles, cfg: MapConfig, interpret: bool = False,
                        with_moving: bool = True, block: int = BLOCK,
                        num_warps: int = NUM_WARPS):
    """One-pass cull + aggregates + resample over the pool.

    Returns ``(new_fields dict, weight_sum[V], n_old[V], vel_sums[V,3],
    static_contrib[V], moving[S, V] | None, counters)`` where ``counters =
    (n_valid, n_culled, do_rs, n_dropped, n_filled)`` are per-voxel [V]
    stats vectors -- the caller (ops/occupancy.py) derives vel_avg, the
    future grids and the stats dict without re-reading the pool planes.
    ``with_moving=False`` leaves out the [S, V] moving mask (callers with a
    pre-compacted future-mover set never read it); the particle-time plane
    is carried only when ``cfg.record_particle_time``.  Exactness of the
    skipped velocity planes relies on the pipeline's clamp invariant
    (models/pipeline.py); direct callers must feed conforming pools.
    """
    S, V = particles.flags.shape
    L = block
    n_vel = _n_vel(cfg)
    with_t = bool(cfg.record_particle_time)
    fields = [particles.px, particles.py, particles.pz,
              *(particles.vx, particles.vy, particles.vz)[:n_vel]]
    if with_t:
        fields.append(particles.t)
    plane = lambda dt: jax.ShapeDtypeStruct((S, V), dt)
    vec = jax.ShapeDtypeStruct((V,), jnp.float32)
    out_shape = (
        [plane(jnp.int32), plane(jnp.float32)]
        + [plane(jnp.float32) for _ in fields]
        + ([plane(jnp.int8)] if with_moving else [])
        + [plane(jnp.int32)]  # demand_end scratch
        + [vec] * (8 + n_vel)  # ws, n_old, vel sums, static, 5 counters
    )
    outs = pl.pallas_call(
        functools.partial(_kernel, cfg=cfg, S=S, V=V, L=L, n_vel=n_vel,
                          with_t=with_t, with_moving=with_moving),
        grid=(pl.cdiv(V, L),),
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="occupancy_pool_pass",
    )(particles.flags, particles.weight, *fields)
    flags, w = outs[0], outs[1]
    new = list(outs[2:2 + len(fields)])
    k = 2 + len(fields)
    moving = (outs[k] != 0) if with_moving else None
    k += with_moving + 1  # skip the scratch plane
    ws, n_old = outs[k], outs[k + 1]
    vsums = list(outs[k + 2:k + 2 + n_vel])
    vsums += [jnp.zeros((V,), jnp.float32)] * (3 - n_vel)
    (static_contrib, n_valid, n_culled, do_rs,
     n_dropped, n_filled) = outs[k + 2 + n_vel:]
    vel = new[3:3 + n_vel] + [getattr(particles, n)
                              for n in ("vx", "vy", "vz")[n_vel:]]
    new_fields = dict(
        flags=flags, weight=w, px=new[0], py=new[1], pz=new[2],
        vx=vel[0], vy=vel[1], vz=vel[2],
        t=new[3 + n_vel] if with_t else particles.t,
    )
    counters = (n_valid, n_culled, do_rs, n_dropped, n_filled)
    return (new_fields, ws, n_old, tuple(vsums), static_contrib, moving,
            counters)
