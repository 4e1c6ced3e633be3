"""SMC-PHD measurement update -- the hot kernel (``mapUpdate``,
``include/dsp_dynamic.h:704-793``).

Math (reference semantics):

* pass 1: for each measurement z binned in pyramid i,
  ``C(z) = sum_{x in nbhd(i)} P_d * w_x * g(z|x) + (E_birth + kappa)``
  (``dsp_dynamic.h:709-739``),
* pass 2: every non-occluded in-FOV particle gets
  ``w *= (1 - P_d) + sum_{z in nbhd} P_d * g(z|x) / C(z)``
  (``dsp_dynamic.h:768-787``); occluded particles (ego range beyond the
  pyramid's max measured range + slack) are skipped (``dsp_dynamic.h:759-765``)
  -- note pass 1 has no occlusion check, faithfully kept.

``g(z|x)`` is the product of three axis-wise lookups of the reference's
standard-normal table (``dsp_dynamic.h:1282-1301``).  Two reference quirks are
preserved because they scale the absolute magnitudes of C and the birth
normalizer: the normalization constant is ``1/sqrt(2*(pi/2)) = 1/sqrt(pi)``
(not ``1/sqrt(2*pi)``; ``dsp_dynamic.h:1284``) and there is no ``1/sigma``
factor (``dsp_dynamic.h:1294-1301``).  Two are consciously dropped (both are
O(1e-21) effects): the table's 0.001-sigma quantization and the +-9.9-sigma
clamp -- we evaluate the exponential exactly.

Formulation -- **two-tier on both axes**.  The reference's per-pyramid
capacities (462 particle slots, 100 obs points) are safety thresholds;
realized per-cell occupancy peaks ~20x lower (tools/occupancy_stats.py), so
dense tiles at full capacity would waste ~20x the pair work.  Each axis is
split at a dense-tier rank (``cfg.dense_slots`` / ``cfg.obs_dense``):

* dense x dense: per pyramid tile, the pair term ``|x - z|^2`` over the
  (2N+1)^2-cell neighborhood as shifted copies of the ``[H, W, Ko]``
  observation grid, formed from coordinate differences and summed in the
  same expression, so XLA fuses the pair tile into its reduction; chunked
  with ``lax.map`` only when the pair tensor would not fit comfortably;
* spill particles (rank >= dense tier, below the reference kill threshold)
  evaluate against their own cell's gathered neighborhood row and are
  reduced into the C grid by a one-hot matmul (a scatter-add here would
  need atomics);
* spill observations gather their neighborhood's dense particle tiles
  (contiguous row gathers) and push pass-2 contributions back into the
  dense factor tiles by one-hot matmul;
* spill x spill couples through a single adjacency-masked cross block.

All four blocks compute the identical g-sums -- the tiers are a processing
layout, not an approximation; ``tests/test_ops.py`` asserts tier-invariance
against a full-capacity single-tier configuration.

Precision: every f32 matmul here states ``Precision.HIGHEST``.  A
default-precision f32 dot may run in TF32 on the GPU (about three
significant digits), which would move the weights of every update.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp

from ..config import MapConfig
from .common import pool_put
from .fov import FovBinning
from .project import Observation

_HI = jax.lax.Precision.HIGHEST

#: reference standardNormalPDF constant: 1/sqrt(2 * (pi/2)) (dsp_dynamic.h:1284)
REF_PDF_CONST = 1.0 / math.sqrt(math.pi)


def _neighbor_offsets(cfg: MapConfig):
    n = cfg.pyramid_neighbor_radius
    return [(dh, dv) for dh in range(-n, n + 1) for dv in range(-n, n + 1)]


def gather_neighbors(x: jnp.ndarray, cfg: MapConfig, fill) -> jnp.ndarray:
    """``[n_pyr, K, ...] -> [n_pyr, C*K, ...]``: concatenated per-cell copies
    of the (2N+1)^2 neighboring cells' entries, grid-clipped (the reference's
    per-pyramid neighbor lists, dsp_dynamic.h:1128-1147, as shifts)."""
    H, W = cfg.n_pyramids_h, cfg.n_pyramids_v
    n = cfg.pyramid_neighbor_radius
    K = x.shape[1]
    trailing = x.shape[2:]
    xg = x.reshape((H, W, K) + trailing)
    pad = [(n, n), (n, n), (0, 0)] + [(0, 0)] * len(trailing)
    padded = jnp.pad(xg, pad, constant_values=fill)
    parts = [
        padded[n + dh : n + dh + H, n + dv : n + dv + W]
        for dh, dv in _neighbor_offsets(cfg)
    ]
    out = jnp.stack(parts, axis=2)  # [H, W, C, K, ...]
    return out.reshape((H * W, len(parts) * K) + trailing)


def scatter_neighbor_sum(contrib: jnp.ndarray, cfg: MapConfig) -> jnp.ndarray:
    """Inverse of :func:`gather_neighbors` for additive reductions:
    ``contrib[n_pyr, C*K]`` holds partial sums computed *in* pyramid j for the
    points *of* its neighbor j+o; returns ``[n_pyr, K]`` totals per point."""
    H, W = cfg.n_pyramids_h, cfg.n_pyramids_v
    n = cfg.pyramid_neighbor_radius
    offsets = _neighbor_offsets(cfg)
    K = contrib.shape[1] // len(offsets)
    cg = contrib.reshape(H, W, len(offsets), K)
    total = jnp.zeros((H, W, K), contrib.dtype)
    for c, (dh, dv) in enumerate(offsets):
        shifted = jnp.pad(cg[:, :, c], ((n, n), (n, n), (0, 0)))[
            n - dh : n - dh + H, n - dv : n - dv + W
        ]
        total = total + shifted
    return total.reshape(H * W, K)


def neighbor_cells(pyr: jnp.ndarray, cfg: MapConfig):
    """``[M]`` pyramid ids -> ``([M, C] neighbor cell ids, [M, C] valid)``,
    grid-clipped exactly like :func:`gather_neighbors`."""
    W = cfg.n_pyramids_v
    H = cfg.n_pyramids_h
    offs = _neighbor_offsets(cfg)
    dh = jnp.asarray([o[0] for o in offs], jnp.int32)
    dv = jnp.asarray([o[1] for o in offs], jnp.int32)
    h = pyr // W
    v = pyr % W
    nh = h[:, None] + dh[None, :]
    nv = v[:, None] + dv[None, :]
    ok = (nh >= 0) & (nh < H) & (nv >= 0) & (nv < W)
    return jnp.where(ok, nh * W + nv, 0), ok


def _chunk(n_pyr: int, s_pyr: int, ck: int, budget_floats: int = 34_000_000) -> int:
    """Largest divisor of n_pyr whose pair tile fits the float budget."""
    target = max(1, budget_floats // max(s_pyr * ck, 1))
    best = 1
    for d in range(1, n_pyr + 1):
        if n_pyr % d == 0 and d <= target:
            best = d
    return best


def _pair_g(ppos, pts, sigma):
    """``g`` for one chunk: ppos [B, S, 3], pts [B, M, 3] -> [B, S, M].

    ``d^2`` comes from coordinate differences.  The expanded form
    ``|a|^2 + |b|^2 - 2 a.b`` cancels catastrophically here: coordinates
    are metres over ``sigma ~ 0.1 m``, so ``|a|^2 ~ 1e4`` while the
    Gaussian only resolves ``d^2 <~ 10``.  The three axes are summed as
    separate elementwise terms so that the whole pair tile stays one
    elementwise producer, which XLA fuses into the caller's reduction."""
    d2 = 0.0
    for i in range(3):
        d = (ppos[:, :, None, i] - pts[:, None, :, i]) / sigma
        d2 = d2 + d * d
    return (REF_PDF_CONST**3) * jnp.exp(-0.5 * d2)


def pass1_sums(ppos, w, pts, sigma):
    """Pass-1 partial sums of one chunk: ``sum_s w[b, s] g(pts[b, m] |
    ppos[b, s])`` -> ``[B, M]``."""
    return jnp.sum(_pair_g(ppos, pts, sigma) * w[..., None], 1)


def pass2_sums(ppos, pts, cinv, sigma):
    """Pass-2 factor sums of one chunk: ``sum_m cinv[b, m] g(pts[b, m] |
    ppos[b, s])`` -> ``[B, S]``."""
    return jnp.sum(_pair_g(ppos, pts, sigma) * cinv[:, None, :], 2)


def measurement_update(
    particles,
    fovbin: FovBinning,
    obs: Observation,
    cfg: MapConfig,
    expected_newborn: jnp.ndarray,
    update_time: jnp.ndarray,
    axis_name: str | None = None,
    rt=None,
):
    """Returns ``(new_particles, norm_coeff, stats)``.

    ``rt`` (a :class:`~dspmap_tpu.state.RuntimeParams`) supplies sigma_ob /
    P_d / kappa as traced scalars so the reference's live setters
    (``dsp_dynamic.h:355-382``) work without a re-jit; ``None`` falls back
    to the static config values.

    ``norm_coeff = sum_z 1/C(z)`` over every binned measurement (both
    tiers) -- the particle-birth normalizer (``dsp_dynamic.h:798-805``; the
    reference stores C inside ``point_cloud[i][j][3]`` and sums its
    reciprocals at birth time).

    ``axis_name`` (shard_map fast path): the C(z) partials -- the only
    cross-particle reduction in the update -- are ``psum``-reduced over the
    map axis before normalization, exactly the ``[n_pyr, (2N+1)^2 K]``
    collective SURVEY.md section 7.1.7 names; pass 2 and the weight
    writeback stay shard-local.  ``norm_coeff`` then comes out replicated.
    """
    total = particles.flags.size  # drop sentinel (layout-agnostic)
    n_pyr, Ko = cfg.n_pyramids, cfg.obs_dense
    S_t = cfg.dense_slots
    C = cfg.neighbor_cells
    ck = C * Ko
    chunk = _chunk(n_pyr, S_t, ck)
    n_chunks = n_pyr // chunk
    sigma_ob = cfg.sigma_ob if rt is None else rt.sigma_ob
    p_d = cfg.p_detection if rt is None else rt.p_detection
    kappa = cfg.kappa if rt is None else rt.kappa
    e_birth = expected_newborn + kappa

    nbr_pts = gather_neighbors(obs.points, cfg, 0.0)  # [n_pyr, CK, 3]
    nbr_mask = gather_neighbors(obs.mask, cfg, False)  # [n_pyr, CK]

    pw = fovbin.weight * fovbin.mask  # masked dense particle weights
    sp_w = fovbin.sp_weight * fovbin.sp_mask  # [Psp]
    sp_pyr_safe = jnp.minimum(fovbin.sp_pyr, n_pyr - 1)
    y_cell_safe = jnp.minimum(obs.spill_cells, n_pyr - 1)

    have_psp = cfg.dense_slots < cfg.pyramid_slots
    have_osp = cfg.obs_dense < cfg.max_obs_points_per_pyramid

    # ---- shared pair blocks (computed once, used by both passes) -------
    # B2: spill particles x dense-obs neighborhoods  [Psp, CK]
    if have_psp:
        g_pz = _pair_g(
            fovbin.sp_pos[:, None, :], nbr_pts[sp_pyr_safe], sigma_ob
        )[:, 0, :]  # [Psp, CK]
    # B3: spilled obs cells x their neighborhoods' dense particles
    if have_osp:
        Yc, Ks = obs.spill_pts_mask.shape
        y_nbr, y_ok = neighbor_cells(y_cell_safe, cfg)  # [Yc, C]
        d_pos = fovbin.pos[y_nbr]  # [Yc, C, S_t, 3] (row gathers)
        d_w = pw[y_nbr] * y_ok[:, :, None]  # [Yc, C, S_t]
        g_dy = _pair_g(
            d_pos.reshape(Yc, C * S_t, 3), obs.spill_pts, sigma_ob
        )  # [Yc, C*S_t, Ks]
    # B4: spill particles x spill-cell points, adjacency-masked  [Psp, Yc*Ks]
    if have_psp and have_osp:
        W_ = cfg.n_pyramids_v
        n_r = cfg.pyramid_neighbor_radius
        dh = sp_pyr_safe[:, None] // W_ - y_cell_safe[None, :] // W_
        dv = sp_pyr_safe[:, None] % W_ - y_cell_safe[None, :] % W_
        adj = (
            (jnp.abs(dh) <= n_r)
            & (jnp.abs(dv) <= n_r)
            & fovbin.sp_mask[:, None]
            & obs.spill_cell_mask[None, :]
        )  # [Psp, Yc]
        g_py = _pair_g(
            fovbin.sp_pos[None], obs.spill_pts.reshape(1, Yc * Ks, 3),
            sigma_ob,
        )[0] * jnp.repeat(adj, Ks, axis=1)  # [Psp, Yc*Ks]

    # ---- pass 1: C(z) --------------------------------------------------
    def pass1(args):
        return pass1_sums(*args, sigma_ob)

    p1_in = (
        fovbin.pos.reshape(n_chunks, chunk, S_t, 3),
        pw.reshape(n_chunks, chunk, S_t),
        nbr_pts.reshape(n_chunks, chunk, ck, 3),
    )
    if n_chunks == 1:
        c_part = pass1(jax.tree.map(lambda x: x[0], p1_in))[None]
    else:
        c_part = jax.lax.map(pass1, p1_in)
    c_part = c_part.reshape(n_pyr, ck)

    if have_psp:
        # reduce spill contributions into the same [n_pyr, CK] layout by
        # source pyramid (one-hot matmul)
        onehot_p = (
            sp_pyr_safe[None, :] == jnp.arange(n_pyr, dtype=jnp.int32)[:, None]
        ) & fovbin.sp_mask[None, :]
        c_part = c_part + jnp.dot(
            onehot_p.astype(jnp.float32), sp_w[:, None] * g_pz, precision=_HI
        )

    if axis_name is not None:
        c_part = jax.lax.psum(c_part, axis_name)

    c_grid = scatter_neighbor_sum(c_part, cfg) * p_d + e_birth
    c_grid = jnp.where(obs.mask, c_grid, 1.0)  # masked cells: inert positive

    if have_osp:
        c_sp = jnp.einsum("ymk,ym->yk", g_dy, d_w.reshape(Yc, C * S_t),
                          precision=_HI)
        if have_psp:
            c_sp = c_sp + jnp.dot(sp_w, g_py, precision=_HI).reshape(Yc, Ks)
        if axis_name is not None:
            c_sp = jax.lax.psum(c_sp, axis_name)
        c_spill = jnp.where(
            obs.spill_pts_mask, c_sp * p_d + e_birth, 1.0
        )  # [Yc, Ks]

    # Birth normalizer: sum of reciprocals over every binned measurement.
    norm_coeff = jnp.sum(jnp.where(obs.mask, 1.0 / c_grid, 0.0))
    if have_osp:
        norm_coeff = norm_coeff + jnp.sum(
            jnp.where(obs.spill_pts_mask, 1.0 / c_spill, 0.0)
        )

    # ---- pass 2: weight factors ---------------------------------------
    nbr_cinv = jnp.where(nbr_mask, 1.0 / gather_neighbors(c_grid, cfg, 1.0), 0.0)

    def pass2(args):
        return pass2_sums(*args, sigma_ob)

    p2_in = (
        fovbin.pos.reshape(n_chunks, chunk, S_t, 3),
        nbr_pts.reshape(n_chunks, chunk, ck, 3),
        nbr_cinv.reshape(n_chunks, chunk, ck),
    )
    if n_chunks == 1:
        sum_dense = pass2(jax.tree.map(lambda x: x[0], p2_in))[None]
    else:
        sum_dense = jax.lax.map(pass2, p2_in)
    sum_dense = sum_dense.reshape(n_pyr, S_t)

    if have_osp:
        # spill-obs contributions to the dense factor tiles: reduce
        # (g/C_y) per (neighbor cell, slot) by a small one-hot matmul
        y_cinv = jnp.where(obs.spill_pts_mask, 1.0 / c_spill, 0.0)  # [Yc, Ks]
        contrib = jnp.einsum("ymk,yk->ym", g_dy, y_cinv,
                             precision=_HI).reshape(Yc, C, S_t)
        contrib = (contrib * y_ok[:, :, None]).reshape(Yc * C, S_t)
        onehot_y = (
            y_nbr.reshape(-1)[None, :]
            == jnp.arange(n_pyr, dtype=jnp.int32)[:, None]
        ) & (y_ok & obs.spill_cell_mask[:, None]).reshape(-1)[None, :]
        sum_dense = sum_dense + jnp.dot(
            onehot_y.astype(jnp.float32), contrib, precision=_HI
        )

    factor = (1.0 - p_d) + p_d * sum_dense

    if have_psp:
        sum_sp = jnp.einsum("pm,pm->p", g_pz, nbr_cinv[sp_pyr_safe],
                            precision=_HI)
        if have_osp:
            sum_sp = sum_sp + jnp.dot(g_py, y_cinv.ravel(), precision=_HI)
        factor_sp = (1.0 - p_d) + p_d * sum_sp

    # Occlusion: skipped iff the particle's own pyramid has points AND the
    # particle sits beyond their max range + slack (dsp_dynamic.h:759-765).
    # A particle in an empty pyramid is still updated from neighbor cells.
    occluded = (obs.max_range[:, None] > 0.0) & (
        fovbin.rng > obs.max_range[:, None] + cfg.occlusion_slack
    )
    updated = fovbin.mask & ~occluded
    new_w = jnp.where(updated, fovbin.weight * factor, fovbin.weight)

    # ---- write back into the pool -------------------------------------
    slot = jnp.where(updated, fovbin.slot, total).ravel()
    vals_w = new_w.ravel()
    n_updated = jnp.sum(updated)
    if have_psp:
        mr_sp = obs.max_range[sp_pyr_safe]
        occ_sp = (mr_sp > 0.0) & (fovbin.sp_rng > mr_sp + cfg.occlusion_slack)
        upd_sp = fovbin.sp_mask & ~occ_sp
        slot = jnp.concatenate(
            [slot, jnp.where(upd_sp, fovbin.sp_slot, total)]
        )
        vals_w = jnp.concatenate(
            [vals_w, jnp.where(upd_sp, fovbin.sp_weight * factor_sp,
                               fovbin.sp_weight)]
        )
        n_updated = n_updated + jnp.sum(upd_sp)

    weight = pool_put(particles.weight, slot, vals_w)
    if cfg.record_particle_time:
        t = pool_put(particles.t, slot,
                     jnp.broadcast_to(update_time, slot.shape))
        new_particles = dataclasses.replace(particles, weight=weight, t=t)
    else:
        new_particles = dataclasses.replace(particles, weight=weight)
    stats = {
        "updated_particles": n_updated,
        "obs_spill_overflow": obs.spill_overflow,
    }
    return new_particles, norm_coeff, stats
