"""Frames, voxel addressing and FOV-pyramid geometry (pure jnp, closed form).

Reference semantics reproduced here:

* quaternion rotation (``include/dsp_dynamic.h:1303-1322``, Eigen
  ``q * v * q^-1``),
* FOV membership by boundary-plane sign tests
  (``include/dsp_dynamic.h:1329-1339``),
* pyramid cell search (``include/dsp_dynamic.h:1341-1367``) -- the reference
  scans per-cell boundary-plane normals in O(n_h)+O(n_v) per point; here both
  indices are closed-form ``floor(angle / resolution)`` expressions over the
  same partition (the horizontal planes contain the z axis, the vertical
  planes contain the y axis, so the two indices are independent cylindrical
  angles),
* voxel index <-> position (``include/dsp_dynamic.h:1062-1107``).

Deviation (documented): the voxel grid is **world-axis-aligned and
toroidally addressed**.  The reference stores particles in an ego frame and
shifts every particle by ``-delta_p`` each frame (``dsp_dynamic.h:300,665-667``),
which forces a full relocation pass.  Here particles carry world positions and
the map window (an axis-aligned box of exactly ``nx*ny*nz`` voxels quantized to
the grid, re-centered on the sensor every frame) moves instead.  A particle's
storage cell ``mod(world_voxel, dims)`` is invariant under window motion, so
ego-motion costs zero data movement; only self-moving particles relocate.  The
window is quantized to whole voxels, so its faces sit within half a voxel of
the reference's continuous ego bounds (``dsp_dynamic.h:1109-1125``).
"""

from __future__ import annotations

import jax.numpy as jnp

from .config import MapConfig


# ------------------------------------------------------------- quaternions

def rotation_matrix(q: jnp.ndarray) -> jnp.ndarray:
    """3x3 rotation matrix of a unit quaternion (wxyz).

    For planar SoA math: applying 9 scalar coefficients to coordinate planes
    avoids materializing ``[..., 3]``-stacked tensors with a 3-wide minor
    axis.
    """
    w, x, y, z = q[0], q[1], q[2], q[3]
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
            jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
            jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
        ]
    )


def rotate_planar(R: jnp.ndarray, px, py, pz):
    """Apply a rotation matrix to coordinate planes (any matching shapes)."""
    return (
        R[0, 0] * px + R[0, 1] * py + R[0, 2] * pz,
        R[1, 0] * px + R[1, 1] * py + R[1, 2] * pz,
        R[2, 0] * px + R[2, 1] * py + R[2, 2] * pz,
    )


def quaternion_rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vectors ``v[..., 3]`` by unit quaternion(s) ``q[..., 4]`` (wxyz).

    Same operation as the reference's Eigen ``att * v * att.inverse()``
    (dsp_dynamic.h:1303-1322), in the standard 2-cross-product form.
    """
    w = q[..., :1]
    u = q[..., 1:]
    t = 2.0 * jnp.cross(u, v)
    return v + w * t + jnp.cross(u, t)


def quaternion_conjugate(q: jnp.ndarray) -> jnp.ndarray:
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quaternion_is_valid(q: jnp.ndarray) -> jnp.ndarray:
    """Reference's odometry sanity check: every component within +-1.001
    (dsp_dynamic.h:193-196)."""
    return jnp.all(jnp.abs(q) <= 1.001)


# ------------------------------------------------------- voxel addressing

def world_voxel(pos: jnp.ndarray, cfg: MapConfig) -> jnp.ndarray:
    """Integer world-grid coordinates ``floor(pos / resolution)`` per axis."""
    return jnp.floor(pos / cfg.voxel_resolution).astype(jnp.int32)


def window_origin(sensor_pos: jnp.ndarray, cfg: MapConfig) -> jnp.ndarray:
    """World-voxel coordinate of the map window's low corner.

    The window is the ``nx x ny x nz`` block of world voxels whose extent best
    matches the reference's ego box ``sensor +- half_extent``
    (dsp_dynamic.h:528-530): ``round((sensor - half) / res)``.
    """
    half = jnp.asarray(cfg.half_extent, dtype=jnp.float32)
    return jnp.floor((sensor_pos - half) / cfg.voxel_resolution + 0.5).astype(jnp.int32)


def in_window(wv: jnp.ndarray, origin: jnp.ndarray, cfg: MapConfig) -> jnp.ndarray:
    """Validity of world-voxel coords ``wv[..., 3]`` against the window.

    Plays the role of ``ifParticleIsOut`` (dsp_dynamic.h:1109-1125), with the
    window quantized to whole voxels (see module docstring).
    """
    dims = jnp.asarray([cfg.nx, cfg.ny, cfg.nz], dtype=jnp.int32)
    rel = wv - origin
    return jnp.all((rel >= 0) & (rel < dims), axis=-1)


def storage_index(wv: jnp.ndarray, cfg: MapConfig) -> jnp.ndarray:
    """Flat toroidal storage cell for world-voxel coords ``wv[..., 3]``.

    ``mod(wv, dims)`` per axis, flattened z-major / x-fastest to mirror the
    reference layout ``index = z*ny*nx + y*nx + x`` (dsp_dynamic.h:1067).
    The mod is window-unambiguous because any two world voxels that collide
    are a full map extent apart and cannot both be inside the window.
    """
    sx = jnp.mod(wv[..., 0], cfg.nx)
    sy = jnp.mod(wv[..., 1], cfg.ny)
    sz = jnp.mod(wv[..., 2], cfg.nz)
    return (sz * cfg.ny + sy) * cfg.nx + sx


def storage_to_world_voxel(origin: jnp.ndarray, cfg: MapConfig) -> jnp.ndarray:
    """World-voxel coords ``[V, 3]`` of every storage cell for a window.

    Inverse of :func:`storage_index` restricted to the window: the unique
    world voxel in ``[origin, origin + dims)`` congruent to the cell.
    """
    v = jnp.arange(cfg.voxel_num, dtype=jnp.int32)
    sx = v % cfg.nx
    sy = (v // cfg.nx) % cfg.ny
    sz = v // (cfg.nx * cfg.ny)
    s = jnp.stack([sx, sy, sz], axis=-1)
    dims = jnp.asarray([cfg.nx, cfg.ny, cfg.nz], dtype=jnp.int32)
    return origin + jnp.mod(s - origin, dims)


def voxel_center(wv: jnp.ndarray, cfg: MapConfig) -> jnp.ndarray:
    """World-frame center position of world-voxel coords ``wv[..., 3]``
    (analogue of getVoxelPositionFromIndex, dsp_dynamic.h:1090-1107)."""
    return (wv.astype(jnp.float32) + 0.5) * cfg.voxel_resolution


def ego_grid_gather_indices(origin: jnp.ndarray, cfg: MapConfig) -> jnp.ndarray:
    """Storage cell for each window-local (ego) voxel index.

    Window-local flat order matches the reference's output convention
    ``index = z*ny*nx + y*nx + x`` with (0,0,0) at the window's low corner
    (dsp_dynamic.h:1062-1074); gathering with this map converts any ``[V,...]``
    storage-ordered grid into the reference's ego-ordered grid.
    """
    v = jnp.arange(cfg.voxel_num, dtype=jnp.int32)
    ex = v % cfg.nx
    ey = (v // cfg.nx) % cfg.ny
    ez = v // (cfg.nx * cfg.ny)
    wv = origin + jnp.stack([ex, ey, ez], axis=-1)
    return storage_index(wv, cfg)


# ------------------------------------------------------------ FOV pyramids

def pyramid_angles(p_sensor: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """The two cylindrical angles that define the pyramid partition.

    For a point in the (unrotated) sensor frame: the horizontal boundary
    planes contain the z axis with normals ``(-sin t, cos t, 0)``
    (dsp_dynamic.h:566-569) -> azimuth ``atan2(y, x)``; the vertical boundary
    planes contain the y axis with normals ``(sin a, 0, cos a)``
    (dsp_dynamic.h:572-577) -> the angle ``atan2(z, x)`` (note: *not* the
    spherical elevation; it ignores y, exactly like the reference's planes).
    """
    az = jnp.arctan2(p_sensor[..., 1], p_sensor[..., 0])
    el = jnp.arctan2(p_sensor[..., 2], p_sensor[..., 0])
    return az, el


def pyramid_index(
    p_sensor: jnp.ndarray, cfg: MapConfig
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(flat pyramid cell, in-FOV mask) for sensor-frame points ``[..., 3]``.

    Closed form over the same partition the reference scans plane-by-plane:
    cell ``h`` covers azimuth ``[-half_fov_h + h*res, ...+res)``
    (dsp_dynamic.h:1341-1353); cell ``v`` covers ``atan2(z,x)`` in
    ``[half_fov_v - (v+1)*res, half_fov_v - v*res)`` -- v grows downward
    (dsp_dynamic.h:1355-1367).  Flat index ``h * n_v + v``
    (dsp_dynamic.h:263).  The in-FOV mask reproduces ``ifInPyramidsArea``
    (dsp_dynamic.h:1329-1339): both angles within the half-FOV (x > 0 is
    implied for FOV half-angles < 90 deg).
    """
    az, el = pyramid_angles(p_sensor)
    res = cfg.angle_resolution_rad
    in_fov = (
        (jnp.abs(az) <= cfg.half_fov_h_rad)
        & (jnp.abs(el) <= cfg.half_fov_v_rad)
        & (p_sensor[..., 0] > 0.0)
    )
    h = jnp.floor((az + cfg.half_fov_h_rad) / res).astype(jnp.int32)
    v = jnp.floor((cfg.half_fov_v_rad - el) / res).astype(jnp.int32)
    h = jnp.clip(h, 0, cfg.n_pyramids_h - 1)
    v = jnp.clip(v, 0, cfg.n_pyramids_v - 1)
    return h * cfg.n_pyramids_v + v, in_fov


def pyramid_index_world(
    pos_world: jnp.ndarray,
    sensor_pos: jnp.ndarray,
    q_conj: jnp.ndarray,
    cfg: MapConfig,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Pyramid cell of world-frame points: un-rotate the ego offset into the
    sensor frame, then index.

    Equivalent to the reference's scheme of rotating the FOV boundary normals
    *into* the world-aligned frame (dsp_dynamic.h:226-232) -- testing a fixed
    point against rotated planes equals testing the inversely-rotated point
    against fixed planes.
    """
    p_sensor = quaternion_rotate(q_conj, pos_world - sensor_pos)
    return pyramid_index(p_sensor, cfg)


def pyramid_index_planar(sx, sy, sz, cfg: MapConfig):
    """Planar (SoA) form of :func:`pyramid_index` for sensor-frame coordinate
    planes of any shape.  Returns ``(flat_cell, in_fov)``."""
    res = cfg.angle_resolution_rad
    az = jnp.arctan2(sy, sx)
    el = jnp.arctan2(sz, sx)
    in_fov = (
        (jnp.abs(az) <= cfg.half_fov_h_rad)
        & (jnp.abs(el) <= cfg.half_fov_v_rad)
        & (sx > 0.0)
    )
    h = jnp.clip(
        jnp.floor((az + cfg.half_fov_h_rad) / res).astype(jnp.int32),
        0, cfg.n_pyramids_h - 1,
    )
    v = jnp.clip(
        jnp.floor((cfg.half_fov_v_rad - el) / res).astype(jnp.int32),
        0, cfg.n_pyramids_v - 1,
    )
    return h * cfg.n_pyramids_v + v, in_fov


def world_voxel_planar(px, py, pz, cfg: MapConfig):
    inv = 1.0 / cfg.voxel_resolution
    return (
        jnp.floor(px * inv).astype(jnp.int32),
        jnp.floor(py * inv).astype(jnp.int32),
        jnp.floor(pz * inv).astype(jnp.int32),
    )


def in_window_planar(wx, wy, wz, origin: jnp.ndarray, cfg: MapConfig):
    rx, ry, rz = wx - origin[0], wy - origin[1], wz - origin[2]
    return (
        (rx >= 0) & (rx < cfg.nx)
        & (ry >= 0) & (ry < cfg.ny)
        & (rz >= 0) & (rz < cfg.nz)
    )


def storage_index_planar(wx, wy, wz, cfg: MapConfig):
    return (
        jnp.mod(wz, cfg.nz) * cfg.ny + jnp.mod(wy, cfg.ny)
    ) * cfg.nx + jnp.mod(wx, cfg.nx)


def storage_index_from_rel(rx, ry, rz, origin, cfg: MapConfig):
    """Storage cell from window-relative voxel coords ``r* = w* - origin``
    (valid only where 0 <= r* < dims).

    Avoids per-element integer division: ``mod(w, n) = mod(o, n) + r`` folded
    back once, with ``mod(o, n)`` a scalar.  Integer div/mod by the
    non-power-of-two grid dims is a long instruction sequence per element;
    this is three adds and selects.
    """
    sox = jnp.mod(origin[0], cfg.nx)
    soy = jnp.mod(origin[1], cfg.ny)
    soz = jnp.mod(origin[2], cfg.nz)
    cx = sox + jnp.clip(rx, 0, cfg.nx - 1)
    cy = soy + jnp.clip(ry, 0, cfg.ny - 1)
    cz = soz + jnp.clip(rz, 0, cfg.nz - 1)
    cx = jnp.where(cx >= cfg.nx, cx - cfg.nx, cx)
    cy = jnp.where(cy >= cfg.ny, cy - cfg.ny, cy)
    cz = jnp.where(cz >= cfg.nz, cz - cfg.nz, cz)
    return (cz * cfg.ny + cy) * cfg.nx + cx
