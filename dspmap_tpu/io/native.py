"""ctypes bindings for the native preprocessing runtime
(``native/preprocess.cpp``): the host data path feeding the device step.

Falls back to the numpy implementations in :mod:`.rosbag` when the shared
library has not been built (``python native/build.py``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

_LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "libdspmap_native.so"
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        try:
            import subprocess
            import sys

            subprocess.run(
                [sys.executable, str(_LIB_PATH.parent / "build.py")],
                check=True, capture_output=True,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.dspmap_voxel_downsample.restype = ctypes.c_int
    lib.dspmap_voxel_downsample.argtypes = [
        f32p, ctypes.c_int, ctypes.c_float, f32p, ctypes.c_int]
    lib.dspmap_remap_crop.restype = ctypes.c_int
    lib.dspmap_remap_crop.argtypes = [f32p, ctypes.c_int, f32p, f32p, ctypes.c_int]
    lib.dspmap_interp_pose.restype = None
    lib.dspmap_interp_pose.argtypes = [
        f64p, f32p, f32p, ctypes.c_int, ctypes.c_double, f32p, f32p]
    lib.dspmap_preprocess_frame.restype = ctypes.c_int
    lib.dspmap_preprocess_frame.argtypes = [
        f32p, ctypes.c_int, ctypes.c_float, f32p, f32p, ctypes.c_int,
        f32p, ctypes.c_int]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def preprocess_frame(cam_points: np.ndarray, leaf: float, half_extent,
                     max_points: int):
    """Downsample + axis remap + crop + pad: returns ``(out[max_points,3], n)``.

    Native path if built; numpy fallback otherwise (identical semantics,
    modulo hash-map vs lexicographic leaf enumeration order).
    """
    lib = _load()
    cam = np.ascontiguousarray(cam_points, np.float32)
    half = np.ascontiguousarray(half_extent, np.float32)
    out = np.zeros((max_points, 3), np.float32)
    if lib is not None:
        scratch = np.empty((max(len(cam), 1), 3), np.float32)
        n = lib.dspmap_preprocess_frame(
            _fp(cam), len(cam), ctypes.c_float(leaf), _fp(half), _fp(out),
            max_points, _fp(scratch), len(scratch),
        )
        return out, int(n)
    # fallback
    from .rosbag import voxel_downsample  # noqa: PLC0415

    ds = voxel_downsample(cam[np.isfinite(cam).all(axis=1)], leaf)
    body = np.column_stack([ds[:, 2], -ds[:, 0], -ds[:, 1]])
    keep = (np.abs(body) < half).all(axis=1)
    body = body[keep][:max_points]
    out[: len(body)] = body
    return out, len(body)


def interp_pose(times: np.ndarray, pos: np.ndarray, quat: np.ndarray,
                t_query: float):
    """Pose interpolation (lerp position, slerp attitude) at ``t_query``."""
    lib = _load()
    times = np.ascontiguousarray(times, np.float64)
    pos = np.ascontiguousarray(pos, np.float32)
    quat = np.ascontiguousarray(quat, np.float32)
    if lib is not None:
        op = np.empty(3, np.float32)
        oq = np.empty(4, np.float32)
        lib.dspmap_interp_pose(
            times.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            _fp(pos), _fp(quat), len(times), ctypes.c_double(t_query),
            _fp(op), _fp(oq),
        )
        return op, oq
    # numpy fallback
    k = int(np.clip(np.searchsorted(times, t_query), 1, len(times) - 1))
    ta, tb = times[k - 1], times[k]
    f = 0.0 if tb == ta else float(np.clip((t_query - ta) / (tb - ta), 0, 1))
    p = pos[k - 1] * (1 - f) + pos[k] * f
    qa, qb = quat[k - 1], quat[k]
    d = float(np.dot(qa, qb))
    s = 1.0 if d >= 0 else -1.0
    q = qa * (1 - f) + s * qb * f
    return p.astype(np.float32), (q / np.linalg.norm(q)).astype(np.float32)
