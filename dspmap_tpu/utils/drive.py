"""Driving a preset through its entry point: device frames of the synthetic
street scene and the matching fresh state and step, for the single-sensor
(``make_step``) and the multi-sensor (``make_multisensor_step``) paths."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models.pipeline import (Frame, init_multisensor_state,
                               make_multisensor_step, make_step)
from ..state import init_state
from . import sim


def street_frames(cfg, n: int, n_sensors: int = 1, seed: int = 0):
    """``n`` frames of ``sim.generate_sequence`` on the default device.
    With ``n_sensors > 1`` every sensor gets the same pose and cloud, each
    leaf carrying a leading sensor axis."""
    out = []
    for pts, cnt, pos, quat, t in sim.generate_sequence(n, cfg, seed=seed):
        f = Frame(jnp.asarray(pts), jnp.int32(cnt), jnp.asarray(pos),
                  jnp.asarray(quat), jnp.asarray(t))
        if n_sensors > 1:
            f = Frame(*(jnp.stack([x] * n_sensors) for x in f))
        out.append(f)
    return out


def init_and_step(cfg, n_sensors: int = 1, seed: int = 0, **step_kw):
    """``(state, step)``: a fresh map and its unjitted per-frame step."""
    key = jax.random.key(seed)
    if n_sensors == 1:
        return init_state(cfg, key), make_step(cfg, **step_kw)
    return (init_multisensor_state(cfg, n_sensors, key),
            make_multisensor_step(cfg, n_sensors))
