"""Prediction: constant-velocity forward propagation with process noise
(``mapPrediction``, ``include/dsp_dynamic.h:627-701``) and the zero-velocity
variant (``include/dsp_static.h:630-646``).

Deviation (documented): the reference shifts every particle by the
negated ego displacement (``dsp_dynamic.h:300,665-667``) because its grid is
ego-centric.  Our grid is world-aligned with a moving window (see
``geometry``), so ego motion moves no data; prediction only advances particles
by their own velocity.  Under the static model the positions are untouched
entirely -- the reference's static prediction (``dsp_static.h:640-646``) is
pure ego-compensation.

Behavioral quirk preserved *exactly*: a particle receives velocity noise only
when ``|vx*vy*vz| >= 1e-6`` (``dsp_dynamic.h:653-659``).  Under
``limit_motion_to_xy_plane`` every particle's vz is pinned to 0 from its
first prediction (or birth, ``dsp_dynamic.h:905-907``), so the product is
identically zero and **no particle ever receives in-map velocity noise** --
diffusion happens only through the estimator-birth noise term.  We exploit
that statically: for xy-limited configs the noise draw is elided entirely,
which is bit-equivalent to the reference's behavior, not an approximation.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..config import MapConfig


def propagate(particles, cfg: MapConfig, key: jax.Array, dt: jnp.ndarray,
              rt=None):
    """Advance every valid particle one frame.  Returns the new pool.

    ``rt`` (state.RuntimeParams) supplies the velocity-noise sigma as a
    traced scalar (setPredictionVariance, dsp_dynamic.h:355-360)."""
    valid = particles.valid

    if cfg.motion_model == "static":
        zeros = jnp.zeros_like(particles.vx)
        return dataclasses.replace(particles, vx=zeros, vy=zeros, vz=zeros)

    vx, vy, vz = particles.vx, particles.vy, particles.vz
    if not cfg.limit_motion_to_xy_plane:
        sigma_v = cfg.velocity_noise_std if rt is None else rt.velocity_noise_std
        noise = (
            jax.random.normal(key, (3,) + vx.shape, jnp.float32)
            * sigma_v
        )
        keep_still = jnp.abs(vx * vy * vz) < 1e-6  # dsp_dynamic.h:653
        jitter = valid & ~keep_still
        vx = jnp.where(jitter, vx + noise[0], vx)
        vy = jnp.where(jitter, vy + noise[1], vy)
        vz = jnp.where(jitter, vz + noise[2], vz)
    else:
        # vz==0 for every particle -> the noise branch is statically dead
        # (see module docstring); just (re)pin vz.
        vz = jnp.where(valid, 0.0, vz)

    px = jnp.where(valid, particles.px + vx * dt, particles.px)
    py = jnp.where(valid, particles.py + vy * dt, particles.py)
    pz = jnp.where(valid, particles.pz + vz * dt, particles.pz)
    return dataclasses.replace(
        particles, px=px, py=py, pz=pz, vx=vx, vy=vy, vz=vz
    )
