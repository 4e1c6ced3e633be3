"""Backend dispatch: with the backend reported as a GPU, every shipped
preset traces through its normal entry point and reaches no Pallas kernel
of any route but Triton, the route of the one kernel the GPU path keeps."""

import jax
import jax.numpy as jnp
import pytest

import dspmap_tpu as dm
from dspmap_tpu.models.pipeline import init_multisensor_state


def _pallas_backends(jaxpr):
    """Backends of every pallas_call in ``jaxpr`` and its sub-jaxprs."""
    found = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            found.append(eqn.params["backend"])
        for sub in jax.core.jaxprs_in_params(eqn.params):
            found += _pallas_backends(sub)
    return found


def _abstract_frame(cfg, n_sensors):
    lead = () if n_sensors == 1 else (n_sensors,)
    sds = lambda shape, dt=jnp.float32: jax.ShapeDtypeStruct(lead + shape, dt)
    return dm.Frame(
        points=sds((cfg.max_input_points, 3)),
        n_points=sds((), jnp.int32),
        sensor_pos=sds((3,)),
        quat=sds((4,)),
        timestamp=sds(()),
    )


@pytest.mark.parametrize("name", list(dm.shipped_presets()))
def test_gpu_dispatch_traces_only_triton_kernels(name, monkeypatch):
    cfg, n_sensors = dm.shipped_presets()[name]
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    key = jax.random.key(0)
    if n_sensors == 1:
        step = dm.make_step(cfg)
        state = jax.eval_shape(lambda: dm.init_state(cfg, key))
    else:
        step = dm.make_multisensor_step(cfg, n_sensors)
        state = jax.eval_shape(
            lambda: init_multisensor_state(cfg, n_sensors, key))
    closed = jax.make_jaxpr(step)(state, _abstract_frame(cfg, n_sensors))
    backends = _pallas_backends(closed.jaxpr)
    assert all(b == "triton" for b in backends), backends
    # the pool layout reaches the occupancy kernel on the GPU; the compact
    # layout has no kernel at all
    want = int(cfg.layout == "pool" and cfg.use_pallas_occupancy)
    assert len(backends) == want, backends
