"""dspmap_tpu: a dual-structure particle-filter occupancy map in JAX.

A from-scratch JAX/XLA/Pallas reimplementation of the capabilities of
g-ch/DSP-map (Chen et al., "Continuous Occupancy Mapping in Dynamic
Environments Using Particles", arXiv:2202.06273): an ego-centric 3-D particle
map fusing depth point clouds and poses into current occupancy plus
multi-horizon future occupancy, with constant-velocity particle propagation,
FOV-pyramid measurement updates with occlusion masking, Dempster-Shafer
guided particle birth fed by a cluster-tracking velocity estimator, and
per-voxel systematic resampling.

Quick start::

    import jax
    from dspmap_tpu import dsp_dynamic, init_state, make_step, Frame

    cfg = dsp_dynamic()
    state = init_state(cfg, jax.random.key(0))
    step = jax.jit(make_step(cfg))
    state, out = step(state, frame)

See SURVEY.md for the reference analysis this build follows and
docs/DESIGN.md for the architecture rationale.
"""

from .config import (  # noqa: F401
    MapConfig,
    dsp_dynamic,
    dsp_dynamic_multi_neighbors,
    dsp_static,
    large_urban,
    example_node_settings,
    performance_level_parameters,
    shipped_presets,
)
from .state import (  # noqa: F401
    MapState,
    Particles,
    EstimatorState,
    RuntimeParams,
    init_state,
    add_random_particles,
)
from .models.pipeline import (  # noqa: F401
    Frame,
    StepOutput,
    make_step,
    make_multisensor_step,
    init_multisensor_state,
    get_occupancy_map,
    read_occupancy,
    clear_future_prediction,
    set_prediction_variance,
    set_observation_stddev,
    set_newborn_particle_weight,
    set_detection_probability,
    set_clutter_intensity,
)

__version__ = "0.1.0"
