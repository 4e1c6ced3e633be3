"""Test harness: every test runs on the CPU backend (``JAX_PLATFORMS=cpu``)
over a virtual 8-device mesh, so the sharding tests run without several
accelerators and unit tests stay deterministic.  The program itself runs on
the GPU: ``python chip_smoke.py`` and ``python bench.py`` there.

The platform is set through ``jax.config`` as well as the environment, so
the override holds even when the environment variable was read before this
file."""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)
