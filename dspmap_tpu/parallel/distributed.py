"""Multi-host initialization and the weak-scaling benchmark harness.

The reference has no distributed machinery (SURVEY.md section 2.6); scaling
the map across hosts is this framework's addition.  Transport is owned
entirely by the XLA runtime: `jax.distributed.initialize` wires the hosts,
the map-parallel mesh (``parallel.sharding``) spans all devices, and the
jitted step's collectives ride NVLink within a host and the network across
hosts.

Usage (per host)::

    from dspmap_tpu.parallel import distributed, make_mesh, shard_state
    distributed.init("host0:1234", num_processes=2, process_id=0)
    mesh = make_mesh()              # all global devices
    state = shard_state(init_state(cfg, key), mesh)
    ...

Single-machine rehearsal: ``XLA_FLAGS=--xla_force_host_platform_device_count=N``
with the CPU backend exercises the same sharded program (tests/test_sharding.py).
"""

from __future__ import annotations

import jax


def init(coordinator_address: str | None = None,
         num_processes: int | None = None,
         process_id: int | None = None) -> None:
    """Initialize multi-host JAX.  Pass the coordinator's address, the
    process count and this process's index; a GPU cluster has no launcher
    that JAX could read them from.  Without them a single-process run is
    assumed and nothing happens."""
    if coordinator_address is None or jax.process_count() > 1:
        return  # single process, or already initialized
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def is_coordinator() -> bool:
    return jax.process_index() == 0
