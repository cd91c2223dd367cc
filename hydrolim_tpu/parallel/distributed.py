"""Multi-host initialization (SURVEY.md §5 distributed-backend row).

Single-host multi-device needs nothing: ``make_mesh`` spans the local
devices and XLA collectives ride the devices' interconnect.  For multi-host
runs, call :func:`initialize_multihost` once per process before any JAX
computation; the sweep batch then spans ``jax.device_count()`` global
devices and cross-host reductions ride the network.
"""
from __future__ import annotations

import os
from typing import Optional

import jax


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None) -> None:
    """Thin wrapper over ``jax.distributed.initialize`` with env fallbacks
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).  No-op
    when the process topology is absent (single-host run)."""
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return
    kwargs = dict(coordinator_address=coordinator_address)
    # NB: `x or env` would drop the valid process_id 0 — test None explicitly
    if num_processes is None:
        num_processes = os.environ.get("JAX_NUM_PROCESSES")
    if process_id is None:
        process_id = os.environ.get("JAX_PROCESS_ID")
    if num_processes is not None:
        kwargs["num_processes"] = int(num_processes)
    if process_id is not None:
        kwargs["process_id"] = int(process_id)
    jax.distributed.initialize(**kwargs)


def global_sweep_mesh(axis_name: str = "sweep"):
    """1-D mesh over ALL global devices (every process's chips) — the
    sweep/replica batch axis spans hosts; cross-host reductions ride DCN.
    Call :func:`initialize_multihost` first in multi-process runs."""
    import numpy as np
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis_name,))


def is_primary() -> bool:
    """True on the process that should write checkpoints/figures."""
    return jax.process_index() == 0
