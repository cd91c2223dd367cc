"""Lattice-axis (spatial) parallelism for the site-centric engines.

SURVEY.md §2.5 row 3 / §5 long-context row: the framework's analog of
sequence/context parallelism is sharding the lattice axis x.  The
site-centric engines are built from ±1-site rolls, elementwise selects and
small-slot-axis sorts, so under a ``NamedSharding`` that splits L over a
'space' mesh axis the XLA SPMD partitioner lowers every roll to a
**halo exchange** (collective-permute between lattice-neighbour devices)
and every global reduction (global m, Var, mass) to an all-reduce —
no hand-written communication, no all-gathers on the hot path
(tests/test_spatial_sharding.py asserts the compiled HLO: collective-permute
present, all-gather absent).

Usage::

    mesh = space_mesh(8)                        # 1-D 'space' mesh
    frames, occ = run_lattice_gas(
        config, params, key, T=..., obs_dt=..., dt=...,
        occ_sharding=space_sharding(mesh))      # (B, L): L sharded 8-way

Observables are bit-identical to the unsharded run except the float
lattice-axis reductions — the matmul-DFT spectrum and the density
variance — whose f32 summation association depends on the shard shape
(≤1e-5 rel; integer-count sums like m_global stay exact in any order).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def space_mesh(n_devices: Optional[int] = None, devices=None,
               axis_name: str = "space") -> Mesh:
    """1-D mesh over the lattice axis; devices as in
    :func:`parallel.mesh.select_devices` (raises when there are fewer than
    ``n_devices``)."""
    from hydrolim_tpu.parallel.mesh import take_devices

    return Mesh(np.asarray(take_devices(devices, n_devices)), (axis_name,))


def space_sharding(mesh: Mesh, *, batched: bool = True, slots: bool = False,
                   axis_name: str = "space") -> NamedSharding:
    """Sharding for lattice-trailing state arrays.

    - occupancy (B, L):      ``P(None, 'space')``        (batched=True)
    - slot field (B, K, L):  ``P(None, None, 'space')``  (slots=True)
    - unbatched (L,):        ``P('space')``
    """
    lead = ([None] if batched else []) + ([None] if slots else [])
    return NamedSharding(mesh, P(*lead, axis_name))


def grid_mesh(n_sweep: int, n_space: int, devices=None) -> Mesh:
    """2-D ('sweep', 'space') mesh: replica-axis data parallelism composed
    with lattice-axis spatial sharding — the scaling recipe for workloads
    that are both ensemble-wide AND too long for one chip's share of the
    lattice.  Device order is row-major: lattice-neighbour shards sit on
    adjacent devices, replica groups stride."""
    from hydrolim_tpu.parallel.mesh import take_devices

    devices = take_devices(devices, n_sweep * n_space)
    return Mesh(np.asarray(devices).reshape(n_sweep, n_space),
                ("sweep", "space"))


def grid_sharding(mesh: Mesh, *, slots: bool = False) -> NamedSharding:
    """State sharding on a :func:`grid_mesh`: batch axis over 'sweep',
    lattice axis over 'space' — ``P('sweep', 'space')`` for (B, L)
    occupancy, ``P('sweep', None, 'space')`` for (B, K, L) slot fields.
    Pass as ``occ_sharding=`` to the lattice-gas runners; trajectories are
    bit-identical to the unsharded run (the DFT spectrum and density
    variance reassociate to ~1e-5, as for the 1-D shardings).  n_sweep
    must divide the batch (the sweep drivers' padding rule,
    parallel.mesh)."""
    mid = (None,) if slots else ()
    return NamedSharding(mesh, P("sweep", *mid, "space"))
