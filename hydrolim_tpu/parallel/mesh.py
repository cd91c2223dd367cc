"""Device-mesh parallelism for sweeps and large ensembles.

The reference has no distributed execution at all (SURVEY.md §2.5); its
embarrassingly-parallel sweep axes (β, σ, N × replicas) become here a batch
axis sharded over a ``jax.sharding.Mesh``:

- axis ``'sweep'``: the flattened (β-grid × replicas) batch — pure data
  parallelism, zero communication during stepping,
- axis ``'part'``: the particle buffer axis — the global-magnetization
  reduction ``Σσ/N`` becomes an XLA ``psum`` across devices, inserted automatically
  from the sharding annotations (the framework's particle-axis parallelism),
- axis ``'space'`` (PDE): the lattice axis of ρ± — the dense
  circulant/diffusion matmuls and ±1-site rolls induce collectives
  automatically.

All sharding is declarative ``NamedSharding`` + ``jit``; there is no
hand-written communication.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def _factor2(n: int) -> Tuple[int, int]:
    """Split n into the most-square (a, b) with a·b = n."""
    best = (n, 1)
    for a in range(1, int(np.sqrt(n)) + 1):
        if n % a == 0:
            best = (n // a, a)
    return best


def select_devices(n_devices: Optional[int] = None):
    """The first ``n_devices`` devices of the default platform (all of them
    when None).  Raises ValueError when the platform has fewer: a mesh is
    never quietly built elsewhere.  A virtual CPU mesh is built by passing
    ``devices=jax.devices("cpu")`` to the mesh constructors."""
    devices = jax.devices()
    if n_devices is None:
        return devices
    if len(devices) < n_devices:
        raise ValueError(
            f"need {n_devices} devices, the default platform "
            f"'{devices[0].platform}' has {len(devices)}")
    return devices[:n_devices]


def take_devices(devices, n_devices: Optional[int]):
    """``devices`` (default: :func:`select_devices`) cut to ``n_devices``;
    raises ValueError when there are fewer."""
    if devices is None:
        return select_devices(n_devices)
    if n_devices is None:
        return list(devices)
    if len(devices) < n_devices:
        raise ValueError(f"need {n_devices} devices, got {len(devices)}")
    return list(devices)[:n_devices]


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, str] = ("sweep", "part"),
              devices=None) -> Mesh:
    """2-D mesh over the available devices (most-square factorization);
    device selection per :func:`select_devices`."""
    devices = take_devices(devices, n_devices)
    a, b = _factor2(len(devices))
    dev_array = np.asarray(devices).reshape(a, b)
    return Mesh(dev_array, axis_names)


def sweep_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D all-``'sweep'`` mesh — pure sweep-grid data parallelism, the
    right default for the user-facing sweep drivers (the flattened
    (β × replicas) batch shards across every device; no particle/lattice
    axis is split, so stepping needs zero communication)."""
    return Mesh(np.asarray(take_devices(devices, n_devices)), ("sweep",))


def resolve_sweep_mesh(mesh: Optional[Mesh],
                       n_devices: Optional[int]) -> Optional[Mesh]:
    """Driver-kwarg plumbing: an explicit mesh wins; else ``n_devices``
    builds a 1-D sweep mesh; else no sharding (None)."""
    if mesh is not None:
        return mesh
    if n_devices is not None and n_devices > 1:
        return sweep_mesh(n_devices)
    return None


def sweep_axis_size(mesh: Optional[Mesh]) -> int:
    if mesh is None:
        return 1
    return int(mesh.shape.get(mesh.axis_names[0], 1))


def pad_batch(tree, Bp: int, B: Optional[int] = None):
    """Pad every leading-batch-axis leaf to ``Bp`` rows by repeating the
    last entry; the caller drops the pad replicas after the run.  With
    ``B`` given, ONLY leaves whose leading dim equals ``B`` are treated as
    batch leaves — a non-batch leaf that happens to have a short leading
    axis (per-field constants, anchor lists) passes through untouched.

    Bit-equality contract: ``jax.random.split(key, B)`` and the
    partitionable-threefry bit streams are PREFIX-STABLE in the batch size
    (row i of a (B, …) draw depends only on its linear element indices), so
    replicas 0..B-1 of the padded run are bit-identical to the unpadded
    run — this is what makes 1-device and n-device sweep results equal
    (tests/test_parallel.py).

    Scope: sampled trajectories are bit-identical in all configurations
    (integer state + threshold comparisons).  Recorded FLOAT observables
    are exactly bitwise for shape-independent stepping math (global m);
    configs whose recording path contains (·, L)·(L, L) matmuls (local-σ
    smoothing, DFT spectra) may reassociate at different shard-local batch
    shapes and agree to ~1 ulp instead (measured 2.4e-7 max rel at the
    flagship shape — bench.bench_multichip_sweep_virtual)."""
    import jax.numpy as jnp

    def pad(x):
        x = jnp.asarray(x)
        if x.ndim == 0 or x.shape[0] >= Bp:
            return x
        if B is not None and x.shape[0] != B:
            return x
        return jnp.concatenate(
            [x, jnp.repeat(x[-1:], Bp - x.shape[0], axis=0)], axis=0)

    return jax.tree.map(pad, tree)


def shard_batch(mesh: Mesh, tree, B: Optional[int] = None):
    """Place leading-batch-axis leaves on ``P('sweep')`` (other axes
    replicated); scalars and non-batch leaves are replicated.  ``B``
    identifies the batch length (default: the first leaf's dim 0)."""
    leaves = jax.tree.leaves(tree)
    if B is None:
        B = leaves[0].shape[0]
    sweep = NamedSharding(mesh, P(mesh.axis_names[0]))
    repl = NamedSharding(mesh, P())

    def put(x):
        if getattr(x, "ndim", 0) >= 1 and x.shape[0] == B:
            return jax.device_put(x, sweep)
        return jax.device_put(x, repl)

    return jax.tree.map(put, tree)


def pad_and_shard(mesh: Optional[Mesh], tree, B: int):
    """``pad_batch`` to the sweep-axis multiple, then ``shard_batch``;
    returns ``(tree, Bp)``.  No-op (tree, B) when mesh is None."""
    if mesh is None:
        return tree, B
    n_sw = sweep_axis_size(mesh)
    Bp = -(-B // n_sw) * n_sw
    tree = pad_batch(tree, Bp, B=B)
    return shard_batch(mesh, tree, Bp), Bp


def sweep_sharding(mesh: Mesh, *more_axes) -> NamedSharding:
    """Sharding for a batch-leading array: batch on 'sweep', then the given
    trailing axes (None for replicated)."""
    return NamedSharding(mesh, P(mesh.axis_names[0], *more_axes))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_particle_state(mesh: Mesh, state, batched: bool = True):
    """Place a (batched) ParticleState on the mesh: batch axis on 'sweep',
    particle buffer axis on 'part'; scalars/exit logs replicated per shard
    row."""
    part = mesh.axis_names[1]
    sweep = mesh.axis_names[0]

    def spec_for(leaf):
        if not batched:
            if leaf.ndim >= 1 and leaf.shape[0] > 16:
                return NamedSharding(mesh, P(part))
            return NamedSharding(mesh, P())
        if leaf.ndim >= 2 and leaf.shape[1] > 16:   # (B, n_buf, ...)
            return NamedSharding(mesh, P(sweep, part))
        if leaf.ndim >= 1:                           # (B, ...) scalars/logs
            return NamedSharding(mesh, P(sweep))
        return NamedSharding(mesh, P())

    return jax.tree.map(lambda x: jax.device_put(x, spec_for(x)), state)


def shard_params(mesh: Mesh, params):
    """ParticleParams with leading (B,) axis → shard on 'sweep'."""
    sh = sweep_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, sh), params)
