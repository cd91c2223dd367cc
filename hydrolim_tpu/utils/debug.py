"""Debug / sanitizer checks (SURVEY.md §5 "race detection" row).

On-device data races don't exist in the XLA programming model; the analogous
hazard in this framework is a *conflict-resolution violation* — two
simultaneous hops exceeding site capacity — plus the usual NaN/bounds
hazards.  These helpers are assertion passes enabled behind a debug flag
(they add host syncs and should stay out of production steps):

- :func:`check_particle_invariants` — capacity ≤ K, positions in range,
  alive-count consistency, |m| ≤ 1,
- :func:`check_density_invariants` — non-negative densities, finite mass,
- :func:`nan_guard` — jax.debug.callback NaN check usable inside jit,
- :func:`matmuls_below_highest` — float matmuls and convolutions a program
  runs below full f32 precision (on a GPU the default precision lets XLA
  use TF32).
"""
from __future__ import annotations

import os
import jax
import jax.numpy as jnp
import numpy as np

from hydrolim_tpu.core.config import ParticleConfig
from hydrolim_tpu.ops.segment import occupancy


def debug_enabled() -> bool:
    return os.environ.get("HYDROLIM_DEBUG", "0") not in ("0", "", "false")


def check_particle_invariants(config: ParticleConfig, state) -> None:
    """Host-side assertion pass over a ParticleState (or batched state)."""
    pos = np.asarray(state.pos)
    alive = np.asarray(state.alive)
    assert np.all((pos >= 0) & (pos < config.L)), "position out of range"
    if config.exclusion:
        occ, _, _ = occupancy(jnp.asarray(pos), jnp.asarray(state.sigma),
                              jnp.asarray(alive), config.L)
        occ = np.asarray(occ)
        assert occ.max() <= config.K, (
            f"exclusion violated: occupancy {occ.max()} > K={config.K}")
    sigma = np.asarray(state.sigma)
    assert np.all(np.isin(sigma[alive], (-1, 1))), "bad spin value"
    ec = int(np.max(np.asarray(state.exit_count)))
    assert ec >= 0


def check_density_invariants(rho_p, rho_m) -> None:
    rho_p = np.asarray(rho_p)
    rho_m = np.asarray(rho_m)
    assert np.all(np.isfinite(rho_p)) and np.all(np.isfinite(rho_m)), \
        "non-finite density"
    assert rho_p.min() >= 0 and rho_m.min() >= 0, "negative density"


def nan_guard(x: jnp.ndarray, name: str = "array") -> jnp.ndarray:
    """Inside-jit NaN check (no-op unless HYDROLIM_DEBUG is set)."""
    if not debug_enabled():
        return x

    def _cb(v):
        if not np.all(np.isfinite(v)):
            raise FloatingPointError(f"NaN/Inf detected in {name}")

    jax.debug.callback(_cb, x)
    return x


def matmuls_below_highest(fn, *args, **kwargs) -> list:
    """Float ``dot_general`` and ``conv_general_dilated`` ops in
    ``fn(*args, **kwargs)``'s jaxpr (nested jits, scans and conds included)
    whose precision is not HIGHEST on both operands — with
    ``jax.default_matmul_precision`` at its default, such an op may run in
    TF32 on the GPU.  Returns one description per op; empty means every
    float matmul and convolution asks for full f32."""
    from jax.extend import core as jex_core

    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name in ("dot_general", "conv_general_dilated"):
                dtype = eqn.invars[0].aval.dtype
                if (jnp.issubdtype(dtype, jnp.floating)
                        and eqn.params.get("precision") != highest):
                    found.append(f"{eqn.primitive.name} {dtype} "
                                 f"{eqn.invars[0].aval.shape} x "
                                 f"{eqn.invars[1].aval.shape} precision="
                                 f"{eqn.params.get('precision')}")
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                    if isinstance(sub, jex_core.ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, jex_core.Jaxpr):
                        walk(sub)

    walk(jax.make_jaxpr(lambda *a: fn(*a, **kwargs))(*args).jaxpr)
    return found
