"""hydrolim_tpu — JAX framework for hydrodynamic limits of active particle
systems with mean-field (Curie–Weiss) interactions.

A from-scratch JAX/XLA re-design of the capabilities of
`StandeHaas/Hydrodynamic-Limits-of-Active-Particle-Systems-with-Mean-Field-
Interactions` (see SURVEY.md):

- ``particles``: microscopic stochastic engine — N active particles on a 1-D
  lattice with symmetric diffusion, sigma-directed active hops, Curie–Weiss
  spin flips against a local/global magnetization field, site exclusion
  (capacity K), anchor binding/unbinding and absorbing exits.  The reference's
  event-serial Gillespie loop (PARTICLE_solver_CLASS.py:450-558) is
  re-architected as a fixed-Δt synchronous stepper: every particle samples an
  event each step, exclusion conflicts are resolved by a random-priority
  scatter, and the whole step is one jitted/vmapped XLA program.
- ``pde``: macroscopic IMEX finite-difference solver for the coupled
  hydrodynamic densities rho_plus/rho_minus (IMEX_PDE_solver_class.py), with
  implicit diffusion via FFT/DCT diagonalization, a banded kernel or a dense
  precomputed inverse, explicit upwind transport, Curie–Weiss reaction, and
  an embedded Euler–Maruyama tracer ensemble.
- ``observables``: on-device recorder + estimator suite (v_eff, D_eff,
  magnetization, blocking probability, structure factors).
- ``sweeps``: vmapped replica/β/σ/N ensembles, shardable over a device mesh.
- ``theory`` / ``fit``: tanh fixed point, exclusion-corrected v/D prediction
  family, curve-fit drivers, kinesin-II real-data validation.
- ``viz``: matplotlib re-creation of the reference figure inventory.

Compilation cache: when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX uses it
and this package sets nothing.  Otherwise compiled programs persist in
``.jax_cache`` at the root of the checkout; ``HYDROLIM_NO_COMPILATION_CACHE=1``
turns the cache off (the test suite does).
"""

__version__ = "0.4.0"

import os as _os

if ("JAX_COMPILATION_CACHE_DIR" not in _os.environ
        and _os.environ.get("HYDROLIM_NO_COMPILATION_CACHE", "") != "1"):
    import jax as _jax

    _jax.config.update("jax_compilation_cache_dir", _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache"))
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from hydrolim_tpu.core.config import ParticleConfig, ParticleParams, PDEConfig, PDEParams  # noqa: F401
from hydrolim_tpu.particles.system import ParticleSystem  # noqa: F401
from hydrolim_tpu.pde.system import IMEXPDE  # noqa: F401
