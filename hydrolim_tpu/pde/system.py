"""``IMEXPDE`` — user-facing facade with the reference's API surface.

Constructor kwargs mirror ``IMEX_PDE_solver_class.py:13-29``;
``initialize(mode, rho0, noise, n_tracers)`` (:96-131), ``solve()`` (:236),
``get_output()`` (:293-306), ``plot_all()``/``plot_individual()`` (viz
module) keep the same names and output schema.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

import jax
import numpy as np

from hydrolim_tpu.core.config import (
    PDE_ENGINES,
    PDEConfig,
    check_engine,
    make_pde_params,
)
from hydrolim_tpu.pde.stepper import (
    PDEOps,
    PDESolveResult,
    build_pde_ops,
    pde_solve,
)


class IMEXPDE:
    def __init__(
        self,
        L: int = 1000,
        xlim: float = 1.0,
        T: float = 10.0,
        dt: float = 5e-4,
        gamma: float = 2.33e-4,
        lam: float = 0.6,
        beta: float = 2.0,
        bc: str = "periodic",
        active_model: str = "bidirectional",
        gaussian_kernel: bool = False,
        kernel_sigma: float = 0.02,
        snapshot_interval: int = 50,
        outdir: str = "IMEX_output",
        seed: Optional[int] = None,
        # --- extensions beyond the reference ---
        diffusion_solver: str = "auto",
        fft_kmax: Optional[int] = None,
        legacy_double_diffusion: bool = False,
        make_outdir: bool = False,
    ):
        if diffusion_solver == "auto" and float(gamma) == 0.0:
            diffusion_solver = "identity"   # A = I exactly; skip the solve
        self.config = PDEConfig(
            L=L, xlim=xlim, T=T, dt=dt, bc=bc, active_model=active_model,
            gaussian_kernel=gaussian_kernel, kernel_sigma=kernel_sigma,
            snapshot_interval=snapshot_interval,
            diffusion_solver=diffusion_solver, fft_kmax=fft_kmax,
            legacy_double_diffusion=legacy_double_diffusion)
        self.params = make_pde_params(gamma=gamma, lam=lam, beta=beta)
        self.outdir = Path(outdir)
        if make_outdir:
            self.outdir.mkdir(parents=True, exist_ok=True)
        self.seed = seed if seed is not None else int(
            np.random.SeedSequence().entropy % (2 ** 63))
        self.key = jax.random.PRNGKey(self.seed)
        self.ops: PDEOps = build_pde_ops(self.config, self.params)
        self.rho_mean = 1.0 / xlim
        self._result: Optional[PDESolveResult] = None

    # -- reference-compatible attributes ------------------------------------
    @property
    def L(self):
        return self.config.L

    @property
    def dx(self):
        return self.config.dx

    @property
    def x(self):
        return np.linspace(0, self.config.xlim, self.config.L, endpoint=False)

    @property
    def T(self):
        return self.config.T

    @property
    def dt(self):
        return self.config.dt

    @property
    def nsteps(self):
        return self.config.nsteps

    @property
    def gamma(self):
        return float(self.params.gamma)

    @property
    def lam(self):
        return float(self.params.lam)

    @property
    def beta(self):
        return float(self.params.beta)

    # -----------------------------------------------------------------------
    def initialize(self, mode: str = "poisson", rho0: float = 1.0,
                   noise: float = 0.2, n_tracers: int = 1000) -> None:
        """Initial conditions (IMEX_PDE_solver_class.py:96-131).

        ``mode='poisson'`` reproduces the reference quirk: a centered
        exponential bump ``exp(−|x−0.5|/0.05)``, not Poisson noise
        (SURVEY.md §2.4)."""
        from hydrolim_tpu.pde.init import pde_initialize

        self.key, sub = jax.random.split(self.key)
        self.n_tracers = n_tracers
        self.rho_p, self.rho_m, self.tracers = pde_initialize(
            self.config, sub, mode=mode, rho0=rho0, noise=noise,
            n_tracers=n_tracers)

    def solve(self, engine: str = "xla") -> None:
        """Advance the full T horizon (``engine='xla'``, the one engine),
        keeping the complete per-step spectral record."""
        check_engine(engine, PDE_ENGINES)
        self.key, sub = jax.random.split(self.key)
        self._result = jax.device_get(pde_solve(
            self.config, self.params, self.ops, self.rho_p, self.rho_m,
            self.tracers, sub))

    def solve_checkpointed(self, *, ckpt_dir, chunk_blocks: int = 8,
                           resume: bool = True) -> None:
        """Preemption-safe ``solve``: the snapshot-block scan executes in
        chunks of ``chunk_blocks`` blocks with an atomic checkpoint (block
        records + carry incl. tracer state and PRNG key) after each — a
        killed solve resumes from the newest complete chunk, bit-identical
        to an uninterrupted :meth:`solve`.  An extension beyond the
        reference; see utils/checkpoint.py."""
        from hydrolim_tpu.utils.checkpoint import pde_solve_checkpointed

        self.key, sub = jax.random.split(self.key)
        self._result = pde_solve_checkpointed(
            self.config, self.params, self.ops, self.rho_p, self.rho_m,
            self.tracers, sub, ckpt_dir=ckpt_dir, chunk_blocks=chunk_blocks,
            resume=resume)

    def get_output(self) -> Dict[str, Any]:
        """Reference output schema (IMEX_PDE_solver_class.py:293-306)."""
        assert self._result is not None, "call solve() first"
        r = self._result
        rec = r.records
        n_iters = self.config.n_records   # == nsteps+1 at record_every=1
        # snapshot times recorded at block starts that are true iterations
        n_snap = int(np.sum(np.asarray(r.snap_times) <= self.config.T + 1e-9))
        fft_c = np.asarray(rec.fft_ri[..., 0] + 1j * rec.fft_ri[..., 1],
                           dtype=np.complex64)
        return dict(
            rho_p=np.asarray(r.rho_p),
            rho_m=np.asarray(r.rho_m),
            m_series=np.asarray(rec.m_mean)[:n_iters],
            var_series=np.asarray(rec.var)[:n_iters],
            fft_amp=np.abs(fft_c)[:n_iters],
            fft_phase=fft_c[:n_iters],
            snapshots=np.asarray(r.snapshots)[:n_snap],
            m_snapshots=np.asarray(r.m_snapshots)[:n_snap],
            times=np.asarray(r.snap_times)[:n_snap],
            v_eff_series=np.asarray(rec.v_eff)[:n_iters],
            D_eff_series=np.asarray(rec.D_eff)[:n_iters],
        )

    # plotting lives in hydrolim_tpu.viz; thin methods for API parity
    def plot_all(self):
        from hydrolim_tpu.viz.pde_plots import plot_all
        plot_all(self, self.get_output())

    def plot_individual(self, k_max: int = 6):
        from hydrolim_tpu.viz.pde_plots import plot_individual
        plot_individual(self, self.get_output(), k_max=k_max)
