"""``ParticleSystem`` — user-facing facade with the reference's API surface.

Constructor kwargs mirror ``PARTICLE_solver_CLASS.py:14-40`` (same names,
same defaults); ``run(T, obs_dt, record_fft, record_var)`` returns the same
``out`` dict schema (:542-557).  Under the hood everything is the static
config + vmappable params + jitted scan of ``hydrolim_tpu.particles``.
"""
from __future__ import annotations

import functools
import inspect
from typing import Any, Callable, Dict, Optional

import jax
import numpy as np

from hydrolim_tpu.core.config import (
    PARTICLE_ENGINES,
    ParticleConfig,
    auto_dt,
    check_engine,
    make_particle_params,
)
from hydrolim_tpu.ops.dft import ri_to_complex as _ri_to_complex
from hydrolim_tpu.particles.init import ParticleState, eval_profile, init_particles
from hydrolim_tpu.particles.run import (
    ParticleRunResult,
    run_particles,
    substeps_for,
)


def _wrap_flip_rate_fn(fn: Optional[Callable]) -> Optional[Callable]:
    """Adapt the reference's 2-arg ``flip_rate_fn(sigma, m)`` (beta closed
    over, PARTICLE_solver_CLASS.py:59-62) to the framework's
    ``(sigma, m, beta)`` signature."""
    if fn is None:
        return None
    try:
        n_args = len(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        n_args = 3
    if n_args >= 3:
        return fn
    return lambda sigma, m, beta: fn(sigma, m)


def _seed_from_rng(rng) -> int:
    if rng is None:
        return int(np.random.SeedSequence().entropy % (2 ** 63))
    if isinstance(rng, (int, np.integer)):
        return int(rng)
    if isinstance(rng, np.random.Generator):
        return int(rng.integers(0, 2 ** 63 - 1))
    raise TypeError(f"unsupported rng {type(rng)}")


class ParticleSystem:
    def __init__(
        self,
        L: int,
        xlim: float,
        rate_diffusion: float,
        rate_active: float,
        beta: float,
        flip_rate_fn: Optional[Callable] = None,
        init: str = "fixed",
        N: int = 1000,
        rho0_plus: Optional[Callable] = None,
        rho0_minus: Optional[Callable] = None,
        rng=None,
        scale_rates: bool = True,
        local_kernel_sigma: float = 0.005,
        periodic: bool = False,
        minus_anchor: bool = True,
        immobilize_when_anchored: bool = True,
        anchor_positions: Optional[list] = None,
        anchor_radius: float = 0.005,
        site_capacity: Optional[int] = 1,
        crowding_suppresses_rates: bool = False,
        k_on: float = 0.1,
        k_off: float = 0.01,
        suppress_flip_when_bound: bool = True,
        k_exit: float = 0,
        # --- extensions beyond the reference ---
        active_model: str = "plus_forward",
        dt: Optional[float] = None,
        max_event_prob: float = 0.10,
        n_pad: Optional[int] = None,
        exit_buffer: Optional[int] = None,
        record_pos: bool = True,
    ):
        if exit_buffer is None:
            # a particle exits at most once, so N slots always suffice
            exit_buffer = N if k_exit and anchor_positions else 8
        if init == "poisson" and n_pad is None and rho0_plus is not None:
            # The Poisson profiles, not N, determine the realized count —
            # size the particle buffer from the total intensity with
            # 6-sigma headroom (capped at the K*L capacity when exclusion
            # truncates), so profiles whose mass exceeds N are realized in
            # full instead of binomially thinned to n_buf(N).  The
            # reference has no buffer and realizes whatever Poisson draws.
            lam_tot = float(np.sum(eval_profile(rho0_plus, L))
                            + np.sum(eval_profile(rho0_minus, L)))
            need = int(np.ceil(lam_tot + 6.0 * np.sqrt(max(lam_tot, 1.0))))
            if site_capacity is not None:
                need = min(need, L * int(site_capacity))
            default_buf = -(-max(int(np.ceil(N * 1.25)), 8) // 8) * 8
            if need > default_buf:
                n_pad = -(-need // 8) * 8
                if k_exit and anchor_positions:
                    exit_buffer = max(exit_buffer, n_pad)
        self.config = ParticleConfig(
            L=L, xlim=xlim, init=init, N=N, scale_rates=scale_rates,
            local_kernel_sigma=local_kernel_sigma, periodic=periodic,
            minus_anchor=minus_anchor,
            immobilize_when_anchored=immobilize_when_anchored,
            anchor_positions=tuple(anchor_positions) if anchor_positions else None,
            anchor_radius=anchor_radius, site_capacity=site_capacity,
            crowding_suppresses_rates=crowding_suppresses_rates,
            suppress_flip_when_bound=suppress_flip_when_bound,
            active_model=active_model,
            dt=dt, max_event_prob=max_event_prob, n_pad=n_pad,
            exit_buffer=exit_buffer,
            flip_rate_fn=_wrap_flip_rate_fn(flip_rate_fn),
        )
        self.params = make_particle_params(
            self.config, beta=beta, rate_diffusion=rate_diffusion,
            rate_active=rate_active, k_on=k_on, k_off=k_off, k_exit=k_exit)
        self.beta = float(beta)
        self.record_pos = record_pos
        self.key = jax.random.PRNGKey(_seed_from_rng(rng))
        if init == "poisson":
            assert rho0_plus is not None and rho0_minus is not None
            self.rho0_plus = eval_profile(rho0_plus, L)
            self.rho0_minus = eval_profile(rho0_minus, L)
        else:
            self.rho0_plus = self.rho0_minus = None
        self._dt = dt if dt is not None else auto_dt(self.config, self.params)

    # -- reference-compatible attributes ------------------------------------
    @property
    def L(self):
        return self.config.L

    @property
    def dx(self):
        return self.config.dx

    @property
    def xlim(self):
        return self.config.xlim

    @property
    def K(self):
        return self.config.site_capacity

    @property
    def rate_diffusion(self):
        return float(self.params.rate_diffusion)

    @property
    def rate_active(self):
        return float(self.params.rate_active)

    @property
    def dt(self):
        return self._dt

    # -----------------------------------------------------------------------
    def _split_key(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def init_particles(self) -> ParticleState:
        return init_particles(self.config, self._split_key(),
                              self.rho0_plus, self.rho0_minus)

    def run_raw(self, T: float = 10.0, obs_dt: float = 0.01,
                state0: Optional[ParticleState] = None,
                record_fft: bool = True) -> ParticleRunResult:
        """Device-side run returning the raw frame pytree (for sweeps)."""
        if state0 is None:
            state0 = self.init_particles()
        return run_particles(self.config, self.params, state0, T=T,
                             obs_dt=obs_dt, dt=self._dt,
                             record_pos=self.record_pos,
                             record_fft=record_fft)

    def run(self, T: float = 10.0, obs_dt: float = 0.01,
            record_fft: bool = False, record_var: bool = False,
            engine: str = "particle") -> Dict[str, Any]:
        """Reference-schema output dict (PARTICLE_solver_CLASS.py:542-557).

        Extensions: ``pos_frames``/``alive_frames``/``bound_frames`` (padded
        arrays with unwrapped positions — stable particle IDs across exits,
        unlike the reference's ``np.delete`` index shifting, SURVEY.md §2.4),
        ``exit_init_bin`` and ``dt_eff``.

        ``engine='lattice_gas'`` runs the site-centric slot engine with ALL
        N particles tagged as identity tracers — same law, same out schema,
        ~30-50× the single-run throughput at the flagship K=3 config.
        Requires exclusion and no anchors (bind/exit channels route to the
        particle engine)."""
        if check_engine(engine, PARTICLE_ENGINES) == "lattice_gas":
            return self._run_lattice_gas(T, obs_dt, record_fft, record_var)
        # record_fft gates the O(L^2) matmul-DFT on device, not just the
        # host-side slicing below.  Deviation from a reference quirk: the
        # reference computes var only inside its record_fft branch (so
        # record_var without record_fft yields zeros,
        # PARTICLE_solver_CLASS.py:499-535); here var_list holds the true
        # variances whenever record_var is set.
        res = jax.device_get(self.run_raw(T=T, obs_dt=obs_dt,
                                          record_fft=record_fft))
        return self._frames_to_out(res, T, obs_dt, record_fft, record_var)

    def run_checkpointed(self, T: float = 10.0, obs_dt: float = 0.01,
                         *, ckpt_dir, chunk_frames: int = 64,
                         record_fft: bool = False, record_var: bool = False,
                         resume: bool = True,
                         engine: str = "particle") -> Dict[str, Any]:
        """Preemption-safe ``run``: the frame scan executes in chunks of
        ``chunk_frames`` frames with an atomic checkpoint (frames + carry
        state incl. the PRNG key) after each — a killed run resumes from
        the newest complete chunk and the stitched ``out`` dict is
        bit-identical to an uninterrupted :meth:`run`.  An
        extension (the reference only caches completed sweeps); see
        utils/checkpoint.py.  ``engine='lattice_gas'`` checkpoints the
        slot engine instead (same constraint set as :meth:`run`)."""
        if check_engine(engine, PARTICLE_ENGINES) == "lattice_gas":
            return self._run_lattice_gas(
                T, obs_dt, record_fft, record_var,
                ckpt=dict(ckpt_dir=ckpt_dir, chunk_frames=chunk_frames,
                          resume=resume))
        from hydrolim_tpu.utils.checkpoint import run_particles_checkpointed

        res = run_particles_checkpointed(
            self.config, self.params, self.init_particles(), T=T,
            obs_dt=obs_dt, dt=self._dt, ckpt_dir=ckpt_dir,
            chunk_frames=chunk_frames, record_pos=self.record_pos,
            record_fft=record_fft, resume=resume)
        return self._frames_to_out(res, T, obs_dt, record_fft, record_var)

    def _frames_to_out(self, res: ParticleRunResult, T: float,
                       obs_dt: float, record_fft: bool,
                       record_var: bool) -> Dict[str, Any]:
        f = res.frames
        L = self.config.L
        times_obs = np.arange(0.0, T, obs_dt)
        M = len(times_obs)

        pos_list = []
        bound_list = []
        if self.record_pos:
            for k in range(M):
                a = f.alive[k]
                pos_list.append((f.pos[k][a] % L).astype(np.int64))
                bound_list.append(f.bound[k][a])
        ec = int(res.final_state.exit_count)
        ec = min(ec, self.config.n_exit_buf)
        out = {
            "times_obs": times_obs,
            "pos_list": pos_list,
            "rho_p_list": np.asarray(f.rho_p, dtype=float),
            "rho_m_list": np.asarray(f.rho_m, dtype=float),
            "total_list": np.asarray(f.total, dtype=float),
            "particle_count_list": [int(c) for c in f.particle_count],
            "bound_list": bound_list,
            "m_local_list": np.asarray(f.m_local, dtype=float),
            "m_global": np.asarray(f.m_global, dtype=float),
            "rho_hat_complex": _ri_to_complex(f.rho_hat_ri) if record_fft else None,
            "fft_amp_list": np.asarray(f.fft_amp, dtype=float) if record_fft else None,
            "var_list": np.asarray(f.var, dtype=float) if record_var else None,
            "exit_times": list(np.asarray(res.final_state.exit_times[:ec])),
            "exit_positions": list(np.asarray(res.final_state.exit_pos[:ec])),
            # --- extensions ---
            "exit_init_bin": list(np.asarray(res.final_state.exit_init_bin[:ec])),
            "pos_frames": np.asarray(f.pos) if self.record_pos else None,
            "alive_frames": np.asarray(f.alive) if self.record_pos else None,
            "bound_frames": np.asarray(f.bound) if self.record_pos else None,
            "dt_eff": obs_dt / substeps_for(obs_dt, self._dt),
        }
        return out

    def _run_lattice_gas(self, T: float, obs_dt: float, record_fft: bool,
                         record_var: bool,
                         ckpt: Optional[Dict[str, Any]] = None
                         ) -> Dict[str, Any]:
        """Single run on the slot engine, full out-schema parity: every
        particle is a tagged tracer, so pos_list/pos_frames carry exact
        identities (displacement estimators work unchanged)."""
        from hydrolim_tpu.particles.lattice_gas_k import run_lattice_gas_k

        config = self.config
        assert config.exclusion and config.anchor_positions is None, (
            "engine='lattice_gas' supports exclusion configs without "
            "anchors/binding")
        N, L = config.N, config.L
        # Tag budget: for Poisson inits the realized count follows the
        # profiles, not N, and the ctor sizes n_buf from the intensities —
        # tag the whole buffer so every realized particle carries an
        # identity; surplus tags are TRACER_INVALID and masked below.
        n_tags = config.n_buf if config.init == "poisson" else N
        params_b = jax.tree.map(lambda x: np.asarray(x)[None], self.params)
        if ckpt is not None:
            from hydrolim_tpu.utils.checkpoint import (
                run_lattice_gas_k_checkpointed,
            )

            runner = functools.partial(run_lattice_gas_k_checkpointed,
                                       **ckpt)
        else:
            runner = run_lattice_gas_k
        frames, _slots = jax.tree.map(np.asarray, runner(
            config, params_b, self._split_key(), T=T, obs_dt=obs_dt,
            dt=self._dt, rho0_plus=self.rho0_plus, rho0_minus=self.rho0_minus,
            record_fft=record_fft, n_tracers=n_tags))
        g = lambda a: np.asarray(a[0])
        times_obs = np.arange(0.0, T, obs_dt)
        M = len(times_obs)
        pos_u = g(frames.tracer_pos)                 # (M, n_tags) unwrapped
        # Poisson init may realize fewer than N particles; surplus tags are
        # TRACER_INVALID (phantom-tracer guard) — mask them out everywhere
        from hydrolim_tpu.particles.lattice_gas import tracer_valid_mask

        alive = tracer_valid_mask(pos_u)                 # (M, N)
        n_real = int(alive[0].sum())
        pos_list = [(pos_u[k][alive[k]] % L).astype(np.int64)
                    for k in range(M)]
        zeros = np.zeros((M, n_tags), bool)
        if record_fft:
            rho_hat = np.fft.fft(g(frames.total), axis=-1)
            fft_amp = np.abs(rho_hat)
        else:
            rho_hat = fft_amp = None
        return {
            "times_obs": times_obs,
            "pos_list": pos_list,
            "rho_p_list": g(frames.rho_p).astype(float),
            "rho_m_list": g(frames.rho_m).astype(float),
            "total_list": g(frames.total).astype(float),
            "particle_count_list": [n_real] * M,
            "bound_list": [zeros[k][alive[k]] for k in range(M)],
            "m_local_list": g(frames.m_local).astype(float),
            "m_global": g(frames.m_global).astype(float),
            "rho_hat_complex": rho_hat,
            "fft_amp_list": fft_amp,
            "var_list": g(frames.var).astype(float) if record_var else None,
            "exit_times": [],
            "exit_positions": [],
            "exit_init_bin": [],
            "pos_frames": pos_u,
            "alive_frames": alive,
            "bound_frames": zeros,
            "dt_eff": obs_dt / substeps_for(obs_dt, self._dt),
        }

    # -- visualization (PARTICLE_solver_CLASS.py:561-1093) ------------------
    def visualize_all(self, out, **kw):
        from hydrolim_tpu.viz.particle_plots import visualize_all
        return visualize_all(self, out, **kw)

    def plot_individuals(self, out, **kw):
        from hydrolim_tpu.viz.particle_plots import plot_individuals
        return plot_individuals(self, out, **kw)

    def animate_profiles(self, out, **kw):
        from hydrolim_tpu.viz.particle_plots import animate_profiles
        return animate_profiles(self, out, **kw)

    def show_realtime(self, out, **kw):
        """Interactive looping playback of the profile series — the
        reference's vispy realtime canvas (PARTICLE_solver_CLASS.py:980-
        1093); see viz/realtime.py for the backend ladder."""
        from hydrolim_tpu.viz.realtime import show_profiles
        kw.setdefault("xlim", self.config.xlim)
        return show_profiles(out, **kw)

    @staticmethod
    def empirical_densities_from_particles(pos, sigma, L, dx, total_norm=None):
        """Static-method parity shim (PARTICLE_solver_CLASS.py:197-214)."""
        pos = np.asarray(pos)
        sigma = np.asarray(sigma)
        counts_p = np.bincount(pos[sigma == 1], minlength=L)
        counts_m = np.bincount(pos[sigma == -1], minlength=L)
        denom = (float(max(1, pos.size)) if total_norm is None
                 else float(total_norm)) * dx
        return counts_p / denom, counts_m / denom
