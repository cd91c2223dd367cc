"""Config dataclasses mirroring the reference kwarg surfaces.

``ParticleConfig`` mirrors ``ParticleSystem.__init__``
(/root/reference/PARTICLE_solver_CLASS.py:14-40, 24 kwargs) and ``PDEConfig``
mirrors ``IMEXPDE.__init__`` (/root/reference/IMEX_PDE_solver_class.py:13-29,
14 kwargs), with the same names and defaults.

Static/traced split: everything that changes compiled code shape (lattice size,
boundary conditions, feature flags, buffer sizes) is *static* and lives in the
frozen config; everything that can vary per sweep point without recompiling
(β, rates, binding constants) lives in the ``*Params`` pytrees so sweeps can
``jax.vmap`` over them (SURVEY.md §2.5: β/σ become batched array parameters).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


#: ``engine=`` values of the particle surfaces (facade and sweep drivers)
PARTICLE_ENGINES = ("particle", "lattice_gas")
#: ``engine=`` values of the PDE surfaces
PDE_ENGINES = ("xla",)


def check_engine(engine: str, engines: Tuple[str, ...]) -> str:
    """``engine`` if it is one of ``engines``; a ValueError naming them
    otherwise (an unknown name is never rerouted to another engine)."""
    if engine not in engines:
        raise ValueError(f"unknown engine {engine!r}; the engines are "
                         + ", ".join(repr(e) for e in engines))
    return engine


# ---------------------------------------------------------------------------
# Particle engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParticleConfig:
    """Static configuration of the microscopic particle engine.

    Field names/defaults follow the reference ctor
    (PARTICLE_solver_CLASS.py:14-40).  ``site_capacity=None`` (extension)
    disables exclusion entirely — the conflict-resolution pass is skipped and
    the stepper takes the fast mean-field path used by the throughput
    benchmark.
    """

    L: int = 1000
    xlim: float = 1.0
    init: str = "fixed"                      # 'fixed' | 'poisson'
    N: int = 1000                            # particle budget (fixed buffer)
    scale_rates: bool = True
    local_kernel_sigma: float = 0.005        # <=0 -> global magnetization
    periodic: bool = False
    # Accepted for reference API parity only — a NO-OP, exactly as in the
    # reference: its False branch grants sigma=-1 particles rate_active
    # (PARTICLE_solver_CLASS.py:269-272), but the later act_possible gate
    # ``r_act_vec[~((sigma==1) & forward_free)] = 0`` (:316-318) always
    # zeroes them again, and every reference driver passes True.  The
    # engines implement the one reachable behavior ('plus_forward' actives
    # sigma=+1 only; sigma-directed binding lives in anchor gates).
    minus_anchor: bool = True
    immobilize_when_anchored: bool = True
    anchor_positions: Optional[Tuple[float, ...]] = None
    anchor_radius: float = 0.005
    site_capacity: Optional[int] = 1         # None -> no exclusion (K = inf)
    crowding_suppresses_rates: bool = False
    suppress_flip_when_bound: bool = True
    # 'plus_forward': only σ=+1 hop actively (reference behavior,
    # PARTICLE_solver_CLASS.py:317-319); 'bidirectional': σ-directed hops for
    # both spins — the microscopic counterpart of the PDE's bidirectional
    # model, needed for the micro↔macro v=λ·tanh(βm_β) validation
    # (plot_figs.py).
    active_model: str = "plus_forward"
    # --- additions beyond the reference -----------------------------------------
    dt: Optional[float] = None               # None -> auto from rate bound
    max_event_prob: float = 0.10             # tau-leap bias knob: max R_i*dt
    n_pad: Optional[int] = None              # particle buffer size (>= N)
    exit_buffer: int = 0                     # capacity of the exit-event log
    flip_rate_fn: Optional[Callable] = None  # (sigma, m, beta) -> rate; default CW

    def __post_init__(self):
        assert self.init in ("fixed", "poisson")
        assert self.active_model in ("plus_forward", "bidirectional")
        if self.site_capacity is not None and self.init == "fixed":
            assert self.N <= self.site_capacity * self.L, (
                "N exceeds lattice capacity")

    @property
    def dx(self) -> float:
        return self.xlim / self.L

    @property
    def exclusion(self) -> bool:
        return self.site_capacity is not None

    @property
    def K(self) -> int:
        return self.site_capacity if self.site_capacity is not None else 2**30

    @property
    def n_buf(self) -> int:
        """Padded particle-buffer length (static shape for XLA)."""
        if self.n_pad is not None:
            assert self.n_pad >= self.N
            return self.n_pad
        # Poisson init draws a random count; leave headroom, keep lanes full.
        slack = 1.25 if self.init == "poisson" else 1.0
        return _round_up(max(int(np.ceil(self.N * slack)), 8), 8)

    @property
    def n_exit_buf(self) -> int:
        return max(self.exit_buffer, 8)

    @property
    def sigma_grid(self) -> float:
        return self.local_kernel_sigma / self.dx

    def anchor_mask(self) -> np.ndarray:
        """Boolean per-site anchor mask (PARTICLE_solver_CLASS.py:88-104)."""
        mask = np.zeros(self.L, dtype=bool)
        if self.anchor_positions is None:
            return mask
        apos = np.asarray(self.anchor_positions, dtype=float)
        idxs = np.unique(np.round((apos / self.xlim) * (self.L - 1)).astype(int))
        r_idx = int(np.ceil(self.anchor_radius / self.dx))
        for a in idxs:
            lo = max(0, a - r_idx)
            hi = min(self.L - 1, a + r_idx)
            mask[lo:hi + 1] = True
        return mask


class ParticleParams(NamedTuple):
    """Runtime (vmappable) parameters of the particle engine.

    Rates are stored *post scale_rates* (PARTICLE_solver_CLASS.py:45-47):
    ``rate_diffusion/dx²`` and ``rate_active/dx`` when scaling is on.
    """

    beta: jnp.ndarray
    rate_diffusion: jnp.ndarray
    rate_active: jnp.ndarray
    k_on: jnp.ndarray
    k_off: jnp.ndarray
    k_exit: jnp.ndarray


def make_particle_params(
    config: ParticleConfig,
    *,
    beta: float,
    rate_diffusion: float,
    rate_active: float,
    k_on: float = 0.1,
    k_off: float = 0.01,
    k_exit: float = 0.0,
    dtype=jnp.float32,
) -> ParticleParams:
    if config.scale_rates:
        rate_diffusion = rate_diffusion / config.dx ** 2
        rate_active = rate_active / config.dx
    as_arr = lambda v: jnp.asarray(v, dtype=dtype)
    return ParticleParams(
        beta=as_arr(beta),
        rate_diffusion=as_arr(rate_diffusion),
        rate_active=as_arr(rate_active),
        k_on=as_arr(k_on),
        k_off=as_arr(k_off),
        k_exit=as_arr(k_exit),
    )


def auto_dt(config: ParticleConfig, params: ParticleParams,
            beta_max: Optional[float] = None) -> float:
    """Pick Δt so the per-particle per-step event probability stays below
    ``config.max_event_prob`` (SURVEY.md §7.4 "Δt selection").

    The per-particle total-rate bound is
    ``2·r_diff + r_act + flip_max + k_on + k_off + k_exit``.  For the
    default Curie–Weiss flip rate ``exp(-βσm)`` the maximum is
    ``exp(|β|)`` (at σm = -1); a custom ``config.flip_rate_fn`` is probed
    numerically over σ = ±1 and m ∈ [-1, 1] — bounding it with the CW
    formula would silently let a larger custom rate exceed
    ``max_event_prob`` and truncate the stacked bind/unbind/exit channels.
    """
    get = lambda v: float(np.max(np.asarray(v)))
    b = beta_max if beta_max is not None else get(params.beta)
    if config.flip_rate_fn is not None:
        import jax.numpy as jnp

        # probe over the batch's ACTUAL β values, not just the maximum
        #: a custom rate maximized at a smaller β (e.g. one
        # decreasing in β) would otherwise be under-bounded, making dt too
        # large for the low-β replicas
        betas = np.unique(np.abs(np.asarray(params.beta, np.float64)).ravel())
        if beta_max is not None:
            betas = np.union1d(betas, [abs(float(beta_max))])
        m_grid = jnp.linspace(-1.0, 1.0, 201)
        flip_max = max(
            float(np.max(np.asarray(config.flip_rate_fn(
                jnp.full_like(m_grid, s), m_grid, jnp.float32(bb)))))
            for s in (-1.0, 1.0) for bb in betas)
    else:
        flip_max = float(np.exp(abs(b)))
    r_max = (2.0 * get(params.rate_diffusion)
             + get(params.rate_active)
             + flip_max
             + get(params.k_on) + get(params.k_off) + get(params.k_exit))
    return config.max_event_prob / max(r_max, 1e-12)


# ---------------------------------------------------------------------------
# PDE engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PDEConfig:
    """Static configuration of the IMEX PDE engine
    (IMEX_PDE_solver_class.py:13-29)."""

    L: int = 1000
    xlim: float = 1.0
    T: float = 10.0
    dt: float = 5e-4
    bc: str = "periodic"                     # 'periodic' | 'neumann'
    active_model: str = "bidirectional"      # 'bidirectional' | 'anchored_minus'
    gaussian_kernel: bool = False
    kernel_sigma: float = 0.02
    snapshot_interval: int = 50
    # --- additions beyond the reference -----------------------------------------
    diffusion_solver: str = "auto"           # 'auto'|'fft'|'dct'|'dense'|'identity'
    n_tracers: int = 1000
    tracer_window_time: float = 0.05         # IMEX_PDE_solver_class.py:238
    fft_kmax: Optional[int] = None           # None -> L//2+1 (full rfft)
    record_every: int = 1                    # thin the per-step series
    # API-compat no-op: the reference's anchored "double solve" (:189-190 +
    # :207-208) re-reads the unchanged fields, so it equals a single solve
    legacy_double_diffusion: bool = False

    def __post_init__(self):
        assert self.bc in ("periodic", "neumann")
        assert self.active_model in ("bidirectional", "anchored_minus")
        # 'identity' = exact solve for gamma == 0 (A = I; the reference
        # single-run config, IMEX_PDE_solver_run.py:13 gamma=0) — skips the
        # two spectral transforms per species per step entirely.
        # 'banded' = large-L scale path: the exponentially-decaying inverse
        # applied as a narrow convolution, O(L·W) and space-shardable.
        assert self.diffusion_solver in ("auto", "fft", "dct", "dense",
                                         "identity", "banded")

    @property
    def dx(self) -> float:
        return self.xlim / self.L

    @property
    def nsteps(self) -> int:
        return int(self.T / self.dt)

    @property
    def kmax(self) -> int:
        # clamp to the rfft width: bins past L//2 are aliased mirrors
        # (dft.rfft_ri_partial clamps the same way)
        full = self.L // 2 + 1
        return min(self.fft_kmax, full) if self.fft_kmax is not None else full

    @property
    def n_records(self) -> int:
        return self.nsteps // self.record_every + 1

    @property
    def tracer_window(self) -> int:
        return int(self.tracer_window_time / self.dt)

    @property
    def solver_kind(self) -> str:
        if self.diffusion_solver == "banded":
            return "banded" if self.bc == "periodic" else "banded_dct"
        if self.diffusion_solver != "auto":
            return self.diffusion_solver
        if self.L > 8192:   # the dense L×L spectral matrix stops scaling
            return "banded" if self.bc == "periodic" else "banded_dct"
        return "fft" if self.bc == "periodic" else "dct"


class PDEParams(NamedTuple):
    """Runtime (vmappable) PDE parameters."""

    gamma: jnp.ndarray   # diffusion coefficient
    lam: jnp.ndarray     # active speed
    beta: jnp.ndarray


def make_pde_params(*, gamma: float = 2.33e-4, lam: float = 0.6,
                    beta: float = 2.0, dtype=jnp.float32) -> PDEParams:
    as_arr = lambda v: jnp.asarray(v, dtype=dtype)
    return PDEParams(gamma=as_arr(gamma), lam=as_arr(lam), beta=as_arr(beta))
