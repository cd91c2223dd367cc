"""Observation-frame run loop for the particle engine.

Replaces ``ParticleSystem.run`` (PARTICLE_solver_CLASS.py:450-558).  The
reference advances one Gillespie event at a time and back-fills observation
frames whenever the event time crosses a frame boundary (:517-536).  Here the
frame grid ``times_obs = arange(0, T, obs_dt)`` is the outer ``lax.scan`` and
a fixed number of Δt sub-steps runs between frames, so every frame holds the
state at the first step time ≥ its frame time — the same frame semantics, and
the scan emits exactly the per-frame observable stack (on-device recording,
host transfer only at the end).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from hydrolim_tpu.core.config import ParticleConfig, ParticleParams
from hydrolim_tpu.ops import dft
from hydrolim_tpu.ops.segment import occupancy
from hydrolim_tpu.particles.init import ParticleState
from hydrolim_tpu.particles.stepper import StaticArrays, compute_m_field, step


class ParticleFrames(NamedTuple):
    """Per-frame observable stack — the `out` dict schema of the reference
    (:542-557) in array form (leading axis = observation frame)."""

    rho_p: jnp.ndarray            # (M, L)
    rho_m: jnp.ndarray            # (M, L)
    total: jnp.ndarray            # (M, L)
    m_local: jnp.ndarray          # (M, L)
    m_global: jnp.ndarray         # (M,)
    particle_count: jnp.ndarray   # (M,) int32
    rho_hat_ri: jnp.ndarray       # (M, L, 2) re/im of the density DFT
    fft_amp: jnp.ndarray          # (M, L)
    var: jnp.ndarray              # (M,)
    pos: jnp.ndarray              # (M, n_buf) int32  unwrapped (pos + wind·L)
    alive: jnp.ndarray            # (M, n_buf) bool
    bound: jnp.ndarray            # (M, n_buf) bool


class ParticleRunResult(NamedTuple):
    frames: ParticleFrames
    final_state: ParticleState


def _record_frame(config: ParticleConfig, statics: StaticArrays,
                  state: ParticleState, record_pos: bool,
                  record_fft: bool = True) -> ParticleFrames:
    L, dx = config.L, config.dx
    occ_total, counts_p, counts_m = occupancy(
        state.pos, state.sigma, state.alive, L)
    n_alive = jnp.sum(state.alive).astype(jnp.float32)
    denom = jnp.maximum(n_alive, 1.0) * dx             # (:207-209)
    rho_p = counts_p / denom
    rho_m = counts_m / denom
    total = rho_p + rho_m
    m_field = compute_m_field(config, statics, counts_p, counts_m)
    s_sum = jnp.sum(jnp.where(state.alive, state.sigma, 0)).astype(jnp.float32)
    m_global = s_sum / jnp.maximum(n_alive, 1.0)       # mean(sigma) (:498)
    if record_fft:
        u_hat = dft.fft_of_real_ri(total)
        amp = jnp.sqrt(u_hat[..., 0] ** 2 + u_hat[..., 1] ** 2)
    else:  # skip the spectrum (large frame arrays) for huge sweep grids
        u_hat = jnp.zeros((0, 2), jnp.float32)
        amp = jnp.zeros((0,), jnp.float32)
    var = jnp.var(total)
    if record_pos:
        pos_u = state.pos + state.wind * L
        alive = state.alive
        bound = state.bound
    else:
        pos_u = jnp.zeros((0,), jnp.int32)
        alive = jnp.zeros((0,), bool)
        bound = jnp.zeros((0,), bool)
    return ParticleFrames(
        rho_p=rho_p, rho_m=rho_m, total=total, m_local=m_field,
        m_global=m_global, particle_count=jnp.sum(state.alive, dtype=jnp.int32),
        rho_hat_ri=u_hat, fft_amp=amp, var=var, pos=pos_u, alive=alive,
        bound=bound)


def substeps_for(obs_dt: float, dt_target: float) -> int:
    """Δt sub-steps per observation frame, with a sanity bound: a garbage dt
    (e.g. from ``ensemble_dt`` at an absurd β, where the flip-rate bound
    e^β underflows dt to a denormal) would otherwise surface as a cryptic
    OverflowError deep inside lax.fori_loop lowering."""
    assert math.isfinite(dt_target) and dt_target > 0.0, (
        f"dt must be positive and finite, got {dt_target!r}")
    n = max(1, int(math.ceil(obs_dt / dt_target - 1e-9)))
    assert n <= 100_000_000, (
        f"{n} sub-steps per obs_dt frame (obs_dt={obs_dt!r}, "
        f"dt={dt_target!r}) — dt is implausibly small; check the rate/beta "
        "configuration passed to ensemble_dt")
    return n


def _make_frame_step(config, params, statics, n_sub: int, obs_dt: float,
                     rec):
    """Scan body shared by the full run and the checkpointed range run: a
    frame at global index ``frame_idx`` is the state after ``n_sub`` Δt
    sub-steps from frame ``frame_idx - 1``'s state."""
    dt_eff = obs_dt / n_sub

    def frame_step(state, frame_idx):
        t0 = (frame_idx.astype(jnp.float32) - 1.0) * obs_dt

        def body(k, st):
            return step(config, params, statics, st, dt_eff,
                        t0 + k * dt_eff)

        state = jax.lax.fori_loop(0, n_sub, body, state)
        return state, rec(state)

    return frame_step


@functools.partial(
    jax.jit,
    static_argnames=("config", "statics_builder", "n_frames", "n_sub",
                     "obs_dt", "record_pos", "record_fft"))
def _run_scan(config: ParticleConfig, params: ParticleParams,
              state0: ParticleState, *, statics_builder, n_frames: int,
              n_sub: int, obs_dt: float, record_pos: bool,
              record_fft: bool = True) -> ParticleRunResult:
    statics = statics_builder(config)
    rec = lambda st: _record_frame(config, statics, st, record_pos,
                                   record_fft)
    frame_step = _make_frame_step(config, params, statics, n_sub, obs_dt,
                                  rec)
    frame0 = rec(state0)
    final_state, frames_rest = jax.lax.scan(
        frame_step, state0, jnp.arange(1, n_frames))
    frames = jax.tree.map(
        lambda a, b: jnp.concatenate([a[None], b], axis=0), frame0,
        frames_rest)
    return ParticleRunResult(frames=frames, final_state=final_state)


@functools.partial(
    jax.jit,
    static_argnames=("config", "statics_builder", "length", "n_sub",
                     "obs_dt", "record_pos", "record_fft"))
def _run_scan_range(config: ParticleConfig, params: ParticleParams,
                    state: ParticleState, frame_lo: jnp.ndarray, *,
                    statics_builder, length: int, n_sub: int, obs_dt: float,
                    record_pos: bool, record_fft: bool = True
                    ) -> ParticleRunResult:
    """Frames ``[frame_lo, frame_lo + length)`` of the global frame grid
    (``frame_lo >= 1``), stepping from the carry state at frame
    ``frame_lo - 1``.  Identical scan body to :func:`_run_scan`, so a run
    split into ranges reproduces the unsplit trajectory bit-for-bit — the
    basis of the mid-run checkpoint driver (utils/checkpoint.py).

    ``frame_lo`` is a *traced* scalar (only the chunk ``length`` is a
    static arg), so every interior chunk of a checkpointed run reuses ONE
    compiled program — a per-chunk static start index would have
    recompiled ~n_frames/chunk times."""
    statics = statics_builder(config)
    rec = lambda st: _record_frame(config, statics, st, record_pos,
                                   record_fft)
    frame_step = _make_frame_step(config, params, statics, n_sub, obs_dt,
                                  rec)
    idx = jnp.asarray(frame_lo, jnp.int32) + jnp.arange(length, dtype=jnp.int32)
    final_state, frames = jax.lax.scan(frame_step, state, idx)
    return ParticleRunResult(frames=frames, final_state=final_state)


@functools.partial(
    jax.jit,
    static_argnames=("config", "statics_builder", "record_pos",
                     "record_fft"))
def _record_initial(config: ParticleConfig, state0: ParticleState, *,
                    statics_builder, record_pos: bool,
                    record_fft: bool = True) -> ParticleFrames:
    """Frame 0 (the initial state's observables) as a (1, ...) stack."""
    statics = statics_builder(config)
    f = _record_frame(config, statics, state0, record_pos, record_fft)
    return jax.tree.map(lambda a: a[None], f)


def run_particles(config: ParticleConfig, params: ParticleParams,
                  state0: ParticleState, *, T: float, obs_dt: float,
                  dt: float, record_pos: bool = True,
                  record_fft: bool = True) -> ParticleRunResult:
    """Run to time T recording frames every obs_dt.  ``dt`` is the (static)
    sub-step target; the effective step is obs_dt/ceil(obs_dt/dt) ≤ dt."""
    from hydrolim_tpu.particles.stepper import build_static_arrays

    times_obs = np.arange(0.0, T, obs_dt)
    n_frames = len(times_obs)
    if n_frames == 0:
        # T <= 0: a consistently EMPTY frame pytree (leading dim 0) against
        # the empty times_obs — _run_scan would still prepend frame0 and
        # return length-1 frames, an off-by-one for any times/frames zip
        res = _run_scan(config, params, state0,
                        statics_builder=build_static_arrays,
                        n_frames=1, n_sub=1, obs_dt=max(obs_dt, 1e-9),
                        record_pos=record_pos, record_fft=record_fft)
        return ParticleRunResult(
            frames=jax.tree.map(lambda a: a[:0], res.frames),
            final_state=state0)
    n_sub = substeps_for(obs_dt, dt)
    return _run_scan(config, params, state0,
                     statics_builder=build_static_arrays,
                     n_frames=n_frames, n_sub=n_sub, obs_dt=obs_dt,
                     record_pos=record_pos, record_fft=record_fft)
