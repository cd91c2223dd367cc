"""IMEX stepper for the hydrodynamic-limit PDE.

Re-design of ``IMEXPDE.step``/``solve`` (IMEX_PDE_solver_class.py:187-290) as
a pure jitted scan:

- implicit diffusion: spectral / dense solve (ops.diffusion) instead of two
  ``spsolve`` calls per step (:189-190),
- explicit upwind advection (:168-185) via rolls,
- Curie–Weiss reaction with clipped rates (:64-66, :199-201),
- positivity clip + total-mass renormalization (:229-233),
- embedded Euler–Maruyama tracer ensemble with windowed v_eff/D_eff
  (:256-287) kept in the scan carry as a circular displacement buffer.

The reference's ``anchored_minus`` branch CALLS the implicit solve twice per
step (:189-190 then :207-208 — SURVEY.md §2.4), but the second call reads
the unchanged ``self.rho_p/self.rho_m`` and overwrites the first call's
locals with an identical result — the quirk is wasted work, not ``A^-2``
composition, so the single solve here is bit-faithful.
``config.legacy_double_diffusion`` is accepted for API compatibility and is
a no-op (an earlier round misread the quirk as composition).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from hydrolim_tpu.core.config import PDEConfig, PDEParams
from hydrolim_tpu.fields.magnetization import SmoothOp, build_smooth_op, pde_magnetization
from hydrolim_tpu.ops import dft
from hydrolim_tpu.ops.convolve import periodic_gaussian_kernel
from hydrolim_tpu.ops.diffusion import DiffusionSolveOp, build_diffusion_op, diffusion_solve


class PDEOps(NamedTuple):
    """Per-config constant arrays for the jitted solve."""

    smooth: SmoothOp              # interaction-kernel smoothing operator
    dense_inv: jnp.ndarray        # (L, L) when solver_kind == 'dense', else (0,0)
    banded_w: jnp.ndarray         # (W,) when solver_kind is banded*, else (0,)


def build_pde_ops(config: PDEConfig, params: PDEParams) -> PDEOps:
    if config.gaussian_kernel:
        k = periodic_gaussian_kernel(config.L, config.dx, config.kernel_sigma)
        smooth = build_smooth_op(k)
    else:
        smooth = build_smooth_op(None)
    dense_inv = jnp.zeros((0, 0), jnp.float32)
    banded_w = jnp.zeros((0,), jnp.float32)
    kind = config.solver_kind
    if kind == "dense":
        op = build_diffusion_op(config.L, config.dx, config.dt,
                                float(np.asarray(params.gamma)), config.bc,
                                "dense")
        dense_inv = op.a_inv
    elif kind in ("banded", "banded_dct"):   # needs concrete gamma (host fft)
        op = build_diffusion_op(config.L, config.dx, config.dt,
                                float(np.asarray(params.gamma)), config.bc,
                                kind)
        banded_w = op.denom
    return PDEOps(smooth=smooth, dense_inv=dense_inv, banded_w=banded_w)


def _solve_op(config: PDEConfig, params: PDEParams, ops: PDEOps) -> DiffusionSolveOp:
    kind = config.solver_kind
    if kind == "dense":
        return DiffusionSolveOp(jnp.zeros((0,), jnp.float32), ops.dense_inv)
    if kind in ("banded", "banded_dct"):
        return DiffusionSolveOp(ops.banded_w, jnp.zeros((0, 0), jnp.float32))
    return build_diffusion_op(config.L, config.dx, config.dt, params.gamma,
                              config.bc, kind)


def cw_rate(sigma, m, beta):
    """Curie–Weiss flip rate with the reference's clipping (:64-66)."""
    return jnp.clip(jnp.exp(-beta * sigma * m), 1e-8, 1e8)


def upwind_derivative(rho: jnp.ndarray, direction: int, dx: float,
                      bc: str) -> jnp.ndarray:
    """One-sided difference (:168-185); trailing axis, batched."""
    if direction > 0:          # right-moving: backward difference
        d = (rho - jnp.roll(rho, 1, axis=-1)) / dx
        if bc == "neumann":
            d = d.at[..., 0].set(0.0)
        # periodic: roll already gives (rho[0]-rho[-1])/dx at index 0
    else:                      # left-moving: forward difference
        d = (jnp.roll(rho, -1, axis=-1) - rho) / dx
        if bc == "neumann":
            d = d.at[..., -1].set(0.0)
    return d


def magnetization(config: PDEConfig, ops: PDEOps, rho_p, rho_m):
    smooth = ops.smooth if config.gaussian_kernel else None
    return pde_magnetization(rho_p, rho_m, smooth,
                             kernel_sigma=config.kernel_sigma)


def pde_step(config: PDEConfig, params: PDEParams, ops: PDEOps,
             rho_p: jnp.ndarray, rho_m: jnp.ndarray, m=None):
    """One IMEX step (:187-233).

    ``m``: magnetization of the **pre-step** densities.  The reference
    evaluates the reaction rates at ``self.rho_p/self.rho_m`` before the
    implicit solve reassigns them (IMEX_PDE_solver_class.py:198,210), so the
    correct field is m(ρ(tₙ)) — computed here if not supplied.  ``pde_solve``
    passes the one per-iteration field shared with the recorder and the
    tracer update (the main fusion of the full-solve hot path; round-1 used
    post-diffusion densities, an undocumented O(dt) deviation)."""
    dt, dx, bc = config.dt, config.dx, config.bc
    sop = _solve_op(config, params, ops)
    kind = config.solver_kind
    if m is None:
        m = magnetization(config, ops, rho_p, rho_m)

    # one stacked solve for both species: halves the number of (small)
    # spectral matmuls per step
    both = jnp.stack([rho_p, rho_m], axis=-2)
    both1 = diffusion_solve(sop, both, kind)
    rho_p1 = both1[..., 0, :]
    rho_m1 = both1[..., 1, :]

    if config.active_model == "bidirectional":
        adv_p = -params.lam * upwind_derivative(rho_p1, +1, dx, bc)
        adv_m = +params.lam * upwind_derivative(rho_m1, -1, dx, bc)
        R_p = cw_rate(-1.0, m, params.beta) * rho_m1 - \
            cw_rate(+1.0, m, params.beta) * rho_p1
        rho_p2 = jnp.clip(rho_p1 + dt * (adv_p + R_p), 0.0, None)
        rho_m2 = jnp.clip(rho_m1 + dt * (adv_m - R_p), 0.0, None)
    else:  # anchored_minus: reaction first, then advection of rho_p only
        # NB the reference's "double solve" (:189-190 then :207-208) is a
        # no-op quirk, NOT A^-2: the second spsolve reads the UNCHANGED
        # self.rho_p/self.rho_m (the first solve wrote locals), so its
        # result is identical to the first — the reference applies single
        # diffusion and just pays the solve twice.  The single solve above
        # is therefore bit-faithful; `legacy_double_diffusion` is accepted
        # for API compatibility and changes nothing (an earlier round
        # misread the quirk as composition and applied A^-2 here).
        R_p = cw_rate(-1.0, m, params.beta) * rho_m1 - \
            cw_rate(+1.0, m, params.beta) * rho_p1
        rho_p_star = jnp.clip(rho_p1 + dt * R_p, 0.0, None)
        rho_m_star = jnp.clip(rho_m1 - dt * R_p, 0.0, None)
        adv_p = -params.lam * upwind_derivative(rho_p_star, +1, dx, bc)
        rho_p2 = jnp.clip(rho_p_star + dt * adv_p, 0.0, None)
        rho_m2 = rho_m_star

    # mass renormalization against the post-diffusion mass (:229-233)
    M0 = jnp.sum(rho_p1 + rho_m1, axis=-1, keepdims=True)
    M1 = jnp.sum(rho_p2 + rho_m2, axis=-1, keepdims=True)
    scale = M0 / jnp.maximum(M1, 1e-30)
    return rho_p2 * scale, rho_m2 * scale


# ---------------------------------------------------------------------------
# full solve with tracers + per-step observables
# ---------------------------------------------------------------------------

class TracerState(NamedTuple):
    pos: jnp.ndarray          # (n_tracers,) wrapped position in [0, xlim)
    unwrapped: jnp.ndarray    # (n_tracers,)
    spin: jnp.ndarray         # (n_tracers,) int32 ±1
    hist: jnp.ndarray         # (window, n_tracers) circular unwrapped buffer


class PDECarry(NamedTuple):
    rho_p: jnp.ndarray
    rho_m: jnp.ndarray
    tracers: TracerState
    key: jnp.ndarray


class PDERecord(NamedTuple):
    """Per-step observables (IMEX_PDE_solver_class.py:245-287)."""

    m_mean: jnp.ndarray
    var: jnp.ndarray
    fft_ri: jnp.ndarray       # (kmax, 2) re/im of rfft(total)/L
    v_eff: jnp.ndarray
    D_eff: jnp.ndarray


class PDESolveResult(NamedTuple):
    rho_p: jnp.ndarray
    rho_m: jnp.ndarray
    records: PDERecord        # leading axis nsteps+1
    snapshots: jnp.ndarray    # (n_snap, L) total density
    m_snapshots: jnp.ndarray  # (n_snap, L) rho_p - rho_m
    snap_times: jnp.ndarray   # (n_snap,)


def _tracer_update(config: PDEConfig, params: PDEParams, m_field,
                   tr: TracerState, key, n: jnp.ndarray):
    """CW spin flips + Euler–Maruyama advance + windowed v/D (:256-287).

    ``m_field`` is the per-iteration magnetization shared with the recorder
    and the IMEX step (one smoothing per iteration instead of three).

    Windowing note (intentional deviation): the slot about to be
    overwritten, ``hist[n % window]``, holds ``u_{n+1−window}`` (written
    ``window`` iterations ago), so reading it *before* the write gives a
    displacement spanning exactly ``window`` steps — matching the
    ``window·dt`` divisor.  The reference's ``tracer_history[-window]``
    (:280) spans ``window−1`` steps over the same divisor — a ~1/window
    (≈1–2%) systematic bias this implementation corrects rather than
    reproduces."""
    dt, dx, L = config.dt, config.dx, config.L
    window = config.tracer_window
    k_flip, k_noise = jax.random.split(key)

    idx = (tr.pos / dx).astype(jnp.int32) % L
    m_loc = m_field[idx]
    rate = cw_rate(tr.spin.astype(jnp.float32), m_loc, params.beta)
    flip_u = jax.random.uniform(k_flip, tr.spin.shape)
    flip = flip_u < rate * dt
    spin = jnp.where(flip, -tr.spin, tr.spin)

    v_loc = params.lam * spin.astype(jnp.float32)
    z = jax.random.normal(k_noise, tr.pos.shape)
    noise = jnp.sqrt(2.0 * params.gamma * dt) * z
    unwrapped = tr.unwrapped + v_loc * dt + noise
    pos = unwrapped % config.xlim

    old = tr.hist[n % window]           # u_{n+1-window}: window steps ago
    hist = tr.hist.at[n % window].set(unwrapped)
    dr = unwrapped - old
    mean_dr = jnp.mean(dr)
    var_dr = jnp.mean((dr - mean_dr) ** 2)
    valid = n >= window
    v_eff = jnp.where(valid, mean_dr / (window * dt), jnp.nan)
    D_eff = jnp.where(valid, var_dr / (2.0 * window * dt), jnp.nan)

    return TracerState(pos=pos, unwrapped=unwrapped, spin=spin, hist=hist), \
        v_eff, D_eff


def _make_block_fn(config: PDEConfig, params: PDEParams, ops: PDEOps):
    """Snapshot-block scan body shared by the full solve and the
    checkpointed range solve (utils/checkpoint.py) — iteration indices are
    global (``n0 = b * interval``), so a run split into block ranges
    reproduces the unsplit trajectory."""
    nsteps = config.nsteps
    interval = config.snapshot_interval
    kmax = config.kmax
    L = config.L

    def one_iter(carry: PDECarry, n):
        total = carry.rho_p + carry.rho_m
        m_field = magnetization(config, ops, carry.rho_p, carry.rho_m)
        # truncated (L, kmax) DFT slab, not the full (L, L/2+1) matrix:
        # identical values for the first kmax bins, and at large L the
        # full matrix is a program constant measured in hundreds of MB
        # (oversizes remote-compile payloads)
        fft_ri = dft.rfft_ri_partial(total, kmax) / L
        key, sub = jax.random.split(carry.key)
        tracers, v_eff, D_eff = _tracer_update(
            config, params, m_field, carry.tracers, sub, n)
        rec = PDERecord(m_mean=jnp.mean(m_field), var=jnp.var(total),
                        fft_ri=fft_ri, v_eff=v_eff, D_eff=D_eff)
        do_step = n < nsteps
        rho_p, rho_m = pde_step(config, params, ops, carry.rho_p,
                                carry.rho_m, m=m_field)
        rho_p = jnp.where(do_step, rho_p, carry.rho_p)
        rho_m = jnp.where(do_step, rho_m, carry.rho_m)
        return PDECarry(rho_p, rho_m, tracers, key), rec

    def block(carry: PDECarry, b):
        snap_total = carry.rho_p + carry.rho_m
        snap_m = carry.rho_p - carry.rho_m
        n0 = b * interval
        carry, recs = jax.lax.scan(
            one_iter, carry, n0 + jnp.arange(interval))
        return carry, (recs, snap_total, snap_m,
                       n0.astype(jnp.float32) * config.dt)

    return block


def _finalize_records(config: PDEConfig, recs, n_blocks: int):
    """Flatten per-block records, truncate the padded tail, thin to the
    record cadence.  Works on device arrays (inside pde_solve's jit) and on
    stitched host arrays (the checkpoint driver) alike."""
    n_iters = config.nsteps + 1
    interval = config.snapshot_interval
    recs = jax.tree.map(
        lambda a: a.reshape((n_blocks * interval,) + a.shape[2:])[:n_iters],
        recs)
    if config.record_every > 1:
        # thin the per-step series to config.n_records rows (every
        # record_every-th iteration, starting at n = 0) — dynamics are
        # unchanged, only the returned record cadence
        recs = jax.tree.map(lambda a: a[::config.record_every], recs)
    return recs


@functools.partial(jax.jit, static_argnames=("config",))
def pde_solve(config: PDEConfig, params: PDEParams, ops: PDEOps,
              rho_p0: jnp.ndarray, rho_m0: jnp.ndarray,
              tracers0: TracerState, key: jnp.ndarray) -> PDESolveResult:
    """Scan over snapshot blocks; inner scan over `snapshot_interval` steps.

    Iteration n ∈ [0, nsteps]: record observables at state n, update tracers,
    then step (skipped for n = nsteps), mirroring the reference loop
    (:242-290)."""
    n_blocks = math.ceil((config.nsteps + 1) / config.snapshot_interval)
    block = _make_block_fn(config, params, ops)
    carry0 = PDECarry(rho_p0, rho_m0, tracers0, key)
    carry, (recs, snaps, m_snaps, snap_times) = jax.lax.scan(
        block, carry0, jnp.arange(n_blocks))
    recs = _finalize_records(config, recs, n_blocks)
    return PDESolveResult(
        rho_p=carry.rho_p, rho_m=carry.rho_m, records=recs,
        snapshots=snaps, m_snapshots=m_snaps, snap_times=snap_times)


@functools.partial(jax.jit, static_argnames=("config", "length"))
def _pde_solve_range(config: PDEConfig, params: PDEParams, ops: PDEOps,
                     carry: PDECarry, block_lo: jnp.ndarray, *,
                     length: int):
    """Snapshot blocks ``[block_lo, block_lo + length)`` from a carry at
    block ``block_lo`` — identical scan body to :func:`pde_solve`, so a
    solve split into ranges reproduces the unsplit trajectory bit-for-bit
    (the basis of the PDE mid-run checkpoint driver, utils/checkpoint.py).
    ``block_lo`` is traced so interior chunks share one compiled program.
    Returns ``(carry, (recs, snaps, m_snaps, snap_times))`` with leading
    block axes, un-flattened."""
    block = _make_block_fn(config, params, ops)
    idx = jnp.asarray(block_lo, jnp.int32) + jnp.arange(length,
                                                        dtype=jnp.int32)
    return jax.lax.scan(block, carry, idx)
