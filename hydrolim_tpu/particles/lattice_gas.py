"""Site-centric lattice-gas engine (K = 1 exclusion).

For unit site capacity the efficient state is per-site, not per-particle:
``occ ∈ {0, +1, −1}^L`` (0 = empty, ±1 = particle spin).  Every event channel
of the reference generator (PARTICLE_solver_CLASS.py:259-351 — CW flips,
symmetric diffusion hops, σ-directed active hops, exclusion) becomes pure
rolls + elementwise selects: no gathers, no scatters, no conflict ranking.

Conflict structure at K = 1: each occupied site proposes at most one move
(its single sampled event), so an empty site has at most two candidates —
from the left neighbour (moving right) and the right neighbour (moving
left).  A fair random bit per site resolves the tie, which is exactly the
two-candidate case of the particle engine's random-priority rule, so both
engines sample the same synchronous law.

Limits: K = 1 only, and no per-particle identity (displacement-based D_eff
needs the particle-centric engine or tagged tracers).  Densities, m-fields,
structure factors, blocking probability and COM velocity read directly off
the state.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from hydrolim_tpu.core.config import ParticleConfig, ParticleParams
from hydrolim_tpu.particles.run import substeps_for
from hydrolim_tpu.fields.magnetization import MFieldOp, build_mfield_op, local_m_field
from hydrolim_tpu.ops import dft


def _roll(x, shift):
    return jnp.roll(x, shift, axis=-1)


def lg_step(config: ParticleConfig, params: ParticleParams,
            mfield_op: MFieldOp, occ: jnp.ndarray, key: jnp.ndarray,
            dt: float):
    """One synchronous Δt step on the occupancy field (trailing axis = L,
    leading dims batch).

    Returns ``(occ_new, (moved_right, moved_left, flipped))`` — the per-site
    movement flags let tagged tracers follow their particles through the
    update (site → site±1), restoring particle-identity observables
    (v_eff/D_eff from displacements) to the site-centric engine."""
    assert config.site_capacity == 1
    L = config.L
    k_ev, k_tie = jax.random.split(key)
    is_occ = occ != 0
    is_plus = occ == 1
    sigma = occ.astype(jnp.float32)

    counts_p = is_plus.astype(jnp.float32)
    counts_m = (occ == -1).astype(jnp.float32)
    m_field = local_m_field(counts_p, counts_m, mfield_op,
                            sigma=config.local_kernel_sigma,
                            sigma_grid=config.sigma_grid,
                            periodic=config.periodic)

    flip_fn = config.flip_rate_fn or (lambda s, m, b: jnp.exp(-b * s * m))
    c = jnp.where(is_occ, flip_fn(sigma, m_field, params.beta), 0.0)

    # neighbour emptiness: target of a right-move from i is i+1
    right_empty = _roll(occ, -1) == 0          # occ[i+1] == 0
    left_empty = _roll(occ, 1) == 0            # occ[i-1] == 0
    if not config.periodic:
        idx = jnp.arange(L)
        right_empty = right_empty & (idx < L - 1)
        left_empty = left_empty & (idx > 0)

    # active hops: plus_forward → only σ=+1, always to the right;
    # bidirectional → σ-directed
    if config.active_model == "bidirectional":
        act_right = is_plus & right_empty
        act_left = (occ == -1) & left_empty
    else:
        act_right = is_plus & right_empty
        act_left = jnp.zeros_like(is_plus)

    r_right = (params.rate_diffusion * (is_occ & right_empty)
               + params.rate_active * act_right)
    r_left = (params.rate_diffusion * (is_occ & left_empty)
              + params.rate_active * act_left)

    # event draw per site: [left, right, flip] then nothing
    t1 = r_left * dt
    t2 = t1 + r_right * dt
    t3 = t2 + c * dt
    u = jax.random.uniform(k_ev, occ.shape, jnp.float32)
    ev_left = u < t1
    ev_right = (u >= t1) & (u < t2)
    ev_flip = (u >= t2) & (u < t3)

    # candidates into each site j: R_in from j−1 (its right-move),
    # L_in from j+1 (its left-move); fair tiebreak on double proposals
    R_in = _roll(ev_right, 1)
    L_in = _roll(ev_left, -1)
    if not config.periodic:
        idx = jnp.arange(L)
        R_in = R_in & (idx > 0)
        L_in = L_in & (idx < L - 1)
    empty = occ == 0
    tie = jax.random.bernoulli(k_tie, 0.5, occ.shape)
    acc_R = empty & R_in & (~L_in | tie)
    acc_L = empty & L_in & (~R_in | ~tie)

    gain = jnp.where(acc_R, _roll(occ, 1), 0) + jnp.where(acc_L, _roll(occ, -1), 0)
    moved_right = _roll(acc_R, -1)              # source i moved to i+1
    moved_left = _roll(acc_L, 1)                # source i moved to i−1
    lost = moved_right | moved_left
    kept = jnp.where(lost, 0, occ)
    flipped = ev_flip & ~lost
    kept = jnp.where(flipped, -kept, kept)
    return kept + gain, (moved_right, moved_left, flipped)


# Invalid-tracer sentinel for ``LatticeGasFrames.tracer_pos``.  Unwrapped
# positions are signed (a net-leftward walker crosses 0), so validity cannot
# ride the sign bit: INT32_MIN is outside every reachable position
# (|displacement| < 2^31 sites for any feasible run length).
TRACER_INVALID = np.int32(np.iinfo(np.int32).min)


def tracer_valid_mask(tracer_pos) -> np.ndarray:
    """Boolean mask of real (non-phantom) tracer entries."""
    return np.asarray(tracer_pos) != TRACER_INVALID


class LatticeGasFrames(NamedTuple):
    rho_p: jnp.ndarray     # (M, L)
    rho_m: jnp.ndarray     # (M, L)
    total: jnp.ndarray     # (M, L)
    m_local: jnp.ndarray   # (M, L)
    m_global: jnp.ndarray  # (M,)
    var: jnp.ndarray       # (M,)
    fft_amp: jnp.ndarray   # (M, L) or (M, 0)
    tracer_pos: jnp.ndarray  # (M, T) unwrapped sites (TRACER_INVALID = phantom)


def _lg_record(config: ParticleConfig, mfield_op: MFieldOp,
               occ: jnp.ndarray, record_fft: bool) -> LatticeGasFrames:
    counts_p = (occ == 1).astype(jnp.float32)
    counts_m = (occ == -1).astype(jnp.float32)
    return _lg_record_counts(config, mfield_op, counts_p, counts_m,
                             record_fft)


def _lg_record_counts(config: ParticleConfig, mfield_op: MFieldOp,
                      counts_p: jnp.ndarray, counts_m: jnp.ndarray,
                      record_fft: bool) -> LatticeGasFrames:
    """Frame observables from per-site counts (shared with the K>1 slot
    engine, lattice_gas_k.py)."""
    n_alive = jnp.maximum(counts_p.sum(-1) + counts_m.sum(-1), 1.0)
    denom = n_alive[..., None] * config.dx
    rho_p = counts_p / denom
    rho_m = counts_m / denom
    total = rho_p + rho_m
    m_local = local_m_field(counts_p, counts_m, mfield_op,
                            sigma=config.local_kernel_sigma,
                            sigma_grid=config.sigma_grid,
                            periodic=config.periodic)
    m_global = (counts_p.sum(-1) - counts_m.sum(-1)) / n_alive
    var = jnp.var(total, axis=-1)
    if record_fft:
        X = dft.rfft_ri(total)
        amp_h = jnp.sqrt(X[..., 0] ** 2 + X[..., 1] ** 2)
        # mirror to the full L-point amplitude spectrum like the recorder
        L = config.L
        body = jnp.flip(amp_h[..., 1:(L + 1) // 2], axis=-1)
        amp = jnp.concatenate([amp_h, body], axis=-1)
    else:
        amp = jnp.zeros(total.shape[:-1] + (0,), jnp.float32)
    return LatticeGasFrames(rho_p=rho_p, rho_m=rho_m, total=total,
                            m_local=m_local, m_global=m_global, var=var,
                            fft_amp=amp,
                            tracer_pos=jnp.zeros(total.shape[:-1] + (0,),
                                                 jnp.int32))


def _init_tracers(occ0: jnp.ndarray, key: jnp.ndarray, n_tracers: int):
    """Pick n_tracers random occupied sites.  Returns ``(sites, valid)`` —
    surplus tags (fewer occupied sites than n_tracers, e.g. sparse Poisson
    inits) are marked invalid instead of pointing at empty sites."""
    bits = jax.random.bits(key, occ0.shape, jnp.uint32) >> 1
    keys_arr = jnp.where(occ0 != 0, bits, jnp.uint32(0))
    vals, idx = jax.lax.top_k(keys_arr, n_tracers)
    return idx.astype(jnp.int32), vals > 0


@functools.partial(
    jax.jit, static_argnames=("config", "n_frames", "n_sub", "obs_dt",
                              "record_fft", "n_tracers"))
def _lg_scan(config: ParticleConfig, params: ParticleParams,
             occ0: jnp.ndarray, key: jnp.ndarray, *, n_frames: int,
             n_sub: int, obs_dt: float, record_fft: bool,
             n_tracers: int = 0):
    key, k_tr = jax.random.split(key)
    if n_tracers > 0:
        tr0, tr_valid = _init_tracers(occ0, k_tr, n_tracers)
    else:
        tr0 = jnp.zeros((0,), jnp.int32)
        tr_valid = jnp.zeros((0,), bool)
    wind0 = jnp.zeros_like(tr0)
    rec, frame_step = _make_lg_machinery(
        config, params, n_sub=n_sub, obs_dt=obs_dt, record_fft=record_fft,
        n_tracers=n_tracers, tr_valid=tr_valid)

    frame0 = rec(occ0, tr0, wind0)
    (occ, *_), rest = jax.lax.scan(
        frame_step, (occ0, tr0, wind0, key), None, length=n_frames - 1)
    frames = jax.tree.map(lambda a, b: jnp.concatenate([a[None], b], 0),
                          frame0, rest)
    return frames, occ


def _make_lg_machinery(config: ParticleConfig, params: ParticleParams, *,
                       n_sub: int, obs_dt: float, record_fft: bool,
                       n_tracers: int, tr_valid):
    """Frame recorder + scan body shared by :func:`_lg_scan` and the
    checkpointed range scan (utils/checkpoint.py) — no frame-index
    dependence, so chunked runs reproduce the unsplit scan bit-for-bit."""
    mfield_op = build_mfield_op(config.L, config.dx,
                                config.local_kernel_sigma, config.periodic)
    dt_eff = obs_dt / n_sub
    L = config.L

    def rec(occ, tr, wind):
        f = _lg_record(config, mfield_op, occ, record_fft)
        if n_tracers > 0:
            # invalid (phantom) tags record TRACER_INVALID — estimators mask
            f = f._replace(tracer_pos=jnp.where(tr_valid, tr + wind * L,
                                                TRACER_INVALID))
        return f

    def frame_step(carry, _):
        occ, tr, wind, key = carry

        def body(k, c):
            o, t, w, kk = c
            kk, sub = jax.random.split(kk)
            o, (mr, ml, _fl) = lg_step(config, params, mfield_op, o, sub,
                                       dt_eff)
            if n_tracers > 0:
                step_t = mr[t].astype(jnp.int32) - ml[t].astype(jnp.int32)
                raw = t + step_t
                if config.periodic:
                    t = jnp.where(raw < 0, raw + L,
                                  jnp.where(raw >= L, raw - L, raw))
                    w = w + jnp.where(raw < 0, -1,
                                      jnp.where(raw >= L, 1, 0))
                else:
                    t = raw
            return o, t, w, kk

        occ, tr, wind, key = jax.lax.fori_loop(
            0, n_sub, body, (occ, tr, wind, key))
        return (occ, tr, wind, key), rec(occ, tr, wind)

    return rec, frame_step


@functools.partial(
    jax.jit, static_argnames=("config", "n_sub", "obs_dt", "record_fft",
                              "n_tracers"))
def _lg_carry0(config: ParticleConfig, params_b: ParticleParams,
               occ0_b: jnp.ndarray, keys_b: jnp.ndarray, *, n_sub: int,
               obs_dt: float, record_fft: bool, n_tracers: int):
    """Batched initial scan carry + phantom-tracer mask + frame-0 record
    for the checkpointed K=1 driver — identical key handling to
    :func:`_lg_scan`."""
    def one(params, occ0, key):
        key, k_tr = jax.random.split(key)
        if n_tracers > 0:
            tr0, tr_valid = _init_tracers(occ0, k_tr, n_tracers)
        else:
            tr0 = jnp.zeros((0,), jnp.int32)
            tr_valid = jnp.zeros((0,), bool)
        wind0 = jnp.zeros_like(tr0)
        rec, _ = _make_lg_machinery(
            config, params, n_sub=n_sub, obs_dt=obs_dt,
            record_fft=record_fft, n_tracers=n_tracers, tr_valid=tr_valid)
        return (occ0, tr0, wind0, key), tr_valid, rec(occ0, tr0, wind0)

    return jax.vmap(one)(params_b, occ0_b, keys_b)


@functools.partial(
    jax.jit, static_argnames=("config", "length", "n_sub", "obs_dt",
                              "record_fft", "n_tracers"))
def _lg_scan_range(config: ParticleConfig, params_b: ParticleParams,
                   carry_b, tr_valid_b, *, length: int, n_sub: int,
                   obs_dt: float, record_fft: bool, n_tracers: int):
    """``length`` frames from a batched carry — same scan body as
    :func:`_lg_scan`; traced-length chunks share one compiled program."""
    def one(params, carry, tr_valid):
        _, frame_step = _make_lg_machinery(
            config, params, n_sub=n_sub, obs_dt=obs_dt,
            record_fft=record_fft, n_tracers=n_tracers, tr_valid=tr_valid)
        return jax.lax.scan(frame_step, carry, None, length=length)

    return jax.vmap(one)(params_b, carry_b, tr_valid_b)


def lg_init(config: ParticleConfig, key: jnp.ndarray,
            rho0_plus: Optional[np.ndarray] = None,
            rho0_minus: Optional[np.ndarray] = None) -> jnp.ndarray:
    """Occupancy init: 'fixed' = N uniform sites with random spins;
    'poisson' = per-site occupation probabilities from the intensity
    profiles truncated at K=1 (site occupied w.p. 1−exp(−(λ₊+λ₋)), spin +
    w.p. λ₊/(λ₊+λ₋))."""
    L = config.L
    k_site, k_spin = jax.random.split(key)
    if config.init == "fixed":
        pos = jax.random.permutation(k_site, L)[:config.N]
        spin = jnp.where(jax.random.bernoulli(k_spin, 0.5, (config.N,)),
                         1, -1).astype(jnp.int32)
        return jnp.zeros((L,), jnp.int32).at[pos].set(spin)
    lam_p = jnp.asarray(rho0_plus, jnp.float32)
    lam_m = jnp.asarray(rho0_minus, jnp.float32)
    tot = lam_p + lam_m
    occ_p = 1.0 - jnp.exp(-tot)
    occupied = jax.random.uniform(k_site, (L,)) < occ_p
    plus = jax.random.uniform(k_spin, (L,)) < lam_p / jnp.maximum(tot, 1e-12)
    return jnp.where(occupied, jnp.where(plus, 1, -1), 0).astype(jnp.int32)


def run_lattice_gas(config: ParticleConfig, params_b: ParticleParams,
                    key: jnp.ndarray, *, T: float, obs_dt: float, dt: float,
                    rho0_plus=None, rho0_minus=None,
                    record_fft: bool = True, n_tracers: int = 0,
                    occ_sharding=None):
    """Vmapped (batch of params) lattice-gas run; returns batched frames and
    final occupancies.  ``n_tracers > 0`` tags that many particles and
    records their unwrapped positions per frame (displacement estimators).

    ``occ_sharding``: optional ``NamedSharding`` placing the (B, L) occupancy
    on a device mesh — shard the trailing axis over a 'space' mesh axis for
    lattice parallelism (the ±1-stencil rolls lower to halo exchanges /
    collective-permutes under the XLA SPMD partitioner; see
    parallel/spatial.py and tests/test_spatial_sharding.py)."""
    B = params_b.beta.shape[0]
    keys = jax.random.split(key, B)
    init_keys = jax.vmap(lambda k: jax.random.fold_in(k, 0))(keys)
    occ0 = jax.vmap(lambda k: lg_init(config, k, rho0_plus, rho0_minus))(
        init_keys)
    if occ_sharding is not None:
        occ0 = jax.device_put(occ0, occ_sharding)
    n_frames = len(np.arange(0.0, T, obs_dt))
    n_sub = substeps_for(obs_dt, dt)
    run = lambda p, o, k: _lg_scan(config, p, o, k, n_frames=n_frames,
                                   n_sub=n_sub, obs_dt=obs_dt,
                                   record_fft=record_fft,
                                   n_tracers=n_tracers)
    return jax.vmap(run)(params_b, occ0, keys)
