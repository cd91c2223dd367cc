"""Synchronous fixed-Δt particle stepper.

This is the batched re-architecture of the reference's event-serial Gillespie
kernel (PARTICLE_solver_CLASS.py:254-448).  The *generator* — the per-particle
rate functions for all eight event channels — is kept identical; the sampling
scheme changes from one-event-per-iteration CTMC to a τ-leap: every particle
independently samples event ∈ {left, right, forward, flip, bind, unbind,
exit, nothing} with probabilities rate·Δt, and simultaneous hops that would
violate site capacity K are resolved by a random-priority rank pass.  As
Δt→0 this converges to the same law (SURVEY.md §7.1); Δt is chosen so the
per-particle event probability stays below ``config.max_event_prob``.

Rate channels (reference lines):
- flip  c = exp(−β·σ·m(pos)), zeroed when bound & suppress_flip_when_bound
  (:262-267)
- active forward hop: σ=+1 only, target free (:269-272, :317-319)
- diffusion left/right with exclusion-freeness and boundary masks (:283-305)
- anchored immobilization + exit rate k_exit (:307-312)
- crowding suppression (1 − occ/K) (:322-336)
- bind (σ=−1, on anchor, unbound, site below capacity) / unbind (:342-348)

Everything is a pure function of (state, params) with static shapes, so the
same compiled step serves single runs, vmapped replica ensembles, and
mesh-sharded sweep grids.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from hydrolim_tpu.core.config import ParticleConfig, ParticleParams
from hydrolim_tpu.fields.magnetization import MFieldOp, build_mfield_op, local_m_field
from hydrolim_tpu.ops.segment import masked_bincount, occupancy
from hydrolim_tpu.particles.init import ParticleState

# event codes
EV_NONE, EV_LEFT, EV_RIGHT, EV_FWD, EV_FLIP, EV_BIND, EV_UNBIND, EV_EXIT = range(8)


class StaticArrays(NamedTuple):
    """Per-config constant arrays threaded through the jitted step."""

    is_anchor_site: jnp.ndarray   # bool (L,)
    mfield_op: MFieldOp


def build_static_arrays(config: ParticleConfig) -> StaticArrays:
    return StaticArrays(
        is_anchor_site=jnp.asarray(config.anchor_mask()),
        mfield_op=build_mfield_op(config.L, config.dx,
                                  config.local_kernel_sigma, config.periodic),
    )


def compute_m_field(config: ParticleConfig, statics: StaticArrays,
                    counts_p: jnp.ndarray, counts_m: jnp.ndarray) -> jnp.ndarray:
    return local_m_field(
        counts_p, counts_m, statics.mfield_op,
        sigma=config.local_kernel_sigma, sigma_grid=config.sigma_grid,
        periodic=config.periodic)


def _default_flip_rate(sigma, m, beta):
    return jnp.exp(-beta * sigma * m)


def assemble_rates(config: ParticleConfig, params: ParticleParams,
                   state: ParticleState, m_field: jnp.ndarray,
                   occ_total: Optional[jnp.ndarray],
                   is_anchor_site: jnp.ndarray):
    """Per-particle rates for the 7 event channels — the same generator as
    the reference's rate assembly (PARTICLE_solver_CLASS.py:259-351), as one
    vectorized pure function.

    Returns ``(rates, targets)`` with ``rates`` of shape (n, 7) ordered
    [left, right, forward, flip, bind, unbind, exit] (dead particles zeroed)
    and ``targets = (left_raw, right_raw, fwd_raw, left_t, right_t, fwd_t)``
    (raw = pre-wrap positions for winding-number tracking)."""
    L = config.L
    pos, sigma, bound, alive = state.pos, state.sigma, state.bound, state.alive
    is_plus = sigma > 0

    flip_fn = config.flip_rate_fn or _default_flip_rate
    cvec = flip_fn(sigma.astype(jnp.float32), m_field[pos], params.beta)
    if config.suppress_flip_when_bound:
        cvec = jnp.where(bound, 0.0, cvec)

    if config.active_model == "bidirectional":
        fwd_raw = pos + sigma            # σ-directed hop for both spins
    else:  # 'plus_forward' (reference): σ=−1 takes a zero step (:276-277)
        fwd_raw = pos + is_plus.astype(jnp.int32)
    left_raw = pos - 1
    right_raw = pos + 1
    if config.periodic:
        fwd_t, left_t, right_t = fwd_raw % L, left_raw % L, right_raw % L
    else:
        fwd_t = jnp.clip(fwd_raw, 0, L - 1)
        left_t = jnp.clip(left_raw, 0, L - 1)
        right_t = jnp.clip(right_raw, 0, L - 1)
    same_fwd, same_left, same_right = fwd_t == pos, left_t == pos, right_t == pos

    if config.exclusion:
        K = float(config.K)
        fwd_free = (occ_total[fwd_t] < K) & ~same_fwd
        left_free = (occ_total[left_t] < K) & ~same_left
        right_free = (occ_total[right_t] < K) & ~same_right
    else:
        fwd_free, left_free, right_free = ~same_fwd, ~same_left, ~same_right

    if config.active_model == "bidirectional":
        r_act = jnp.where(fwd_free, params.rate_active, 0.0)
    else:
        # reference: only σ=+1 particles ever take active hops (:317-319)
        r_act = jnp.where(is_plus & fwd_free, params.rate_active, 0.0)
    r_left = params.rate_diffusion * left_free
    r_right = params.rate_diffusion * right_free

    r_exit = jnp.zeros_like(cvec)
    if config.immobilize_when_anchored:
        anchored = (~is_plus) & is_anchor_site[pos] & bound
        r_act = jnp.where(anchored, 0.0, r_act)
        r_left = jnp.where(anchored, 0.0, r_left)
        r_right = jnp.where(anchored, 0.0, r_right)
        r_exit = jnp.where(anchored, params.k_exit, 0.0)

    if config.crowding_suppresses_rates and config.exclusion:
        K = float(config.K)
        ffrac = jnp.clip(1.0 - occ_total[fwd_t] / K, 0.0, 1.0)
        lfrac = jnp.clip(1.0 - occ_total[left_t] / K, 0.0, 1.0)
        rfrac = jnp.clip(1.0 - occ_total[right_t] / K, 0.0, 1.0)
        r_act = r_act * ffrac
        r_left = params.rate_diffusion * left_free * lfrac
        r_right = params.rate_diffusion * right_free * rfrac
        if config.immobilize_when_anchored:
            r_left = jnp.where(anchored, 0.0, r_left)
            r_right = jnp.where(anchored, 0.0, r_right)

    # binding / unbinding (:342-348).  NB reference quirk reproduced: the
    # capacity gate tests occ_total[pos] < K with the particle itself
    # included in occ_total, so at K=1 binding is structurally impossible
    # (every particle's own site has occ >= 1) — the reference's anchored
    # experiment (:845-856, commented out) sets site_capacity=1 and would
    # produce zero binds/exits; run anchored configs at K >= 2
    # (experiments/run_anchored_exits.py uses K=3).
    if config.exclusion:
        below_cap = occ_total[pos] < float(config.K)
    else:
        below_cap = jnp.ones_like(is_plus)
    bind_ok = (~bound) & (~is_plus) & is_anchor_site[pos] & below_cap
    r_bind = jnp.where(bind_ok, params.k_on, 0.0)
    r_unbind = jnp.where(bound, params.k_off, 0.0)

    dead = ~alive
    z = lambda r: jnp.where(dead, 0.0, r)
    rates = jnp.stack([z(r_left), z(r_right), z(r_act), z(cvec),
                       z(r_bind), z(r_unbind), z(r_exit)], axis=-1)
    return rates, (left_raw, right_raw, fwd_raw, left_t, right_t, fwd_t)


def _resolve_conflicts(config: ParticleConfig, key: jnp.ndarray,
                       mover: jnp.ndarray, target: jnp.ndarray,
                       occ_total: jnp.ndarray) -> jnp.ndarray:
    """Random-priority acceptance of simultaneous hops under capacity K.

    A hop is accepted iff the particle's random rank among this step's
    proposals for its target site is below the site's free capacity at the
    start of the step (occupancy semantics identical to the reference's
    event-time check ``occ_total[target] < K`` (:299-301); swap chains are not
    granted, matching sequential Gillespie in the Δt→0 limit).

    For the practical capacities (K ≤ 8) the rank pass runs as K rounds of a
    segment-min scatter — each round admits the smallest-priority remaining
    proposal per site — which is much cheaper than the general O(n log n)
    multi-operand sort fallback."""
    n = mover.shape[0]
    L = config.L
    if config.K <= 8:
        return _resolve_conflicts_segmin(config, key, mover, target,
                                         occ_total)
    prio = jax.random.bits(key, (n,), jnp.uint32)
    tgt = jnp.where(mover, target, L).astype(jnp.int32)   # sentinel sorts last
    idx = jnp.arange(n, dtype=jnp.int32)
    tgt_s, _, idx_s = jax.lax.sort((tgt, prio, idx), num_keys=2)
    counts = masked_bincount(tgt, mover.astype(jnp.int32), L)
    seg_start = jnp.cumsum(counts) - counts
    safe_t = jnp.clip(tgt_s, 0, L - 1)
    rank = jnp.arange(n, dtype=jnp.int32) - seg_start[safe_t].astype(jnp.int32)
    free = (config.K - occ_total[safe_t]).astype(jnp.int32)
    accept_s = (rank < free) & (tgt_s < L)
    return jnp.zeros((n,), bool).at[idx_s].set(accept_s)


_UINT_MAX = np.uint32(0xFFFFFFFF)  # np, not jnp: a module-level jnp
# array would initialize JAX backends at import time (breaks the driver's
# jax_num_cpu_devices setup in dryrun_multichip)


def _resolve_conflicts_segmin(config: ParticleConfig, key: jnp.ndarray,
                              mover: jnp.ndarray, target: jnp.ndarray,
                              occ_total: jnp.ndarray) -> jnp.ndarray:
    """K rounds of segment-min admission (same law as the rank pass).

    Each particle carries a unique packed priority (15 random bits ‖ 17-bit
    index — unique, so the per-site argmin is well defined); round r admits
    the minimum-priority remaining proposal at every site with free
    capacity > r."""
    n = mover.shape[0]
    L = config.L
    assert n < (1 << 17), "segmin pass supports n_buf < 131072"
    bits = jax.random.bits(key, (n,), jnp.uint32)
    idx = jnp.arange(n, dtype=jnp.uint32)
    pack = (bits & jnp.uint32(0xFFFE0000)) | idx
    free = (config.K - occ_total[jnp.clip(target, 0, L - 1)]).astype(jnp.int32)
    accepted = jnp.zeros((n,), bool)
    for r in range(config.K):
        active = mover & ~accepted & (free > r)
        cand = jnp.where(active, pack, _UINT_MAX)
        site_min = jnp.full((L,), _UINT_MAX, jnp.uint32).at[target].min(
            cand, mode="drop")
        win = active & (cand == site_min[jnp.clip(target, 0, L - 1)])
        accepted = accepted | win
    return accepted


def _is_meanfield_fast_path(config: ParticleConfig) -> bool:
    """True when the step reduces to pure elementwise work: no exclusion
    (no occupancy/conflicts), global magnetization (no per-site field, no
    gather), no anchor sites (bind/unbind/exit channels are structurally
    zero — anchors gate all three, :307-312, :342-348), default CW flip
    rate.  This is the throughput-benchmark configuration
    (BASELINE.json: mean-field, N=1e5, β-sweep resident)."""
    return (not config.exclusion
            and config.local_kernel_sigma <= 0
            and config.anchor_positions is None
            and config.flip_rate_fn is None)


def _step_meanfield_global(config: ParticleConfig, params: ParticleParams,
                           state: ParticleState, dt: float) -> ParticleState:
    """Fused mean-field step: one uniform draw per particle, scalar flip
    rates (σ=±1 ⇒ only exp(∓βm) per replica), threshold comparisons, no
    gathers/scatters/stacked channel arrays."""
    L = config.L
    pos, sigma, alive = state.pos, state.sigma, state.alive
    n = pos.shape[0]
    key, k_ev = jax.random.split(state.key)

    s_sum = jnp.sum(jnp.where(alive, sigma, 0))
    n_alive = jnp.maximum(jnp.sum(alive), 1)
    m = s_sum.astype(jnp.float32) / n_alive.astype(jnp.float32)

    f32 = jnp.float32
    p_dif = params.rate_diffusion.astype(f32) * dt
    p_act = params.rate_active.astype(f32) * dt
    e_p = jnp.exp(-params.beta * m) * dt      # flip prob of a + particle
    e_m = jnp.exp(+params.beta * m) * dt      # flip prob of a − particle

    is_plus = sigma > 0
    u = jax.random.uniform(k_ev, (n,), f32)

    if config.periodic:
        left_ok = jnp.ones((n,), bool)
        right_ok = left_ok
        fwd_ok = left_ok
    else:
        left_ok = pos > 0
        right_ok = pos < L - 1
        if config.active_model == "bidirectional":
            fwd_ok = jnp.where(is_plus, pos < L - 1, pos > 0)
        else:
            fwd_ok = pos < L - 1

    t1 = jnp.where(left_ok, p_dif, 0.0)
    t2 = t1 + jnp.where(right_ok, p_dif, 0.0)
    if config.active_model == "bidirectional":
        p_act_i = jnp.where(fwd_ok, p_act, 0.0)
        fwd_dir = sigma
    else:  # plus_forward: only σ=+1 hop actively (:317-319)
        p_act_i = jnp.where(is_plus & fwd_ok, p_act, 0.0)
        fwd_dir = jnp.ones_like(sigma)
    t3 = t2 + p_act_i
    t4 = t3 + jnp.where(is_plus, e_p, e_m)

    mv_left = u < t1
    mv_right = (u >= t1) & (u < t2)
    mv_fwd = (u >= t2) & (u < t3)
    flip = (u >= t3) & (u < t4) & alive

    delta = (mv_right.astype(jnp.int32) - mv_left.astype(jnp.int32)
             + jnp.where(mv_fwd, fwd_dir, 0))
    delta = jnp.where(alive, delta, 0)
    raw = pos + delta
    if config.periodic:
        pos_new = jnp.where(raw < 0, raw + L, jnp.where(raw >= L, raw - L, raw))
        wind = state.wind + jnp.where(raw < 0, -1, jnp.where(raw >= L, 1, 0))
    else:
        pos_new = raw                          # blocked moves already masked
        wind = state.wind
    sigma_new = jnp.where(flip, -sigma, sigma)

    return state._replace(pos=pos_new, wind=wind, sigma=sigma_new, key=key)


def step(config: ParticleConfig, params: ParticleParams,
         statics: StaticArrays, state: ParticleState, dt: float,
         t: jnp.ndarray) -> ParticleState:
    """One synchronous Δt step: rates → per-particle event draw → conflict
    resolution → simultaneous apply."""
    if _is_meanfield_fast_path(config):
        return _step_meanfield_global(config, params, state, dt)
    L = config.L
    n = state.pos.shape[0]
    key, k_ev, k_prio = jax.random.split(state.key, 3)

    # fields
    need_counts = config.exclusion or config.local_kernel_sigma > 0
    if need_counts:
        occ_total, counts_p, counts_m = occupancy(
            state.pos, state.sigma, state.alive, L)
        m_field = compute_m_field(config, statics, counts_p, counts_m)
    else:
        occ_total = None
        s_sum = jnp.sum(jnp.where(state.alive, state.sigma, 0))
        n_alive = jnp.maximum(jnp.sum(state.alive), 1)
        m_global = s_sum.astype(jnp.float32) / n_alive.astype(jnp.float32)
        m_field = jnp.full((L,), m_global, jnp.float32)

    rates, targets = assemble_rates(config, params, state, m_field,
                                    occ_total, statics.is_anchor_site)
    left_raw, right_raw, fwd_raw, left_t, right_t, fwd_t = targets

    # event draw: u < cum(rates)*dt picks the channel
    cum = jnp.cumsum(rates, axis=-1) * dt              # (n, 7)
    u = jax.random.uniform(k_ev, (n,), jnp.float32)
    in_any = u < cum[..., -1]
    event = jnp.where(
        in_any,
        1 + jnp.sum((u[..., None] >= cum[..., :-1]), axis=-1, dtype=jnp.int32),
        EV_NONE)

    mover = (event == EV_LEFT) | (event == EV_RIGHT) | (event == EV_FWD)
    target = jnp.where(event == EV_LEFT, left_t,
                       jnp.where(event == EV_RIGHT, right_t, fwd_t))
    target_raw = jnp.where(event == EV_LEFT, left_raw,
                           jnp.where(event == EV_RIGHT, right_raw, fwd_raw))

    if config.exclusion:
        accept = _resolve_conflicts(config, k_prio, mover, target, occ_total)
    else:
        accept = mover
    moved = mover & accept

    pos = jnp.where(moved, target, state.pos)
    if config.periodic:
        wind = state.wind + jnp.where(
            moved, (target_raw // L).astype(jnp.int32), 0)
    else:
        wind = state.wind
    sigma = jnp.where(event == EV_FLIP, -state.sigma, state.sigma)
    bound = jnp.where(event == EV_BIND, True,
                      jnp.where(event == EV_UNBIND, False, state.bound))

    # exits: absorb + append to the fixed-size exit log (:424-436)
    exiting = (event == EV_EXIT) & state.alive
    alive = state.alive & ~exiting
    n_exit = jnp.sum(exiting, dtype=jnp.int32)
    slot = state.exit_count + jnp.cumsum(exiting.astype(jnp.int32)) - 1
    E = config.n_exit_buf
    write = exiting & (slot >= 0) & (slot < E)
    wslot = jnp.where(write, slot, E)                  # OOB drops
    exit_times = state.exit_times.at[wslot].set(
        jnp.where(write, t, jnp.nan), mode="drop")
    exit_pos = state.exit_pos.at[wslot].set(
        jnp.where(write, state.pos, 0), mode="drop")
    exit_init_bin = state.exit_init_bin.at[wslot].set(
        jnp.where(write, state.init_bin, 0), mode="drop")

    return ParticleState(
        pos=pos, wind=wind, sigma=sigma, bound=bound, alive=alive,
        init_bin=state.init_bin, key=key,
        exit_count=state.exit_count + n_exit,
        exit_times=exit_times, exit_pos=exit_pos,
        exit_init_bin=exit_init_bin)
