"""Site-centric lattice-gas engine for general capacity K ≥ 1.

Round-1's site-centric engine (``lattice_gas.py``) is K = 1 only; the
reference's flagship single run uses ``site_capacity = 3``
(PARTICLE_solver_BIOLOGY_EXCLUSION.py:71,90) and fell back to the
particle-centric τ-leap at ~30× lower throughput.  This module generalizes
the site-centric state to per-site **slots**: ``slots ∈ {0, ±1}^(K, L)``
(slot axis first, lattice axis last; the K = 1 engine's occ^L is the
squeezed special case).

Event channels (the same generator as the reference rate assembly,
PARTICLE_solver_CLASS.py:259-351, restricted to the hop/flip channels — no
anchors/binding, which route to the particle-centric engine):

- CW flips  c = flip_rate_fn(σ, m(x), β) per occupied slot,
- symmetric diffusion hops with site-level freeness ``occ(x±1) < K``,
- σ-directed active hops (``plus_forward``: σ=+1 → right only, :317-319;
  ``bidirectional``: σ-directed both ways),
- optional crowding suppression ``(1 − occ(target)/K)`` (:322-336).

Conflict resolution under synchronous updates: each site j receives up to
2K candidates (right-movers of j−1, left-movers of j+1).  Every proposing
slot carries a unique random priority; site j admits the ``K − occ(j)``
smallest (pre-step occupancy, the same admission rule as the
particle-centric ``_resolve_conflicts``) via one small-axis sort of the
(2K, L) candidate matrix — no scatters, no gathers, pure rolls/sorts.

Slot compaction after the move keeps nonzero slots front-packed in a
deterministic (stable-argsort) order, which makes tagged-tracer identity
tracking exact: a tracer's new slot index is the number of nonzero entries
before its position in the [stayers | right-in | left-in] concatenation.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from hydrolim_tpu.core.config import ParticleConfig, ParticleParams
from hydrolim_tpu.particles.run import substeps_for
from hydrolim_tpu.fields.magnetization import MFieldOp, build_mfield_op, local_m_field
from hydrolim_tpu.particles.lattice_gas import (
    TRACER_INVALID,
    _lg_record_counts,
)

_UINT_MAX = np.uint32(0xFFFFFFFF)


def _roll(x, shift):
    return jnp.roll(x, shift, axis=-1)


def lgk_step(config: ParticleConfig, params: ParticleParams,
             mfield_op: MFieldOp, slots: jnp.ndarray, key: jnp.ndarray,
             dt: float, is_anchor: Optional[jnp.ndarray] = None):
    """One synchronous Δt step on the (K, L) slot field.

    Slot values: 0 = empty, ±1 = unbound particle (sign = spin), ±2 = bound
    particle.  With ``is_anchor`` (bool (L,)) the full reference channel set
    runs: bind (σ=−1, unbound, on anchor, occ<K incl. self — the K=1 quirk),
    unbind, anchored immobilization and absorbing exit
    (PARTICLE_solver_CLASS.py:307-312, 342-348).

    Returns ``(slots_new, (acc_right_src, acc_left_src, flipped, new_k),
    exiting)`` — movement/flip flags in the source layout, the destination
    slot-index map (tracer tracking), and the per-slot exit mask."""
    K, L = config.K, config.L
    assert slots.shape[-2:] == (K, L)
    k_ev, k_prio = jax.random.split(key)

    occupied = slots != 0
    bound = jnp.abs(slots) == 2
    spin = jnp.sign(slots)
    s_f = spin.astype(jnp.float32)
    counts_p = (slots > 0).sum(-2).astype(jnp.float32)
    counts_m = (slots < 0).sum(-2).astype(jnp.float32)
    occ_tot = counts_p + counts_m                      # (…, L)

    m_field = local_m_field(counts_p, counts_m, mfield_op,
                            sigma=config.local_kernel_sigma,
                            sigma_grid=config.sigma_grid,
                            periodic=config.periodic)

    flip_fn = config.flip_rate_fn or (lambda s, m, b: jnp.exp(-b * s * m))
    c = jnp.where(occupied, flip_fn(s_f, m_field[..., None, :], params.beta),
                  0.0)

    # site-level freeness of the ±1 targets (reference :299-305)
    right_free = _roll(occ_tot, -1) < K
    left_free = _roll(occ_tot, 1) < K
    if not config.periodic:
        idx = jnp.arange(L)
        right_free = right_free & (idx < L - 1)
        left_free = left_free & (idx > 0)

    r_dif = params.rate_diffusion
    r_act = params.rate_active
    is_plus = slots > 0
    is_minus = slots < 0

    rate_left = r_dif * (occupied & left_free[..., None, :])
    rate_right = r_dif * (occupied & right_free[..., None, :])
    if config.active_model == "bidirectional":
        act_right = is_plus & right_free[..., None, :]
        act_left = is_minus & left_free[..., None, :]
    else:  # plus_forward: only σ=+1 hops actively, to the right (:317-319)
        act_right = is_plus & right_free[..., None, :]
        act_left = jnp.zeros_like(is_plus)

    if config.crowding_suppresses_rates:
        rfrac = jnp.clip(1.0 - _roll(occ_tot, -1) / K, 0.0, 1.0)[..., None, :]
        lfrac = jnp.clip(1.0 - _roll(occ_tot, 1) / K, 0.0, 1.0)[..., None, :]
        rate_left = rate_left * lfrac
        rate_right = rate_right * rfrac
        rate_right = rate_right + r_act * act_right * rfrac
        rate_left = rate_left + r_act * act_left * lfrac
    else:
        rate_right = rate_right + r_act * act_right
        rate_left = rate_left + r_act * act_left

    # anchor channels (:262-267, :307-312, :342-348)
    rate_bind = rate_unbind = rate_exit = 0.0
    if is_anchor is not None:
        anc = is_anchor[None, :] if is_anchor.ndim == 1 else \
            is_anchor[..., None, :]
        if config.suppress_flip_when_bound:
            c = jnp.where(bound, 0.0, c)
        anchored = is_minus & anc & bound
        if config.immobilize_when_anchored:
            rate_left = jnp.where(anchored, 0.0, rate_left)
            rate_right = jnp.where(anchored, 0.0, rate_right)
            rate_exit = params.k_exit * anchored
        bind_ok = (~bound) & is_minus & anc & (occ_tot < K)[..., None, :]
        rate_bind = params.k_on * bind_ok
        rate_unbind = params.k_off * bound

    # per-slot event draw: [left, right, flip, bind, unbind, exit], nothing
    t1 = rate_left * dt
    t2 = t1 + rate_right * dt
    t3 = t2 + c * dt
    t4 = t3 + rate_bind * dt
    t5 = t4 + rate_unbind * dt
    t6 = t5 + rate_exit * dt
    u = jax.random.uniform(k_ev, slots.shape, jnp.float32)
    ev_left = u < t1
    ev_right = (u >= t1) & (u < t2)
    ev_flip = (u >= t2) & (u < t3)
    ev_bind = (u >= t3) & (u < t4)
    ev_unbind = (u >= t4) & (u < t5)
    ev_exit = (u >= t5) & (u < t6)

    # unique random priorities per slot (high bits random, low bits slot id)
    flat_n = K * L
    assert flat_n < (1 << 17), "slot priority pack supports K*L < 131072"
    bits = jax.random.bits(k_prio, slots.shape, jnp.uint32)
    slot_id = jnp.arange(flat_n, dtype=jnp.uint32).reshape(K, L)
    prio = (bits & jnp.uint32(0xFFFE0000)) | slot_id

    right_prio = jnp.where(ev_right, prio, _UINT_MAX)
    left_prio = jnp.where(ev_left, prio, _UINT_MAX)

    # candidates into site j: right-movers of j−1, left-movers of j+1.
    # Admission = the free-capacity smallest priorities; computed as K
    # rounds of a cross-slot min (decision-identical to a sort-and-threshold
    # under unique priorities, and cheaper than a jnp.sort)
    cand = jnp.concatenate([_roll(right_prio, 1), _roll(left_prio, -1)],
                           axis=-2)                      # (…, 2K, L)
    free = (K - occ_tot).astype(jnp.int32)               # (…, L)
    accept = jnp.zeros(cand.shape, bool)
    for r in range(K):
        cur_min = jnp.min(cand, axis=-2, keepdims=True)
        win = ((cand == cur_min) & (cand != _UINT_MAX)
               & (free > r)[..., None, :])
        accept = accept | win
        cand = jnp.where(win, _UINT_MAX, cand)
    acc_right_in = accept[..., :K, :]                    # arrived from j−1
    acc_left_in = accept[..., K:, :]                     # arrived from j+1

    # map back to source layout
    acc_right_src = _roll(acc_right_in, -1)
    acc_left_src = _roll(acc_left_in, 1)

    leaver = acc_right_src | acc_left_src
    exiting = ev_exit & ~leaver
    stay = jnp.where(leaver | exiting, 0, slots)
    flipped = ev_flip & ~leaver
    stay = jnp.where(flipped, -stay, stay)          # flip preserves bound
    stay = jnp.where(ev_bind & ~leaver, 2 * stay, stay)    # ±1 → ±2
    stay = jnp.where(ev_unbind & ~leaver, jnp.sign(stay), stay)  # ±2 → ±1

    right_in_spins = jnp.where(acc_right_in, _roll(slots, 1), 0)
    left_in_spins = jnp.where(acc_left_in, _roll(slots, -1), 0)
    combined = jnp.concatenate([stay, right_in_spins, left_in_spins],
                               axis=-2)                  # (…, 3K, L)

    # stable compaction: nonzero slots first, order preserved (cumsum-select
    # instead of argsort/take_along_axis — decision-identical, cheaper)
    nz = (combined != 0).astype(jnp.int32)
    nzb = jnp.cumsum(nz, axis=-2) - nz                   # exclusive count
    slots_new = jnp.stack(
        [jnp.sum(jnp.where((nz > 0) & (nzb == j), combined, 0), axis=-2)
         for j in range(K)], axis=-2)

    # tracer math: destination slot index = #nonzeros before the combined
    # position (stayers at q=k, right-in at q=K+k, left-in at q=2K+k)
    k_row = jnp.arange(K, dtype=jnp.int32)[..., :, None]
    new_k_stay = jnp.take_along_axis(nzb, k_row + jnp.zeros_like(slots), axis=-2)
    # for movers the relevant nzb lives at the *destination* site; express it
    # in source layout by rolling back
    new_k_right = _roll(jnp.take_along_axis(
        nzb, (K + k_row) + jnp.zeros_like(slots), axis=-2), -1)
    new_k_left = _roll(jnp.take_along_axis(
        nzb, (2 * K + k_row) + jnp.zeros_like(slots), axis=-2), 1)
    new_k = jnp.where(acc_right_src, new_k_right,
                      jnp.where(acc_left_src, new_k_left, new_k_stay))

    return slots_new, (acc_right_src, acc_left_src, flipped, new_k), exiting


# ---------------------------------------------------------------------------
# init / scan / run — mirrors lattice_gas.py's API
# ---------------------------------------------------------------------------

def slots_from_particles(config: ParticleConfig, pos: jnp.ndarray,
                         sigma: jnp.ndarray,
                         alive: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """(n,) particle arrays → (K, L) slot field (rank-within-site packing).

    Reuses the particle initializers (init.py) so both engines share the
    exact same initial laws."""
    K, L = config.K, config.L
    n = pos.shape[0]
    if alive is None:
        alive = jnp.ones((n,), bool)
    pos = jnp.where(alive, pos, L)                       # dead → OOB
    order = jnp.argsort(pos, stable=True)
    pos_s = pos[order]
    sig_s = jnp.where(alive[order], sigma[order], 0)
    counts = jnp.zeros((L + 1,), jnp.int32).at[pos_s].add(1)
    seg_start = jnp.cumsum(counts) - counts
    rank = jnp.arange(n, dtype=jnp.int32) - seg_start[pos_s].astype(jnp.int32)
    flat = jnp.zeros((K * (L + 1),), jnp.int32).at[
        jnp.clip(rank, 0, K - 1) * (L + 1) + pos_s].set(sig_s, mode="drop")
    return flat.reshape(K, L + 1)[:, :L]


def lgk_init(config: ParticleConfig, key: jnp.ndarray,
             rho0_plus: Optional[np.ndarray] = None,
             rho0_minus: Optional[np.ndarray] = None) -> jnp.ndarray:
    """Slot init through the particle initializers (same law, both modes)."""
    from hydrolim_tpu.particles.init import init_particles

    state = init_particles(config, key, rho0_plus=rho0_plus,
                           rho0_minus=rho0_minus)
    return slots_from_particles(config, state.pos, state.sigma, state.alive)


def _init_tracers_k(slots0: jnp.ndarray, key: jnp.ndarray, n_tracers: int):
    """Pick n_tracers distinct occupied (slot, site) flat indices.

    Returns ``(sites, slots, valid)`` — when fewer than n_tracers slots are
    occupied (e.g. a Poisson init realized < N particles), the surplus tags
    are marked invalid instead of silently pointing at empty slots (they
    would otherwise track phantom particles)."""
    K, L = slots0.shape
    bits = jax.random.bits(key, slots0.shape, jnp.uint32) >> 1
    keys_arr = jnp.where(slots0 != 0, bits, jnp.uint32(0))
    vals, idx = jax.lax.top_k(keys_arr.reshape(-1), n_tracers)
    return ((idx % L).astype(jnp.int32), (idx // L).astype(jnp.int32),
            vals > 0)


@functools.partial(
    jax.jit, static_argnames=("config", "n_frames", "n_sub", "obs_dt",
                              "record_fft", "n_tracers"))
def _lgk_scan(config: ParticleConfig, params: ParticleParams,
              slots0: jnp.ndarray, key: jnp.ndarray, *, n_frames: int,
              n_sub: int, obs_dt: float, record_fft: bool,
              n_tracers: int = 0):
    key, k_tr = jax.random.split(key)
    if n_tracers > 0:
        tr_site0, tr_slot0, tr_valid = _init_tracers_k(slots0, k_tr,
                                                       n_tracers)
    else:
        tr_site0 = jnp.zeros((0,), jnp.int32)
        tr_slot0 = jnp.zeros((0,), jnp.int32)
        tr_valid = jnp.zeros((0,), bool)
    wind0 = jnp.zeros_like(tr_site0)
    rec, frame_step = _make_lgk_machinery(
        config, params, n_sub=n_sub, obs_dt=obs_dt, record_fft=record_fft,
        n_tracers=n_tracers, tr_valid=tr_valid)

    frame0 = rec(slots0, tr_site0, wind0)
    (slots, *_), rest = jax.lax.scan(
        frame_step, (slots0, tr_site0, tr_slot0, wind0, key), None,
        length=n_frames - 1)
    frames = jax.tree.map(lambda a, b: jnp.concatenate([a[None], b], 0),
                          frame0, rest)
    return frames, slots


def _make_lgk_machinery(config: ParticleConfig, params: ParticleParams, *,
                        n_sub: int, obs_dt: float, record_fft: bool,
                        n_tracers: int, tr_valid):
    """Frame recorder + frame-step scan body shared by :func:`_lgk_scan`
    and the checkpointed range scan — the step has no frame-index
    dependence, so a run split into ranges reproduces the unsplit
    trajectory bit-for-bit.  ``tr_valid`` is the (static-per-run)
    phantom-tracer mask produced at tracer init."""
    mfield_op = build_mfield_op(config.L, config.dx,
                                config.local_kernel_sigma, config.periodic)
    dt_eff = obs_dt / n_sub
    K, L = config.K, config.L

    def rec(slots, tr_site, wind):
        counts_p = (slots > 0).sum(-2).astype(jnp.float32)   # incl. bound ±2
        counts_m = (slots < 0).sum(-2).astype(jnp.float32)
        f = _lg_record_counts(config, mfield_op, counts_p, counts_m,
                              record_fft)
        if n_tracers > 0:
            # invalid (phantom) tags record TRACER_INVALID — estimator masks
            f = f._replace(tracer_pos=jnp.where(tr_valid,
                                                tr_site + wind * L,
                                                TRACER_INVALID))
        return f

    def frame_step(carry, _):
        slots, tr_site, tr_slot, wind, key = carry

        def body(k, c):
            sl, ts, tk, w, kk = c
            kk, sub = jax.random.split(kk)
            sl, (mr, ml, _fl, new_k), _ex = lgk_step(config, params,
                                                     mfield_op, sl, sub,
                                                     dt_eff)
            if n_tracers > 0:
                flat = tk * L + ts
                moved_r = mr.reshape(-1)[flat]
                moved_l = ml.reshape(-1)[flat]
                tk = new_k.reshape(-1)[flat]
                step_t = moved_r.astype(jnp.int32) - moved_l.astype(jnp.int32)
                raw = ts + step_t
                if config.periodic:
                    ts = jnp.where(raw < 0, raw + L,
                                   jnp.where(raw >= L, raw - L, raw))
                    w = w + jnp.where(raw < 0, -1,
                                      jnp.where(raw >= L, 1, 0))
                else:
                    ts = raw
            return sl, ts, tk, w, kk

        slots, tr_site, tr_slot, wind, key = jax.lax.fori_loop(
            0, n_sub, body, (slots, tr_site, tr_slot, wind, key))
        return (slots, tr_site, tr_slot, wind, key), rec(slots, tr_site, wind)

    return rec, frame_step


@functools.partial(
    jax.jit, static_argnames=("config", "n_sub", "obs_dt", "record_fft",
                              "n_tracers"))
def _lgk_carry0(config: ParticleConfig, params_b: ParticleParams,
                slots0_b: jnp.ndarray, keys_b: jnp.ndarray, *, n_sub: int,
                obs_dt: float, record_fft: bool, n_tracers: int):
    """Batched initial scan carry + phantom-tracer mask + frame-0 record
    for the checkpointed slot-engine driver (utils/checkpoint.py) —
    identical key handling to :func:`_lgk_scan`."""
    def one(params, slots0, key):
        key, k_tr = jax.random.split(key)
        if n_tracers > 0:
            tr_site0, tr_slot0, tr_valid = _init_tracers_k(slots0, k_tr,
                                                           n_tracers)
        else:
            tr_site0 = jnp.zeros((0,), jnp.int32)
            tr_slot0 = jnp.zeros((0,), jnp.int32)
            tr_valid = jnp.zeros((0,), bool)
        wind0 = jnp.zeros_like(tr_site0)
        rec, _ = _make_lgk_machinery(
            config, params, n_sub=n_sub, obs_dt=obs_dt,
            record_fft=record_fft, n_tracers=n_tracers, tr_valid=tr_valid)
        carry0 = (slots0, tr_site0, tr_slot0, wind0, key)
        return carry0, tr_valid, rec(slots0, tr_site0, wind0)

    return jax.vmap(one)(params_b, slots0_b, keys_b)


@functools.partial(
    jax.jit, static_argnames=("config", "length", "n_sub", "obs_dt",
                              "record_fft", "n_tracers"))
def _lgk_scan_range(config: ParticleConfig, params_b: ParticleParams,
                    carry_b, tr_valid_b, *, length: int, n_sub: int,
                    obs_dt: float, record_fft: bool, n_tracers: int):
    """``length`` frames from a batched carry — same scan body as
    :func:`_lgk_scan` (via :func:`_make_lgk_machinery`), so chunked
    checkpointed runs reproduce the unsplit scan bit-for-bit.  The chunk
    length is the only shape-bearing static, so interior chunks share one
    compiled program."""
    def one(params, carry, tr_valid):
        _, frame_step = _make_lgk_machinery(
            config, params, n_sub=n_sub, obs_dt=obs_dt,
            record_fft=record_fft, n_tracers=n_tracers, tr_valid=tr_valid)
        return jax.lax.scan(frame_step, carry, None, length=length)

    return jax.vmap(one)(params_b, carry_b, tr_valid_b)


def run_lattice_gas_k(config: ParticleConfig, params_b: ParticleParams,
                      key: jnp.ndarray, *, T: float, obs_dt: float,
                      dt: float, rho0_plus=None, rho0_minus=None,
                      record_fft: bool = True, n_tracers: int = 0,
                      occ_sharding=None):
    """Vmapped (batch of params) K-capacity lattice-gas run; same return
    contract as ``run_lattice_gas`` (batched LatticeGasFrames + final slot
    fields).  ``occ_sharding`` places the (B, K, L) slot field on a mesh
    (shard the trailing lattice axis over a 'space' axis)."""
    assert config.exclusion, "lattice-gas engines require site_capacity"
    assert config.anchor_positions is None, (
        "anchors/binding route to the particle-centric engine (bind/unbind/"
        "exit channels are all gated on anchor sites, :307-312, :342-348)")
    B = params_b.beta.shape[0]
    keys = jax.random.split(key, B)
    init_keys = jax.vmap(lambda k: jax.random.fold_in(k, 0))(keys)
    if rho0_plus is not None and np.ndim(rho0_plus) == 2:
        # per-replica Poisson intensity profiles (the (N, β) double sweep:
        # N varies only through the intensities, one compiled program)
        slots0 = jax.vmap(lambda k, rp, rm: lgk_init(config, k, rp, rm))(
            init_keys, jnp.asarray(rho0_plus), jnp.asarray(rho0_minus))
    else:
        slots0 = jax.vmap(lambda k: lgk_init(config, k, rho0_plus,
                                             rho0_minus))(init_keys)
    if occ_sharding is not None:
        slots0 = jax.device_put(slots0, occ_sharding)
    n_frames = len(np.arange(0.0, T, obs_dt))
    n_sub = substeps_for(obs_dt, dt)
    run = lambda p, o, k: _lgk_scan(config, p, o, k, n_frames=n_frames,
                                    n_sub=n_sub, obs_dt=obs_dt,
                                    record_fft=record_fft,
                                    n_tracers=n_tracers)
    return jax.vmap(run)(params_b, slots0, keys)


# ---------------------------------------------------------------------------
# anchored runs: full channel set + absorbing-exit log
# ---------------------------------------------------------------------------

@functools.partial(
    jax.jit, static_argnames=("config", "n_frames", "n_sub", "obs_dt",
                              "record_fft"))
def _lgk_scan_anchored(config: ParticleConfig, params: ParticleParams,
                       slots0: jnp.ndarray, key: jnp.ndarray, *,
                       n_frames: int, n_sub: int, obs_dt: float,
                       record_fft: bool):
    """Scan with bind/unbind/immobilize/exit channels live and a fixed-size
    absorbing-exit log (exit time quantized to the step, like the particle
    engine's recorder)."""
    mfield_op = build_mfield_op(config.L, config.dx,
                                config.local_kernel_sigma, config.periodic)
    dt_eff = obs_dt / n_sub
    K, L = config.K, config.L
    E = config.n_exit_buf
    is_anchor = jnp.asarray(config.anchor_mask())
    sites_flat = jnp.arange(K * L, dtype=jnp.int32) % L

    def rec(slots):
        counts_p = (slots > 0).sum(-2).astype(jnp.float32)
        counts_m = (slots < 0).sum(-2).astype(jnp.float32)
        return _lg_record_counts(config, mfield_op, counts_p, counts_m,
                                 record_fft)

    def frame_step(carry, _):
        slots, key, t0, ec, et, ep = carry

        def body(k, c):
            sl, kk, t, ec, et, ep = c
            kk, sub = jax.random.split(kk)
            sl, _aux, exiting = lgk_step(config, params, mfield_op, sl, sub,
                                         dt_eff, is_anchor=is_anchor)
            exf = exiting.reshape(-1)
            n_new = jnp.sum(exf, dtype=jnp.int32)
            slot_idx = ec + jnp.cumsum(exf.astype(jnp.int32)) - 1
            write = exf & (slot_idx >= 0) & (slot_idx < E)
            w = jnp.where(write, slot_idx, E)                 # OOB drops
            et = et.at[w].set(jnp.where(write, t, jnp.nan), mode="drop")
            ep = ep.at[w].set(jnp.where(write, sites_flat, 0), mode="drop")
            return sl, kk, t + dt_eff, ec + n_new, et, ep

        slots, key, t0, ec, et, ep = jax.lax.fori_loop(
            0, n_sub, body, (slots, key, t0, ec, et, ep))
        return (slots, key, t0, ec, et, ep), rec(slots)

    carry0 = (slots0, key, jnp.float32(0.0), jnp.int32(0),
              jnp.full((E,), jnp.nan, jnp.float32),
              jnp.zeros((E,), jnp.int32))
    frame0 = rec(slots0)
    (slots, _k, _t, ec, et, ep), rest = jax.lax.scan(
        frame_step, carry0, None, length=n_frames - 1)
    frames = jax.tree.map(lambda a, b: jnp.concatenate([a[None], b], 0),
                          frame0, rest)
    return frames, slots, (ec, et, ep)


def run_lattice_gas_anchored(config: ParticleConfig,
                             params_b: ParticleParams, key: jnp.ndarray, *,
                             T: float, obs_dt: float, dt: float,
                             rho0_plus=None, rho0_minus=None,
                             record_fft: bool = True):
    """Vmapped anchored run (bind/unbind/immobilize/exit live).  Returns
    ``(frames, slots, (exit_count, exit_times, exit_pos))`` with batch-
    leading arrays; exit logs are fixed-size ``config.n_exit_buf`` buffers."""
    assert config.exclusion and config.anchor_positions is not None
    B = params_b.beta.shape[0]
    keys = jax.random.split(key, B)
    init_keys = jax.vmap(lambda k: jax.random.fold_in(k, 0))(keys)
    if rho0_plus is not None and np.ndim(rho0_plus) == 2:
        slots0 = jax.vmap(lambda k, rp, rm: lgk_init(config, k, rp, rm))(
            init_keys, jnp.asarray(rho0_plus), jnp.asarray(rho0_minus))
    else:
        slots0 = jax.vmap(lambda k: lgk_init(config, k, rho0_plus,
                                             rho0_minus))(init_keys)
    n_frames = len(np.arange(0.0, T, obs_dt))
    n_sub = substeps_for(obs_dt, dt)
    run = lambda p, o, k: _lgk_scan_anchored(
        config, p, o, k, n_frames=n_frames, n_sub=n_sub, obs_dt=obs_dt,
        record_fft=record_fft)
    return jax.vmap(run)(params_b, slots0, keys)
