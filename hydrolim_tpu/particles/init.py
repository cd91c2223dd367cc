"""Particle initializers.

Re-designs of ``_init_fixed`` / ``_init_poisson``
(PARTICLE_solver_CLASS.py:141-189) as static-shape JAX programs over a padded
particle buffer with an alive-mask (no variable-length arrays):

- ``fixed`` with K=1: N distinct sites uniformly without replacement — same
  law as the reference (:145).
- ``fixed`` with K>1: uniform choice of N slots among the L·K capacity slots.
  (The reference fills sequentially, choosing uniformly among *sites* with
  remaining capacity (:149-156) — a slightly different law; the slot-uniform
  law is exchangeable, vectorizes, and agrees for K=1 and in the dilute
  limit.  Documented deviation, SURVEY.md §2.4 policy.)
- ``poisson``: per-site Poisson draws from ρ₀±(x), truncated to capacity K by
  an exact hypergeometric split of the K kept labels (:160-189).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hydrolim_tpu.core.config import ParticleConfig


class ParticleState(NamedTuple):
    """Pytree state of a particle ensemble (all static shapes).

    ``pos`` is the wrapped lattice site; ``wind`` counts periodic windings so
    ``pos + wind·L`` is the unwrapped trajectory used by displacement
    statistics.  ``init_bin`` records the birth site (PARTICLE_solver_CLASS
    .py:481 — the reference's ``floor(pos/L·L)`` is the identity)."""

    pos: jnp.ndarray        # int32 (n_buf,)
    wind: jnp.ndarray       # int32 (n_buf,)
    sigma: jnp.ndarray      # int32 (n_buf,) in {+1,-1}
    bound: jnp.ndarray      # bool  (n_buf,)
    alive: jnp.ndarray      # bool  (n_buf,)
    init_bin: jnp.ndarray   # int32 (n_buf,)
    key: jnp.ndarray        # PRNG key
    exit_count: jnp.ndarray  # int32 scalar
    exit_times: jnp.ndarray  # f32 (n_exit_buf,)
    exit_pos: jnp.ndarray    # int32 (n_exit_buf,)
    exit_init_bin: jnp.ndarray  # int32 (n_exit_buf,)


def _empty_exit_log(config: ParticleConfig):
    E = config.n_exit_buf
    return (jnp.zeros((), jnp.int32),
            jnp.full((E,), jnp.nan, jnp.float32),
            jnp.zeros((E,), jnp.int32),
            jnp.zeros((E,), jnp.int32))


def init_fixed(config: ParticleConfig, key: jnp.ndarray) -> ParticleState:
    n_buf = config.n_buf
    N = config.N
    k_pos, k_sig, k_next = jax.random.split(key, 3)
    if config.exclusion:
        K = config.K
        slots = jax.random.permutation(k_pos, config.L * K)[:N]
        pos_n = (slots // K).astype(jnp.int32)
    else:
        pos_n = jax.random.randint(k_pos, (N,), 0, config.L, dtype=jnp.int32)
    pos = jnp.zeros((n_buf,), jnp.int32).at[:N].set(pos_n)
    sigma = jnp.where(
        jax.random.bernoulli(k_sig, 0.5, (n_buf,)), 1, -1).astype(jnp.int32)
    alive = jnp.arange(n_buf) < N
    ec, et, ep, eb = _empty_exit_log(config)
    return ParticleState(
        pos=pos, wind=jnp.zeros((n_buf,), jnp.int32), sigma=sigma,
        bound=jnp.zeros((n_buf,), bool), alive=alive, init_bin=pos,
        key=k_next, exit_count=ec, exit_times=et, exit_pos=ep,
        exit_init_bin=eb)


def _hypergeom_keep_plus(key, cp, cm, K: int):
    """Exact sample of the number of '+' labels among K kept out of cp '+'
    and cm '−' labels (uniform subset), vectorized per site.

    P(j) ∝ C(cp, j)·C(cm, K−j); computed in log space with gammaln."""
    from jax.scipy.special import gammaln

    j = jnp.arange(K + 1, dtype=jnp.float32)          # (K+1,)
    cp_f = cp.astype(jnp.float32)[..., None]
    cm_f = cm.astype(jnp.float32)[..., None]
    Kf = jnp.float32(K)

    def log_c(n, r):
        valid = (r >= 0) & (r <= n)
        safe_r = jnp.clip(r, 0.0, jnp.maximum(n, 0.0))
        v = (gammaln(n + 1.0) - gammaln(safe_r + 1.0)
             - gammaln(n - safe_r + 1.0))
        return jnp.where(valid, v, -jnp.inf)

    logits = log_c(cp_f, j) + log_c(cm_f, Kf - j)     # (..., K+1)
    return jax.random.categorical(key, logits, axis=-1).astype(jnp.int32)


def init_poisson(config: ParticleConfig, key: jnp.ndarray,
                 rho0_plus: jnp.ndarray, rho0_minus: jnp.ndarray,
                 ) -> ParticleState:
    """``rho0_plus/minus`` are per-site mean-count arrays (L,) — the
    reference evaluates the user callables on the grid (:71-72)."""
    L, n_buf = config.L, config.n_buf
    k_p, k_m, k_h, k_thin, k_next = jax.random.split(key, 5)
    cp = jax.random.poisson(k_p, rho0_plus, (L,)).astype(jnp.int32)
    cm = jax.random.poisson(k_m, rho0_minus, (L,)).astype(jnp.int32)

    if config.exclusion:
        K = config.K
        tot = cp + cm
        over = tot > K
        kp_trunc = _hypergeom_keep_plus(k_h, cp, cm, K)
        kp = jnp.where(over, kp_trunc, cp)
        km = jnp.where(over, K - kp_trunc, cm)
    else:
        kp, km = cp, cm

    # Buffer-overflow guard: if the Poisson total exceeds n_buf,
    # jnp.repeat's total_repeat_length truncation would drop particles from
    # the high-x end specifically (sites materialize in index order) — a
    # spatially biased loss.  Thin every site binomially to an expected
    # total of n_buf first, so the loss is uniform across the profile; the
    # residual truncation then only removes an O(√n_buf) random tail.
    n_draw = jnp.sum(kp + km)
    p_keep = jnp.minimum(1.0, n_buf / jnp.maximum(n_draw, 1).astype(
        jnp.float32))
    k_tp, k_tm = jax.random.split(k_thin)
    kp = jnp.where(n_draw > n_buf,
                   jax.random.binomial(k_tp, kp.astype(jnp.float32),
                                       p_keep).astype(jnp.int32), kp)
    km = jnp.where(n_draw > n_buf,
                   jax.random.binomial(k_tm, km.astype(jnp.float32),
                                       p_keep).astype(jnp.int32), km)

    counts = kp + km
    n_total = jnp.sum(counts)
    # materialize: site index repeated by counts, padded to n_buf
    pos = jnp.repeat(jnp.arange(L, dtype=jnp.int32), counts,
                     total_repeat_length=n_buf)
    start = jnp.cumsum(counts) - counts                # exclusive cumsum
    rank = jnp.arange(n_buf, dtype=jnp.int32) - start[pos]
    sigma = jnp.where(rank < kp[pos], 1, -1).astype(jnp.int32)
    alive = jnp.arange(n_buf) < n_total
    ec, et, ep, eb = _empty_exit_log(config)
    return ParticleState(
        pos=pos, wind=jnp.zeros((n_buf,), jnp.int32), sigma=sigma,
        bound=jnp.zeros((n_buf,), bool), alive=alive, init_bin=pos,
        key=k_next, exit_count=ec, exit_times=et, exit_pos=ep,
        exit_init_bin=eb)


def init_particles(config: ParticleConfig, key: jnp.ndarray,
                   rho0_plus: Optional[jnp.ndarray] = None,
                   rho0_minus: Optional[jnp.ndarray] = None) -> ParticleState:
    """Dispatch on ``config.init`` (PARTICLE_solver_CLASS.py:191-195).

    Note: like the reference (SURVEY.md §2.4), ``init='fixed'`` ignores the
    ρ₀ callables even when provided."""
    if config.init == "fixed":
        return init_fixed(config, key)
    assert rho0_plus is not None and rho0_minus is not None, (
        "poisson init requires rho0_plus/rho0_minus profiles")
    return init_poisson(config, key, jnp.asarray(rho0_plus, jnp.float32),
                        jnp.asarray(rho0_minus, jnp.float32))


def eval_profile(fn, L: int) -> np.ndarray:
    """Evaluate a reference-style ρ₀ callable on the grid i/L
    (PARTICLE_solver_CLASS.py:71-72)."""
    return np.array([float(fn(i / L)) for i in range(L)], dtype=np.float32)
