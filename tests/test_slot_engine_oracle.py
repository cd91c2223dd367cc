"""The K-slot exclusion engine (particles/lattice_gas_k.py) — the one engine
behind every exclusion sweep — against the exact CTMC oracle
(runtime/gillespie.cpp) over the configuration grid the sweeps use:
{periodic, walls} × {plus_forward, bidirectional} × K ∈ {1, 3, 8} ×
{global, narrow local m}; plus its invariants on seeded random configs."""
import shutil

import jax
import numpy as np
import pytest

from hydrolim_tpu.core.config import ParticleConfig, make_particle_params
from hydrolim_tpu.particles.init import init_particles
from hydrolim_tpu.particles.lattice_gas_k import run_lattice_gas_k
from hydrolim_tpu.sweeps.ensemble import broadcast_params

L = 32
#: particles per site for each capacity — exclusion pressure at every K
DENSITY = {1: 0.5, 3: 1.5, 8: 4.0}


def _occupancy_histogram(occ, K):
    """(runs, K+1) per-run fraction of sites holding v particles."""
    return np.stack([(occ == v).mean(axis=-1) for v in range(K + 1)], -1)


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
@pytest.mark.parametrize("m_field", ["global", "narrow"])
@pytest.mark.parametrize("K", [1, 3, 8])
@pytest.mark.parametrize("model", ["plus_forward", "bidirectional"])
@pytest.mark.parametrize("periodic", [True, False], ids=["periodic", "walls"])
def test_slot_engine_matches_exact_ctmc(periodic, model, K, m_field):
    """Ensemble ⟨|m|(t)⟩ (through the ordering transient, where a wrong
    flip rate shows) and the final site-occupancy histogram of the slot
    engine agree with the exact CTMC within 4 combined standard errors
    (plus the τ-leap's O(dt) allowance)."""
    from hydrolim_tpu.runtime.native import run_exact_gillespie

    N = int(DENSITY[K] * L)
    T, obs_dt, beta, n_runs = 4.0, 1.0, 1.5, 32
    config = ParticleConfig(
        L=L, N=N, n_pad=N, init="fixed", scale_rates=False,
        local_kernel_sigma=0.0 if m_field == "global" else 2.0 / L,
        periodic=periodic, site_capacity=K, active_model=model)
    rates = dict(rate_diffusion=1.0, rate_active=2.0)
    params = make_particle_params(config, beta=beta, k_on=0, k_off=0,
                                  k_exit=0, **rates)
    m_exact, occ_exact = [], []
    for r in range(n_runs):
        st = init_particles(config, jax.random.PRNGKey(500 + r))
        out = run_exact_gillespie(config, params, np.asarray(st.pos),
                                  np.asarray(st.sigma), T=T, obs_dt=obs_dt,
                                  seed=1000 + r)
        m_exact.append(out["m_global"])
        occ_exact.append(out["counts_p"][-1] + out["counts_m"][-1])
    m_exact = np.abs(np.asarray(m_exact))

    params_b = broadcast_params(config, beta=[beta], n_runs=n_runs, **rates)
    frames, slots = run_lattice_gas_k(config, params_b, jax.random.PRNGKey(7),
                                      T=T, obs_dt=obs_dt, dt=2e-3,
                                      record_fft=False)
    m_tau = np.abs(np.asarray(frames.m_global))
    occ_tau = np.abs(np.asarray(slots)).sum(-2)

    se = lambda a: a.std(axis=0, ddof=1) / np.sqrt(n_runs)
    me, mt = m_exact.mean(axis=0), m_tau.mean(axis=0)
    assert np.all(np.abs(me - mt) < 4 * np.hypot(se(m_exact), se(m_tau))
                  + 0.03), (me, mt)
    h_e = _occupancy_histogram(np.asarray(occ_exact), K)
    h_t = _occupancy_histogram(occ_tau, K)
    assert np.all(np.abs(h_e.mean(0) - h_t.mean(0))
                  < 4 * np.hypot(se(h_e), se(h_t)) + 0.02), (
        h_e.mean(0), h_t.mean(0))


def _draw_config(seed):
    rng = np.random.default_rng(seed)
    L_ = int(rng.choice([24, 40, 64]))
    K = int(rng.integers(1, 9))
    N = int(rng.uniform(0.2, 0.9) * K * L_)
    config = ParticleConfig(
        L=L_, N=N, init="fixed", scale_rates=False,
        local_kernel_sigma=float(rng.choice([0.0, 2.0 / L_, 0.2])),
        periodic=bool(rng.random() < 0.5), site_capacity=K,
        active_model=str(rng.choice(["plus_forward", "bidirectional"])))
    beta = rng.uniform(0.0, 3.0, 3)
    rates = dict(rate_diffusion=float(rng.uniform(0.0, 1.0)),
                 rate_active=float(rng.uniform(0.5, 6.0)))
    return config, beta, rates


@pytest.mark.parametrize("seed", range(6))
def test_slot_engine_invariants_fuzzed(seed):
    """Seeded random configs: occupancy ≤ K and exact particle conservation
    in every frame, m_global equal to the signed count, every particle a
    valid tracer, and the final slot field holding exactly N spins."""
    from hydrolim_tpu.particles.lattice_gas import tracer_valid_mask
    from hydrolim_tpu.sweeps.ensemble import ensemble_dt

    config, beta, rates = _draw_config(seed)
    N, K, L_ = config.N, config.K, config.L
    params = broadcast_params(config, beta=beta, **rates)
    dt = ensemble_dt(config, beta_max=float(beta.max()), **rates)
    frames, slots = jax.device_get(run_lattice_gas_k(
        config, params, jax.random.PRNGKey(seed), T=1.0, obs_dt=0.25, dt=dt,
        n_tracers=N))
    cp = np.asarray(frames.rho_p, np.float64) * N * config.dx
    cm = np.asarray(frames.rho_m, np.float64) * N * config.dx
    for c in (cp, cm):
        np.testing.assert_allclose(c, np.rint(c), atol=1e-3)
    cp, cm = np.rint(cp), np.rint(cm)
    assert (cp + cm).max() <= K
    assert np.all((cp + cm).sum(-1) == N)
    np.testing.assert_allclose(np.asarray(frames.m_global),
                               (cp.sum(-1) - cm.sum(-1)) / N, atol=1e-6)
    assert np.all(np.abs(np.asarray(frames.m_local)) <= 1 + 1e-6)
    tr = np.asarray(frames.tracer_pos)
    assert tracer_valid_mask(tr).all()
    if not config.periodic:
        assert tr.min() >= 0 and tr.max() < L_
    slots = np.asarray(slots)
    assert set(np.unique(slots)) <= {-1, 0, 1}
    assert (slots != 0).sum(axis=(-2, -1)).tolist() == [N] * len(beta)
    assert (slots != 0).sum(-2).max() <= K
