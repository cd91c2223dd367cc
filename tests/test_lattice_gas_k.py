"""K>1 site-centric lattice-gas engine (lattice_gas_k): invariants, exact
per-step identity tracking, K=1 cross-engine law agreement, and τ-leap vs
exact-CTMC agreement at the flagship capacity K=3
(/root/reference/PARTICLE_solver_BIOLOGY_EXCLUSION.py:71,90)."""
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from hydrolim_tpu.core.config import ParticleConfig, make_particle_params
from hydrolim_tpu.fields.magnetization import build_mfield_op
from hydrolim_tpu.particles.lattice_gas import run_lattice_gas
from hydrolim_tpu.particles.lattice_gas_k import lgk_init, lgk_step, run_lattice_gas_k
from hydrolim_tpu.sweeps.ensemble import broadcast_params


def _config(**over):
    kw = dict(L=64, N=80, init="fixed", scale_rates=False,
              local_kernel_sigma=0.0, periodic=True, site_capacity=3,
              active_model="plus_forward")
    kw.update(over)
    return ParticleConfig(**kw)


def test_conservation_and_capacity_k3():
    config = _config()
    params = broadcast_params(config, beta=[1.0, 2.0], rate_diffusion=1.0,
                              rate_active=2.0, n_runs=2)
    frames, slots = run_lattice_gas_k(config, params, jax.random.PRNGKey(0),
                                      T=2.0, obs_dt=0.5, dt=2e-3)
    slots = np.asarray(slots)
    assert slots.shape == (4, 3, 64)
    assert set(np.unique(slots)) <= {-1, 0, 1}
    assert np.abs(slots).sum((-2, -1)).tolist() == [80] * 4
    assert np.abs(slots).sum(-2).max() <= 3
    n_t = (np.asarray(frames.rho_p) + np.asarray(frames.rho_m)).sum(-1)
    np.testing.assert_allclose(n_t * config.dx, 1.0, rtol=1e-5)


def test_per_step_identity_tracking_k3():
    """Every particle, tagged via its (site, slot) index and advanced by the
    step's movement flags + ``new_k`` map, must stay on a distinct occupied
    slot whose spin matches its own flip history — exact identity, step by
    step (this is what makes displacement estimators exact at K>1)."""
    config = _config(N=80)
    params = make_particle_params(config, beta=1.0, rate_diffusion=1.0,
                                  rate_active=2.0)
    op = build_mfield_op(config.L, config.dx, 0.0, True)
    K, L = config.K, config.L
    slots0 = lgk_init(config, jax.random.PRNGKey(0))
    occ_flat = jnp.asarray(
        np.flatnonzero(np.asarray(slots0).reshape(-1)), jnp.int32)
    ts0, tk0 = occ_flat % L, occ_flat // L
    spins0 = jnp.asarray(slots0).reshape(-1)[occ_flat]

    def body(carry, k):
        slots, ts, tk, sp = carry
        slots, (mr, ml, fl, new_k), _ex = lgk_step(config, params, op,
                                                   slots, k, 5e-3)
        flat = tk * L + ts
        dmove = (mr.reshape(-1)[flat].astype(jnp.int32)
                 - ml.reshape(-1)[flat].astype(jnp.int32))
        flipped = fl.reshape(-1)[flat]
        tk = new_k.reshape(-1)[flat]
        ts = (ts + dmove) % L
        sp = jnp.where(flipped, -sp, sp)
        flat2 = tk * L + ts
        cnt = jnp.zeros((K * L,), jnp.int32).at[flat2].add(1)
        return (slots, ts, tk, sp), (jnp.max(cnt) <= 1,
                                     jnp.all(slots.reshape(-1)[flat2] == sp))

    keys = jax.random.split(jax.random.PRNGKey(1), 500)
    _, (distinct, spin_ok) = jax.lax.scan(
        body, (slots0, ts0, tk0, spins0), keys)
    assert bool(np.all(np.asarray(distinct)))
    assert bool(np.all(np.asarray(spin_ok)))


def test_k1_special_case_matches_k1_engine():
    """At K=1 the slot engine and the dedicated occ-field engine sample the
    same synchronous law: ensemble ⟨|m|(t)⟩ trajectories agree."""
    L, N, T, obs_dt, beta, n_runs = 64, 40, 3.0, 0.5, 1.5, 24
    config = _config(L=L, N=N, site_capacity=1)
    params = broadcast_params(config, beta=[beta], rate_diffusion=1.0,
                              rate_active=2.0, n_runs=n_runs)
    fr_k, _ = run_lattice_gas_k(config, params, jax.random.PRNGKey(2),
                                T=T, obs_dt=obs_dt, dt=2e-3)
    fr_1, _ = run_lattice_gas(config, params, jax.random.PRNGKey(3),
                              T=T, obs_dt=obs_dt, dt=2e-3)
    m_k = np.abs(np.asarray(fr_k.m_global))
    m_1 = np.abs(np.asarray(fr_1.m_global))
    me, mt = m_k.mean(axis=0), m_1.mean(axis=0)
    se = (m_k.std(axis=0, ddof=1) + m_1.std(axis=0, ddof=1)) / np.sqrt(n_runs)
    assert np.all(np.abs(me - mt) < 4 * se + 0.06), (me, mt, se)


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
def test_lgk_matches_exact_ctmc_k3():
    """Flagship-style config (K=3, plus_forward active hops, exclusion
    pressure ρ=1.5): ensemble ⟨|m|(t)⟩ and the final density profile of the
    slot engine agree with the exact CTMC oracle (tau-leap-vs-CTMC agreement at K=3)."""
    from hydrolim_tpu.particles.init import init_particles
    from hydrolim_tpu.runtime.native import run_exact_gillespie

    L, N, T, obs_dt, beta = 64, 96, 3.0, 0.5, 1.5
    n_runs = 24
    config = _config(L=L, N=N, site_capacity=3)
    params = make_particle_params(config, beta=beta, rate_diffusion=1.0,
                                  rate_active=3.0, k_on=0, k_off=0, k_exit=0)

    m_exact, occ_exact = [], []
    for r in range(n_runs):
        st = init_particles(
            ParticleConfig(L=L, N=N, n_pad=N, init="fixed",
                           scale_rates=False, local_kernel_sigma=0.0,
                           periodic=True, site_capacity=3,
                           active_model="plus_forward"),
            jax.random.PRNGKey(300 + r))
        out = run_exact_gillespie(config, params, np.asarray(st.pos),
                                  np.asarray(st.sigma), T=T, obs_dt=obs_dt,
                                  seed=900 + r)
        m_exact.append(out["m_global"])
        occ_exact.append(out["counts_p"][-1] + out["counts_m"][-1])
    m_exact = np.abs(np.asarray(m_exact))
    occ_exact = np.asarray(occ_exact, float)

    params_b = broadcast_params(config, beta=[beta], rate_diffusion=1.0,
                                rate_active=3.0, n_runs=n_runs)
    frames, slots = run_lattice_gas_k(config, params_b,
                                      jax.random.PRNGKey(4), T=T,
                                      obs_dt=obs_dt, dt=1.5e-3)
    m_tau = np.abs(np.asarray(frames.m_global))
    occ_tau = np.abs(np.asarray(slots)).sum(-2).astype(float)

    me, mt = m_exact.mean(axis=0), m_tau.mean(axis=0)
    se = (m_exact.std(axis=0, ddof=1) + m_tau.std(axis=0, ddof=1)) \
        / np.sqrt(n_runs)
    assert np.all(np.abs(me - mt) < 4 * se + 0.06), (me, mt, se)
    # occupancy statistics under exclusion pressure agree: mean per-site
    # occupancy is rho=1.5 in both; the site-occupancy histogram matches
    h_e = np.array([(occ_exact == v).mean() for v in range(4)])
    h_t = np.array([(occ_tau == v).mean() for v in range(4)])
    assert np.all(np.abs(h_e - h_t) < 0.05), (h_e, h_t)


def test_local_kernel_nonperiodic_runs_k3():
    config = _config(N=70, local_kernel_sigma=0.02, periodic=False)
    params = broadcast_params(config, beta=[0.7], rate_diffusion=0.0,
                              rate_active=5.0)
    frames, slots = run_lattice_gas_k(config, params, jax.random.PRNGKey(5),
                                      T=1.0, obs_dt=0.25, dt=1e-3,
                                      n_tracers=8)
    assert np.all(np.isfinite(np.asarray(frames.m_local)))
    # non-periodic: all mass stays in [0, L)
    assert np.abs(np.asarray(slots)).sum() == 70


def test_system_run_lattice_gas_engine_schema_parity():
    """ParticleSystem.run(engine='lattice_gas') returns the full reference
    out schema with exact per-particle identity (all N tagged)."""
    from hydrolim_tpu import ParticleSystem

    kw = dict(L=64, xlim=1, rate_diffusion=0.2, rate_active=3, beta=1.0,
              init="fixed", N=48, scale_rates=False, local_kernel_sigma=0.0,
              periodic=True, site_capacity=3, k_on=0, k_off=0, k_exit=0,
              rng=0)
    out_p = ParticleSystem(**kw).run(T=1.0, obs_dt=0.25, record_fft=True,
                                     record_var=True)
    out_l = ParticleSystem(**kw).run(T=1.0, obs_dt=0.25, record_fft=True,
                                     record_var=True, engine="lattice_gas")
    assert set(out_p.keys()) == set(out_l.keys())
    assert [len(p) for p in out_l["pos_list"]] == [48] * 4
    # identity frames: every tagged particle on a distinct (unwrapped) slot,
    # mass normalized identically in both engines
    assert out_l["pos_frames"].shape == (4, 48)
    np.testing.assert_allclose(out_l["total_list"].sum(-1) * (1 / 64), 1.0,
                               rtol=1e-5)
    np.testing.assert_allclose(out_p["total_list"].sum(-1) * (1 / 64), 1.0,
                               rtol=1e-5)
    # same spectrum convention (unnormalized full-L DFT of total)
    assert out_l["rho_hat_complex"].shape == out_p["rho_hat_complex"].shape
    np.testing.assert_allclose(np.abs(out_l["rho_hat_complex"][:, 0]),
                               out_l["total_list"].sum(-1), rtol=1e-4)


def test_anchored_engine_invariants_and_exits():
    """Anchored slot engine: slot values stay in {0,±1,±2}, capacity holds
    counting bound particles, and N_final + exits == N_initial."""
    from hydrolim_tpu.particles.lattice_gas_k import run_lattice_gas_anchored

    config = _config(L=96, N=60, site_capacity=3, periodic=False,
                     anchor_positions=[0.3, 0.7], anchor_radius=0.02,
                     minus_anchor=True, immobilize_when_anchored=True)
    params = broadcast_params(config, beta=[0.5], rate_diffusion=0.5,
                              rate_active=3.0, k_on=20.0, k_off=2.0,
                              k_exit=10.0, n_runs=4)
    frames, slots, (ec, et, ep) = run_lattice_gas_anchored(
        config, params, jax.random.PRNGKey(0), T=4.0, obs_dt=0.5, dt=1e-3)
    slots = np.asarray(slots)
    ec = np.asarray(ec)
    assert set(np.unique(slots)) <= {-2, -1, 0, 1, 2}
    occ = (slots != 0).sum(-2)
    assert occ.max() <= 3
    n_final = (slots != 0).sum((-2, -1))
    np.testing.assert_array_equal(n_final + ec, 60)
    assert ec.sum() > 0, "exit channel never fired"
    # exit log entries are valid times/sites
    et, ep = np.asarray(et), np.asarray(ep)
    for b in range(4):
        k = min(int(ec[b]), et.shape[1])
        assert np.all(np.isfinite(et[b, :k]))
        assert np.all((ep[b, :k] >= 0) & (ep[b, :k] < 96))
        # exits only happen at anchor sites
        anchor_sites = np.flatnonzero(config.anchor_mask())
        assert np.all(np.isin(ep[b, :k], anchor_sites))


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
def test_anchored_engine_matches_exact_ctmc():
    """Anchored channels vs the exact CTMC oracle: ensemble exit-count and
    survival trajectories agree (K=3, bind/unbind/exit live)."""
    from hydrolim_tpu.particles.init import init_particles
    from hydrolim_tpu.particles.lattice_gas_k import run_lattice_gas_anchored
    from hydrolim_tpu.runtime.native import run_exact_gillespie

    L, N, T, obs_dt = 96, 60, 4.0, 1.0
    n_runs = 24
    config = _config(L=L, N=N, site_capacity=3, periodic=False,
                     anchor_positions=[0.3, 0.7], anchor_radius=0.02,
                     minus_anchor=True, immobilize_when_anchored=True)
    params = make_particle_params(config, beta=0.5, rate_diffusion=0.5,
                                  rate_active=3.0, k_on=20.0, k_off=2.0,
                                  k_exit=10.0)

    exits_exact = []
    for r in range(n_runs):
        st = init_particles(config, jax.random.PRNGKey(700 + r))
        out = run_exact_gillespie(config, params, np.asarray(st.pos),
                                  np.asarray(st.sigma), T=T, obs_dt=obs_dt,
                                  seed=50 + r)
        exits_exact.append(N - int(out["n_alive"][-1]))
    exits_exact = np.asarray(exits_exact, float)

    params_b = broadcast_params(config, beta=[0.5], rate_diffusion=0.5,
                                rate_active=3.0, k_on=20.0, k_off=2.0,
                                k_exit=10.0, n_runs=n_runs)
    _, _, (ec, _, _) = run_lattice_gas_anchored(
        config, params_b, jax.random.PRNGKey(5), T=T, obs_dt=obs_dt,
        dt=1e-3)
    exits_tau = np.asarray(ec, float)

    se = (exits_exact.std(ddof=1) + exits_tau.std(ddof=1)) / np.sqrt(n_runs)
    assert abs(exits_exact.mean() - exits_tau.mean()) < 4 * se + 1.0, (
        exits_exact.mean(), exits_tau.mean(), se)


def test_crowding_suppression_matches_particle_engine():
    """crowding_suppresses_rates=True (rate × (1−occ(target)/K),
    :322-336): slot engine vs particle engine ensemble agreement, plus the
    suppressed current is measurably below the unsuppressed one."""
    from hydrolim_tpu.sweeps.ensemble import run_particle_ensemble

    L, N, T, obs_dt, n_runs = 64, 96, 3.0, 0.5, 24
    config = _config(L=L, N=N, site_capacity=3,
                     crowding_suppresses_rates=True,
                     active_model="bidirectional")
    params = broadcast_params(config, beta=[1.5], rate_diffusion=1.0,
                              rate_active=3.0, n_runs=n_runs)
    fr_k, slots_k = run_lattice_gas_k(config, params, jax.random.PRNGKey(6),
                                      T=T, obs_dt=obs_dt, dt=1.5e-3)
    config_p = ParticleConfig(L=L, N=N, n_pad=N, init="fixed",
                              scale_rates=False, local_kernel_sigma=0.0,
                              periodic=True, site_capacity=3,
                              crowding_suppresses_rates=True,
                              active_model="bidirectional")
    params_p = broadcast_params(config_p, beta=[1.5], rate_diffusion=1.0,
                                rate_active=3.0, n_runs=n_runs)
    res = jax.device_get(run_particle_ensemble(
        config_p, params_p, jax.random.PRNGKey(7), T=T, obs_dt=obs_dt,
        dt=1.5e-3, record_pos=False))
    m_k = np.abs(np.asarray(fr_k.m_global))
    m_p = np.abs(np.asarray(res.frames.m_global))
    me, mt = m_k.mean(0), m_p.mean(0)
    se = (m_k.std(0, ddof=1) + m_p.std(0, ddof=1)) / np.sqrt(n_runs)
    assert np.all(np.abs(me - mt) < 4 * se + 0.06), (me, mt, se)
    # occupancy histograms agree under crowding suppression
    occ_k = np.abs(np.asarray(slots_k)).sum(-2)
    from hydrolim_tpu.ops.segment import occupancy as _occ
    h_k = np.array([(occ_k == v).mean() for v in range(4)])
    # particle final state occupancy
    fs = res.final_state
    occ_p = np.stack([
        np.bincount(np.asarray(fs.pos[b]) % L,
                    weights=np.asarray(fs.alive[b], float),
                    minlength=L) for b in range(n_runs)])
    h_p = np.array([(occ_p == v).mean() for v in range(4)])
    assert np.all(np.abs(h_k - h_p) < 0.05), (h_k, h_p)
