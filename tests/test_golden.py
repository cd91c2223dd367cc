"""Golden-value physics regression suite.

Fixed-seed, small-but-real configs that pin the SAMPLED physics of every
engine so silent drift across rounds fails loudly.  Two kinds of pins:

- cross-engine: independent samplers (particle-centric τ-leap, site-centric
  slot engine, PDE tracers) must agree with each other and with the
  closed-form theory within a few standard errors at matched parameters —
  the small-scale version of the plot_figs.py hydrodynamic-limit figure
  (VALIDATION.md cross-engine table),
- frozen goldens: observables with no closed form (p_block at the K=3
  flagship, anchored exit totals) are pinned to values measured from THIS
  framework at the stated seed, with tolerance set by the measured
  ensemble SE (values recorded in _GOLDEN below; re-measure only with a
  deliberate physics change, and record why).

The C0/C1/C2 refit self-consistency pin lives in tests/test_fit_theory.py.
"""
import numpy as np
import jax
import pytest

from hydrolim_tpu.core.config import ParticleConfig
from hydrolim_tpu.sweeps.ensemble import (
    broadcast_params,
    ensemble_dt,
    run_particle_ensemble,
)
from hydrolim_tpu.theory.meanfield import m_fixed_point


# ---------------------------------------------------------------------------
# frozen goldens: measured from this framework (seeds below), tolerance =
# a few measured ensemble SEs.  See scripts in this file's git history /
# VALIDATION.md round-3 section for the measurement runs.
# ---------------------------------------------------------------------------
_GOLDEN = {
    # slot engine, K=3 shrunk flagship, seed 21, 64 runs (2026-08-18 r4;
    # per-run sd 0.0558): tol = 4·SE ≈ 4.7% of the mean (≤5% asked;
    # the earlier 6-run golden allowed ±17%)
    "p_block_k3": {"mean": 0.5964, "se": 0.0070, "tol": 0.028},
    # anchored slot engine, seed 33, 96 runs (2026-08-18 r4; per-run sd
    # 2.73): tol = 4·SE ≈ 12.9% of the mean (was ±41% at 6 runs)
    "anchored_exits": {"mean": 8.667, "se": 0.279, "tol": 1.12},
}


def _v_from_tracers(tr, times, t_start_frac=0.5):
    """v per replica from unwrapped tracer/particle positions (M, n)."""
    from hydrolim_tpu.particles.lattice_gas import tracer_valid_mask

    M = len(times)
    s = M // 2 if t_start_frac == 0.5 else int(M * t_start_frac)
    ok = tracer_valid_mask(tr[s]) & tracer_valid_mask(tr[-1])
    disp = np.where(ok, tr[-1].astype(float) - tr[s].astype(float), np.nan)
    return np.nanmean(disp) / (times[-1] - times[s])


def _D_from_tracers(tr, times):
    """D per replica: displacement-variance slope over the second half
    (compute_D_eff_active semantics, all particles tracked)."""
    from hydrolim_tpu.particles.lattice_gas import tracer_valid_mask

    M = len(times)
    s = M // 2
    ok = tracer_valid_mask(tr[s])
    span = times[s:] - times[s]
    disp = tr[s:].astype(float) - tr[s].astype(float)
    disp = np.where(ok, disp, np.nan)
    var = np.nanvar(disp, axis=1)
    return np.polyfit(span, var, 1)[0] / 2.0


BETAS = np.array([0.8, 1.5, 2.5])


def _exclusion_cfg(**kw):
    base = dict(L=128, xlim=1, N=48, init="fixed", scale_rates=False,
                local_kernel_sigma=0.0, periodic=True, site_capacity=1,
                active_model="bidirectional")
    base.update(kw)
    return ParticleConfig(**base)


_RUN_CACHE = {}


def _exclusion_engines_run(n_runs=4, seed=12, T=8.0, obs_dt=0.5):
    """Same K=1 exclusion config on both engines; returns per-(β, run)
    |m| window means, tracer velocities and D_eff.  Cached per arg tuple —
    two golden tests share one simulation."""
    key_t = (n_runs, seed, T, obs_dt)
    if key_t in _RUN_CACHE:
        return _RUN_CACHE[key_t]
    from hydrolim_tpu.particles.lattice_gas import run_lattice_gas

    config = _exclusion_cfg()
    rd, ra = 0.5, 2.0
    params = broadcast_params(config, beta=BETAS, rate_diffusion=rd,
                              rate_active=ra, n_runs=n_runs)
    dt = ensemble_dt(config, beta_max=float(BETAS.max()),
                     rate_diffusion=rd, rate_active=ra)
    times = np.arange(0.0, T, obs_dt)
    M = len(times)

    res = run_particle_ensemble(config, params, jax.random.PRNGKey(seed),
                                T=T, obs_dt=obs_dt, dt=dt)
    res = jax.device_get(res)
    frames_lg, _ = run_lattice_gas(config, params,
                                   jax.random.PRNGKey(seed + 1), T=T,
                                   obs_dt=obs_dt, dt=dt, n_tracers=config.N)
    frames_lg = jax.device_get(frames_lg)

    B = len(BETAS) * n_runs
    m_part = np.abs(np.asarray(res.frames.m_global))[:, M // 2:].mean(1)
    m_slot = np.abs(np.asarray(frames_lg.m_global))[:, M // 2:].mean(1)
    v_part = np.array([
        abs(_v_from_tracers(np.asarray(res.frames.pos[i]), times))
        for i in range(B)])
    v_slot = np.array([
        abs(_v_from_tracers(np.asarray(frames_lg.tracer_pos[i]), times))
        for i in range(B)])
    D_part = np.array([
        _D_from_tracers(np.asarray(res.frames.pos[i]), times)
        for i in range(B)])
    D_slot = np.array([
        _D_from_tracers(np.asarray(frames_lg.tracer_pos[i]), times)
        for i in range(B)])
    sh = (len(BETAS), n_runs)
    out = (m_part.reshape(sh), m_slot.reshape(sh), v_part.reshape(sh),
           v_slot.reshape(sh), D_part.reshape(sh), D_slot.reshape(sh))
    _RUN_CACHE[key_t] = out
    return out


def test_golden_cross_engine_exclusion_m_v_D():
    """Particle-centric τ-leap vs site-centric slot engine at K=1
    exclusion, 3 β points: |m|, tracer speed AND D_eff agree within error
    bars — two independent samplers of the same CTMC, both tracking ALL N
    particles (slot-engine D_eff error bars
    match the particle engine at equal replica count)."""
    n_runs = 4
    m_p, m_s, v_p, v_s, D_p, D_s = _exclusion_engines_run(n_runs=n_runs)
    se = lambda a: a.std(1, ddof=1) / np.sqrt(n_runs)
    for name, a, b in (("m", m_p, m_s), ("v", v_p, v_s), ("D", D_p, D_s)):
        tol = 3.0 * (se(a) + se(b)) + 0.02 * max(1.0, abs(b.mean()))
        assert np.all(np.abs(a.mean(1) - b.mean(1)) < tol), (
            name, a.mean(1), b.mean(1), tol)
    # full-N tracking: slot-engine SEs are the same scale as the particle
    # engine's (not inflated by tracer subsampling)
    assert np.all(se(D_s) < 3.0 * se(D_p) + 1e-3), (se(D_s), se(D_p))
    # ordering physics: |m| rises through the transition on both engines
    assert m_p.mean(1)[2] > m_p.mean(1)[0] + 0.2
    assert m_s.mean(1)[2] > m_s.mean(1)[0] + 0.2


def test_golden_three_engine_magnetization_vs_theory():
    """|m| at β=2.5 on particle, slot AND PDE engines vs the tanh fixed
    point — the three samplers tie back to one closed form.  (K=1 exclusion
    does not shift the CW magnetization law: flips depend only on m.)"""
    from hydrolim_tpu import IMEXPDE

    beta = 2.5
    m_th = m_fixed_point(beta)

    m_p, m_s, _, _, _, _ = _exclusion_engines_run(n_runs=4)
    assert abs(m_p[2].mean() - m_th) < 0.06, (m_p[2].mean(), m_th)
    assert abs(m_s[2].mean() - m_th) < 0.06, (m_s[2].mean(), m_th)

    pde = IMEXPDE(L=128, T=3.0, dt=1e-3, gamma=0.05, lam=0.6, beta=beta,
                  bc="periodic", gaussian_kernel=True, kernel_sigma=1e5 - 10,
                  seed=5, snapshot_interval=100)
    pde.initialize("homogeneous", rho0=1.0, noise=0.3, n_tracers=64)
    pde.rho_p = pde.rho_p * 1.5      # break ± symmetry immediately
    pde.solve()
    m_pde = abs(float(np.asarray(pde.get_output()["m_series"])[-1]))
    assert abs(m_pde - m_th) < 0.02, (m_pde, m_th)


def test_golden_p_block_k3_flagship():
    """Blocking probability at a shrunk K=3 flagship config (reference
    PARTICLE_solver_BIOLOGY_EXCLUSION.py class: plus_forward, non-periodic,
    exp-gradient init, K=3) on the slot engine — frozen golden value."""
    from hydrolim_tpu.observables.batched import batched_estimates
    from hydrolim_tpu.particles.lattice_gas_k import run_lattice_gas_k
    from hydrolim_tpu.sweeps.beta_sweep import make_exp_gradient

    L, N, n_runs, T, obs_dt = 128, 96, 64, 6.0, 0.25
    config = ParticleConfig(L=L, xlim=1, N=N, init="poisson",
                            scale_rates=False, local_kernel_sigma=0.0,
                            periodic=False, site_capacity=3,
                            active_model="plus_forward")
    grad = make_exp_gradient(L=L, N=N, frac_plus=0.75, decay_length=0.35,
                             anchor_positions=None)
    rd, ra = 0.02, 2.0
    params = broadcast_params(config, beta=[0.7], rate_diffusion=rd,
                              rate_active=ra, n_runs=n_runs)
    dt = ensemble_dt(config, beta_max=0.7, rate_diffusion=rd, rate_active=ra)
    frames, _ = run_lattice_gas_k(config, params, jax.random.PRNGKey(21),
                                  T=T, obs_dt=obs_dt, dt=dt,
                                  rho0_plus=grad[2], rho0_minus=grad[3])
    frames = jax.device_get(frames)
    times = np.arange(0.0, T, obs_dt)
    est = jax.device_get(batched_estimates(
        frames.total, frames.m_global, frames.rho_p, times,
        dx=config.dx, xlim=1.0, has_positions=False))
    p = np.asarray(est.p_block, float)
    mean, se = p.mean(), p.std(ddof=1) / np.sqrt(n_runs)
    g = _GOLDEN["p_block_k3"]
    assert abs(mean - g["mean"]) < max(4.0 * se, g["tol"]), (mean, se, g)


def test_golden_anchored_exit_totals():
    """Anchored binding/exit pipeline (slot engine): frozen golden total
    exit count at a shrunk version of the run_anchored_exits.py config."""
    from hydrolim_tpu.particles.lattice_gas_k import run_lattice_gas_anchored
    from hydrolim_tpu.sweeps.beta_sweep import make_exp_gradient

    L, N, n_runs, T = 128, 64, 96, 6.0
    anchors = (0.25, 0.60, 0.80)
    config = ParticleConfig(L=L, xlim=1, N=N, init="poisson",
                            scale_rates=False, local_kernel_sigma=0.02,
                            periodic=False, site_capacity=3,
                            active_model="plus_forward", minus_anchor=True,
                            immobilize_when_anchored=True,
                            anchor_positions=anchors, anchor_radius=0.01,
                            exit_buffer=N)
    grad = make_exp_gradient(L=L, N=N, frac_plus=0.75, decay_length=0.35,
                             anchor_positions=anchors)
    rd, ra = 0.02, 2.0
    params = broadcast_params(config, beta=[0.7], rate_diffusion=rd,
                              rate_active=ra, n_runs=n_runs, k_on=10.0,
                              k_off=5.0, k_exit=5.0)
    dt = ensemble_dt(config, beta_max=0.7, rate_diffusion=rd, rate_active=ra,
                     k_on=10.0, k_off=5.0, k_exit=5.0)
    frames, _, exit_log = run_lattice_gas_anchored(
        config, params, jax.random.PRNGKey(33), T=T, obs_dt=0.5, dt=dt,
        rho0_plus=grad[2], rho0_minus=grad[3])
    counts = np.asarray(jax.device_get(exit_log[0]), float)
    mean, se = counts.mean(), counts.std(ddof=1) / np.sqrt(n_runs)
    g = _GOLDEN["anchored_exits"]
    assert abs(mean - g["mean"]) < max(4.0 * se, g["tol"]), (mean, se, g)
    # physics invariant: exits happened at all, and not everyone exited
    assert 0 < mean < N


def test_golden_critical_region_cross_engine_v():
    """β = 0.9 (sub-critical, m_β = 0): particle and PDE tracer velocities
    must BOTH be statistically zero and agree within an SE-derived bound
    (the cross-engine table once showed 0.0131 vs 0.0026 at β = 0.9 with
    no test bounding the discrepancy)."""
    from hydrolim_tpu.core.config import PDEConfig, make_pde_params
    from hydrolim_tpu.pde.init import pde_initialize
    from hydrolim_tpu.pde.stepper import build_pde_ops, pde_solve

    beta, n_runs = 0.9, 24
    config = _exclusion_cfg(site_capacity=None, N=96)   # mean-field path
    rd, ra = 0.5, 0.6
    params = broadcast_params(config, beta=[beta], rate_diffusion=rd,
                              rate_active=ra, n_runs=n_runs)
    dt = ensemble_dt(config, beta_max=beta, rate_diffusion=rd, rate_active=ra)
    T, obs_dt = 8.0, 0.5
    res = jax.device_get(run_particle_ensemble(
        config, params, jax.random.PRNGKey(40), T=T, obs_dt=obs_dt, dt=dt))
    times = np.arange(0.0, T, obs_dt)
    s = len(times) // 2
    pos = np.asarray(res.frames.pos, float)             # unwrapped (B, M, n)
    disp = pos[:, -1] - pos[:, s]
    v_p = disp.mean(1) * config.dx / (times[-1] - times[s])
    se_p = v_p.std(ddof=1) / np.sqrt(n_runs)

    n_rep = 8
    config_p = PDEConfig(L=128, T=4.0, dt=1e-3, bc="periodic",
                         gaussian_kernel=True, kernel_sigma=1e5 - 10,
                         snapshot_interval=500, n_tracers=256,
                         tracer_window_time=0.05)
    params_p = make_pde_params(gamma=0.2, lam=ra, beta=beta)
    ops = build_pde_ops(config_p, params_p)

    def one(k):
        k1, k2 = jax.random.split(k)
        rp, rm, tr = pde_initialize(config_p, k1, mode="homogeneous",
                                    noise=0.3, n_tracers=256)
        return pde_solve(config_p, params_p, ops, rp, rm, tr, k2).records.v_eff

    v = np.asarray(jax.device_get(
        jax.vmap(one)(jax.random.split(jax.random.PRNGKey(9), n_rep))))
    v_pde = np.nanmean(v[:, -2000:], axis=1)
    se_pde = v_pde.std(ddof=1) / np.sqrt(n_rep)

    # measured 2026-08-18: v_p ≈ 0.00009 ± 0.0002, v_pde ≈ −0.00025 ± 0.011
    assert abs(v_p.mean()) < 4.0 * se_p + 1e-3, (v_p.mean(), se_p)
    assert abs(v_pde.mean()) < 4.0 * se_pde + 1e-3, (v_pde.mean(), se_pde)
    assert abs(v_p.mean() - v_pde.mean()) < 4.0 * (se_p + se_pde) + 1e-3, (
        v_p.mean(), v_pde.mean(), se_p, se_pde)


def test_golden_double_sweep_constants_refit(tmp_path):
    """(N, β) double sweep at the reference's own configuration refits the
    frozen exclusion constants.  CPU-scale pin: 19 N × 11 β
    × 4 runs (~100 s).  Measured CPU seed-0 refit:
    C0/C1/C2 = 1.2544/0.6193/0.1527 = 0.08σ/1.2σ/0.45σ of the fit errors.
    Bounds are 3× the COMBINED realization scatter (ours at this run count
    + the reference's own 4-run sampling noise, measured from independent
    16-run realizations — the formal C2 fit error understates it ~2×)."""
    from hydrolim_tpu.sweeps.double_sweep import double_sweep_fused
    from hydrolim_tpu.theory import blocking as bl

    res = double_sweep_fused(
        np.linspace(0, 3, 11), np.linspace(50, 950, 19),
        n_runs_per_beta=4, outdir=str(tmp_path), seed=0,
        plot_result=False, engine="lattice_gas")
    assert abs(res["C0"] - bl.C0) / bl.C0 < 0.03, (res["C0"], bl.C0)
    assert abs(res["C1"] - bl.C1) / bl.C1 < 0.08, (res["C1"], bl.C1)
    assert abs(res["C2"] - bl.C2) / bl.C2 < 0.08, (res["C2"], bl.C2)
    # the refit must also report its own uncertainties (consumer: the
    # nsigma agreement analysis in VALIDATION.md)
    assert 0 < res["C0_err"] < 0.05 and 0 < res["C2_err"] < 0.01


def test_pde_fixed_seed_golden():
    """Fixed-seed golden of the XLA PDE solve (global-kernel sentinel,
    gamma=0.2, beta=2, 256 tracers, 500 steps): pins the sampled physics
    values themselves, not just tolerance-to-theory — a uniform scale
    error (e.g. the round-3 (window-1)/window tracer bias, a ~1% shift)
    passes every statistical check but fails here."""
    import jax
    import numpy as np

    from hydrolim_tpu.core.config import PDEConfig, make_pde_params
    from hydrolim_tpu.pde.init import pde_initialize
    from hydrolim_tpu.pde.stepper import build_pde_ops, pde_solve

    config = PDEConfig(L=128, T=0.5, dt=1e-3, bc="periodic",
                      gaussian_kernel=True, kernel_sigma=1e5 - 10,
                      snapshot_interval=100, n_tracers=256,
                      tracer_window_time=0.05)
    params = make_pde_params(gamma=0.2, lam=0.6, beta=2.0)
    ops = build_pde_ops(config, params)
    rho_p, rho_m, tr = pde_initialize(config, jax.random.PRNGKey(12),
                                      mode="homogeneous", rho0=1.0,
                                      noise=0.3, n_tracers=256)
    res = pde_solve(config, params, ops, rho_p, rho_m, tr,
                    jax.random.PRNGKey(34))
    v = float(np.nanmean(np.asarray(res.records.v_eff)[-100:]))
    D = float(np.nanmean(np.asarray(res.records.D_eff)[-100:]))
    m = float(np.mean(np.asarray(res.records.m_mean)[-100:]))
    mass_p = float(np.asarray(res.rho_p).sum())
    # frozen 2026-08-17 (post tracer-window fix); tracer stats get a few
    # ulp of slack for cross-version reduction reassociation, fields are
    # deterministic to ~1e-4
    np.testing.assert_allclose(v, -0.029707681387662888, rtol=5e-3)
    np.testing.assert_allclose(D, 0.20189571380615234, rtol=5e-3)
    np.testing.assert_allclose(m, 0.04618469625711441, rtol=1e-3)
    np.testing.assert_allclose(mass_p, 0.525442361831665, rtol=1e-4)
