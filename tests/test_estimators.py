"""Estimator unit tests: measurement-window modes, blocking probability,
D_eff displacement slope, batched-on-device vs host parity."""
import numpy as np

from hydrolim_tpu.observables.estimators import (
    blocking_probability,
    compute_v_eff_and_window,
    d_eff_from_positions,
    measurement_window,
)


def _drifting_out(M=40, L=50, v=0.01):
    """Synthetic out-dict: a Gaussian density bump drifting right."""
    times = np.arange(M) * 0.5
    x = np.linspace(0, 1, L)
    total = np.stack([np.exp(-0.5 * ((x - 0.2 - v * t) / 0.05) ** 2)
                      for t in times])
    total /= total.sum(axis=1, keepdims=True) * (x[1] - x[0])
    return {"times_obs": times, "total_list": total}


def test_window_legacy_vs_strict():
    out = _drifting_out(v=0.05)  # bump reaches the boundary late
    total = out["total_list"]
    s_leg, e_leg, frac = measurement_window(total, window_mode="legacy")
    s_str, e_str, _ = measurement_window(total, window_mode="strict")
    M = total.shape[0]
    assert s_leg == s_str == int(0.65 * M)
    assert frac.max() > 0.06
    # the decoded reference 'legacy' rule (..._sweep_beta.py:141-153): a
    # handful of late unsafe frames does NOT collapse the window — the
    # collapse fires only when the unsafe COUNT exceeds 0.65*M (round-3
    # review: an earlier round collapsed on ANY unsafe frame)
    assert 0 < (frac >= 0.06).sum() <= s_leg
    assert e_leg == M
    # strict ends at the first unsafe frame after start (>= min length)
    assert s_str + 3 <= e_str < M

    # legacy collapse case: bump parked ON the boundary the whole run
    x = np.linspace(0, 1, 50)
    bump = np.exp(-0.5 * ((x - 0.995) / 0.02) ** 2)
    total2 = np.tile(bump, (M, 1))
    total2 /= total2.sum(axis=1, keepdims=True) * (x[1] - x[0])
    s2, e2, frac2 = measurement_window(total2, window_mode="legacy")
    assert (frac2 >= 0.06).sum() > s2
    assert e2 == min(M, s2 + max(3, int(0.1 * M)))


def test_v_eff_recovers_drift():
    v = 0.004
    out = _drifting_out(M=40, v=v)
    mean_v, v_ts, times, si, ei, _ = compute_v_eff_and_window(out)
    assert abs(mean_v - v) < 0.001  # d<x>/dt of the center of mass


def test_v_eff_xlim_scaling():
    """the x grid must come from the config, not a hardcoded
    [0, 1].  The same drifting bump on an xlim=2 domain moves 2x faster in
    physical units, and the boundary-safety window scales with the domain."""
    v = 0.004
    out = _drifting_out(M=40, v=v)   # bump positions in *fractional* units

    class _PS:
        xlim = 2.0

    mean_v, v_ts, times, si, ei, _ = compute_v_eff_and_window(out, _PS())
    assert abs(mean_v - 2.0 * v) < 0.002
    # window indices are identical to the xlim=1 run (pure rescaling)
    m1, _, _, s1, e1, _ = compute_v_eff_and_window(out)
    assert (si, ei) == (s1, e1)
    assert abs(mean_v - 2.0 * m1) < 1e-9


def test_blocking_probability_limits():
    # all forward neighbors full -> p_block = 1
    rho_p = np.ones((5, 10))
    total = np.full((5, 10), 2.0)
    assert float(blocking_probability(rho_p, total, 0, 5)) == 1.0
    # empty neighbors -> 0
    total2 = np.zeros((5, 10))
    assert float(blocking_probability(rho_p, total2, 0, 5)) == 0.0


def test_d_eff_from_positions_ballistic_free():
    """Deterministic spreading: positions fan out linearly, variance grows
    quadratically; the linear fit slope equals the mean variance rate."""
    rng = np.random.default_rng(0)
    n, M = 200, 20
    speeds = rng.normal(0, 1.0, n)
    times = np.arange(M) * 1.0
    pos = np.outer(times, speeds) + 100.0
    alive = np.ones((M, n), bool)
    D = d_eff_from_positions(pos, alive, times, dx=1.0, start_idx=0,
                             end_idx=M)
    assert D > 0


def test_batched_matches_host():
    """The on-device batched estimator suite reproduces the host-side
    per-replica estimators on a real ensemble."""
    import jax
    from hydrolim_tpu.core.config import ParticleConfig
    from hydrolim_tpu.observables.batched import batched_estimates
    from hydrolim_tpu.observables.estimators import (
        compute_blocking_probability,
        compute_D_eff_active,
        compute_mean_magnetization,
        compute_rho_eff,
    )
    from hydrolim_tpu.sweeps.ensemble import (
        broadcast_params,
        frames_to_out,
        run_particle_ensemble,
    )

    T, obs_dt = 4.0, 0.25
    config = ParticleConfig(L=64, N=40, n_pad=40, init="fixed",
                            scale_rates=False, local_kernel_sigma=0.0,
                            periodic=False, site_capacity=1,
                            active_model="plus_forward")
    params = broadcast_params(config, beta=[0.5, 1.5, 2.5],
                              rate_diffusion=0.5, rate_active=2.0, n_runs=2)
    res = jax.device_get(run_particle_ensemble(
        config, params, jax.random.PRNGKey(0), T=T, obs_dt=obs_dt, dt=2e-3))
    f = res.frames
    times = np.arange(0.0, T, obs_dt)
    dev = jax.device_get(batched_estimates(
        f.total, f.m_global, f.rho_p, times, f.pos, f.alive,
        dx=config.dx, xlim=1.0))

    class _PS:
        dx = config.dx
        xlim = 1.0

    for r in range(6):
        out = frames_to_out(f, r, config, T, obs_dt)
        mean_v, _, _, si, ei, _ = compute_v_eff_and_window(out, _PS())
        assert si == int(dev.start_idx[r]) and ei == int(dev.end_idx[r])
        np.testing.assert_allclose(dev.v_eff[r], mean_v, rtol=2e-4,
                                   atol=1e-6)
        np.testing.assert_allclose(
            dev.m_mean[r], compute_mean_magnetization(out, si, ei),
            rtol=2e-4, atol=1e-6)
        np.testing.assert_allclose(
            dev.rho_eff[r], compute_rho_eff(out, si, ei), rtol=5e-4,
            atol=1e-5)
        np.testing.assert_allclose(
            dev.p_block[r], compute_blocking_probability(out, si, ei),
            rtol=5e-4, atol=1e-6)
        D_host = compute_D_eff_active(out, _PS(), si, ei)
        if np.isnan(D_host):
            assert np.isnan(dev.D_eff[r])
        else:
            np.testing.assert_allclose(dev.D_eff[r], D_host, rtol=1e-3,
                                       atol=1e-7)
