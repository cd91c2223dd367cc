"""PDE engine: step math vs an independent NumPy oracle, conservation, and
solve-loop schema."""
import numpy as np
import jax.numpy as jnp
import pytest
from scipy.sparse import diags
from scipy.sparse.linalg import spsolve

from hydrolim_tpu import IMEXPDE
from hydrolim_tpu.core.config import PDEConfig, make_pde_params
from hydrolim_tpu.pde.stepper import build_pde_ops, pde_step


def _oracle_step(rho_p, rho_m, *, L, dx, dt, gamma, lam, beta, bc,
                 kernel=None):
    """Independent NumPy implementation of one bidirectional IMEX step,
    written from the discretization: implicit diffusion solve, upwind
    advection, Curie–Weiss reaction, clip, mass renormalization."""
    D = diags([1.0, -2.0, 1.0], [-1, 0, 1], shape=(L, L)).tolil()
    if bc == "periodic":
        D[0, -1] = D[-1, 0] = 1.0
    else:
        D[0, 1] = 2.0
        D[-1, -2] = 2.0
    A = (diags(np.ones(L), 0) - gamma * dt * D / dx ** 2).tocsr()
    p = spsolve(A, rho_p)
    m = spsolve(A, rho_m)

    # upwind derivatives
    dp = np.empty(L)
    dp[1:] = (p[1:] - p[:-1]) / dx
    dp[0] = (p[0] - p[-1]) / dx if bc == "periodic" else 0.0
    dm = np.empty(L)
    dm[:-1] = (m[1:] - m[:-1]) / dx
    dm[-1] = (m[0] - m[-1]) / dx if bc == "periodic" else 0.0

    # the reaction magnetization is evaluated at the PRE-diffusion densities
    # (the reference's self.rho_p/self.rho_m, IMEX_PDE_solver_class.py:198)
    if kernel is None:
        mag = (rho_p - rho_m) / (rho_p + rho_m + 1e-12)
    else:
        mag = np.real(np.fft.ifft(np.fft.fft(rho_p - rho_m) * np.fft.fft(kernel)))
        mag /= np.real(np.fft.ifft(np.fft.fft(rho_p + rho_m) * np.fft.fft(kernel))) + 1e-12
    cw = lambda s: np.clip(np.exp(-beta * s * mag), 1e-8, 1e8)
    R_p = cw(-1) * m - cw(+1) * p
    p2 = np.clip(p + dt * (-lam * dp + R_p), 0, None)
    m2 = np.clip(m + dt * (+lam * dm - R_p), 0, None)
    M0 = (p + m).sum()
    M1 = (p2 + m2).sum()
    return p2 * M0 / M1, m2 * M0 / M1


@pytest.mark.parametrize("bc", ["periodic", "neumann"])
def test_pde_step_matches_oracle(bc):
    L, dx, dt = 64, 1.0 / 64, 5e-4
    rng = np.random.default_rng(0)
    rho_p = rng.random(L)
    rho_m = rng.random(L)
    s = rho_p.sum() + rho_m.sum()
    rho_p, rho_m = rho_p / s, rho_m / s

    config = PDEConfig(L=L, xlim=1.0, T=dt, dt=dt, bc=bc)
    params = make_pde_params(gamma=0.2, lam=0.6, beta=1.5)
    ops = build_pde_ops(config, params)
    p1, m1 = pde_step(config, params, ops, jnp.asarray(rho_p, jnp.float32),
                      jnp.asarray(rho_m, jnp.float32))
    p_ref, m_ref = _oracle_step(rho_p, rho_m, L=L, dx=dx, dt=dt, gamma=0.2,
                                lam=0.6, beta=1.5, bc=bc)
    np.testing.assert_allclose(np.asarray(p1), p_ref, rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(m1), m_ref, rtol=5e-4, atol=1e-6)


def test_pde_step_with_kernel_matches_oracle():
    L, dx, dt = 64, 1.0 / 64, 5e-4
    rng = np.random.default_rng(1)
    rho_p = rng.random(L)
    rho_m = rng.random(L)
    config = PDEConfig(L=L, xlim=1.0, T=dt, dt=dt, bc="periodic",
                       gaussian_kernel=True, kernel_sigma=0.05)
    params = make_pde_params(gamma=0.1, lam=0.6, beta=2.0)
    ops = build_pde_ops(config, params)
    p1, m1 = pde_step(config, params, ops, jnp.asarray(rho_p, jnp.float32),
                      jnp.asarray(rho_m, jnp.float32))
    i = np.arange(L)
    kern = np.exp(-0.5 * (np.minimum(i, L - i) * dx / 0.05) ** 2)
    kern /= kern.sum()
    p_ref, m_ref = _oracle_step(rho_p, rho_m, L=L, dx=dx, dt=dt, gamma=0.1,
                                lam=0.6, beta=2.0, bc="periodic", kernel=kern)
    np.testing.assert_allclose(np.asarray(p1), p_ref, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(np.asarray(m1), m_ref, rtol=1e-3, atol=1e-6)


def test_mass_conserved_over_many_steps():
    config = PDEConfig(L=128, T=0.05, dt=5e-4, bc="periodic")
    params = make_pde_params(gamma=0.2, lam=0.6, beta=2.0)
    ops = build_pde_ops(config, params)
    rng = np.random.default_rng(2)
    p = jnp.asarray(rng.random(128) / 128, jnp.float32)
    m = jnp.asarray(rng.random(128) / 128, jnp.float32)
    M0 = float(jnp.sum(p + m))
    for _ in range(100):
        p, m = pde_step(config, params, ops, p, m)
    assert abs(float(jnp.sum(p + m)) - M0) < 1e-4 * M0


def test_imexpde_facade_solve_schema():
    pde = IMEXPDE(L=64, T=0.05, dt=1e-3, gamma=0.05, lam=0.6, beta=2.0,
                  bc="periodic", seed=3, snapshot_interval=10)
    pde.initialize("homogeneous", rho0=1.0, noise=0.1, n_tracers=16)
    pde.solve()
    out = pde.get_output()
    n = pde.nsteps + 1
    assert out["m_series"].shape == (n,)
    assert out["var_series"].shape == (n,)
    assert out["fft_amp"].shape == (n, 33)
    assert out["v_eff_series"].shape == (n,)
    assert out["snapshots"].shape[1] == 64
    assert np.all(np.isfinite(out["m_series"]))
    # windowed tracer stats appear after the window fills
    assert np.isnan(out["v_eff_series"][0])
    assert np.isfinite(out["v_eff_series"][-1])


def test_anchored_minus_runs():
    pde = IMEXPDE(L=64, T=0.02, dt=1e-3, gamma=0.05, lam=0.6, beta=1.0,
                  bc="neumann", active_model="anchored_minus", seed=4)
    pde.initialize("homogeneous", noise=0.05, n_tracers=8)
    pde.solve()
    out = pde.get_output()
    assert np.all(np.isfinite(out["rho_p"]))
    assert np.all(out["rho_p"] >= 0)


def test_anchored_minus_oracle_and_legacy_double_diffusion():
    """anchored_minus branch vs a direct NumPy replication of the
    reference step.  NB the reference's "double solve" (:189-190 then
    :207-208) re-reads the UNCHANGED self.rho_* — the second call yields
    the identical single-solve result, so the oracle applies ONE solve and
    ``legacy_double_diffusion`` must be a no-op (an earlier round misread
    the quirk as A^-2 composition; round-3 review)."""
    L, dx, dt = 64, 1.0 / 64, 5e-4
    gamma, lam, beta = 0.2, 0.6, 1.5
    rng = np.random.default_rng(3)
    rho_p = rng.random(L)
    rho_m = rng.random(L)
    s = rho_p.sum() + rho_m.sum()
    rho_p, rho_m = rho_p / s, rho_m / s

    D = diags([1.0, -2.0, 1.0], [-1, 0, 1], shape=(L, L)).tolil()
    D[0, 1] = 2.0
    D[-1, -2] = 2.0
    A = (diags(np.ones(L), 0) - gamma * dt * D / dx ** 2).tocsr()

    for legacy in (False, True):
        # the reference solves twice FROM THE SAME INPUT — equals one solve
        p = spsolve(A, rho_p)
        m = spsolve(A, rho_m)
        mag = (rho_p - rho_m) / (rho_p + rho_m + 1e-12)  # pre-step densities
        cw = lambda sg: np.clip(np.exp(-beta * sg * mag), 1e-8, 1e8)
        R_p = cw(-1) * m - cw(+1) * p
        p_star = np.clip(p + dt * R_p, 0, None)
        m_star = np.clip(m - dt * R_p, 0, None)
        dp = np.empty(L)
        dp[1:] = (p_star[1:] - p_star[:-1]) / dx
        dp[0] = 0.0
        p2 = np.clip(p_star + dt * (-lam * dp), 0, None)
        M0 = (p + m).sum()
        M1 = (p2 + m_star).sum()
        p_ref, m_ref = p2 * M0 / M1, m_star * M0 / M1

        config = PDEConfig(L=L, xlim=1.0, T=dt, dt=dt, bc="neumann",
                           active_model="anchored_minus",
                           legacy_double_diffusion=legacy)
        params = make_pde_params(gamma=gamma, lam=lam, beta=beta)
        ops = build_pde_ops(config, params)
        p1, m1 = pde_step(config, params, ops,
                          jnp.asarray(rho_p, jnp.float32),
                          jnp.asarray(rho_m, jnp.float32))
        np.testing.assert_allclose(np.asarray(p1), p_ref, rtol=5e-4,
                                   atol=1e-6, err_msg=f"legacy={legacy}")
        np.testing.assert_allclose(np.asarray(m1), m_ref, rtol=5e-4,
                                   atol=1e-6, err_msg=f"legacy={legacy}")


def test_banded_solver_matches_spectral():
    """Large-L scale path: the banded (truncated inverse-kernel convolution)
    solve equals the exact spectral solve to float precision for both BCs."""
    from hydrolim_tpu.ops.diffusion import build_diffusion_op, diffusion_solve

    L, dx, dt, gamma = 512, 1.0 / 512, 5e-4, 0.2
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.random(L), jnp.float32)
    for exact_kind, banded_kind in (("fft", "banded"),
                                    ("dct", "banded_dct")):
        bc = "periodic" if exact_kind == "fft" else "neumann"
        exact = diffusion_solve(
            build_diffusion_op(L, dx, dt, gamma, bc, exact_kind), x,
            exact_kind)
        banded = diffusion_solve(
            build_diffusion_op(L, dx, dt, gamma, bc, banded_kind), x,
            banded_kind)
        np.testing.assert_allclose(np.asarray(banded), np.asarray(exact),
                                   rtol=2e-5, atol=1e-7,
                                   err_msg=exact_kind)


def test_large_L_pde_step_banded():
    """L = 131072 IMEX step (auto-selects the banded solver — the dense
    spectral matrix would be 64 GiB): runs, conserves mass, stays finite.
    Fixed resolution, growing domain (xlim = L·dx) — the long-context
    scaling regime."""
    L = 1 << 17
    config = PDEConfig(L=L, xlim=L * 1e-3, T=5e-4, dt=5e-4, bc="periodic")
    assert config.solver_kind == "banded"
    params = make_pde_params(gamma=0.1, lam=0.6, beta=1.5)
    ops = build_pde_ops(config, params)
    rng = np.random.default_rng(6)
    p = jnp.asarray(rng.random(L) / L, jnp.float32)
    m = jnp.asarray(rng.random(L) / L, jnp.float32)
    M0 = float(jnp.sum(p + m))
    p1, m1 = pde_step(config, params, ops, p, m)
    assert np.all(np.isfinite(np.asarray(p1)))
    assert abs(float(jnp.sum(p1 + m1)) - M0) < 1e-5 * M0


def test_tracer_window_span_unbiased():
    """A constant-velocity tracer must report v_eff == its true velocity:
    the windowed displacement spans exactly `window` steps.  Regression for
    the round-3 review finding: reading hist[(n+1) % window] AFTER writing
    slot n % window spanned only window-1 steps, biasing every v_eff/D_eff
    record by (window-1)/window."""
    import jax
    from hydrolim_tpu.pde.stepper import _tracer_update, TracerState

    window, dt = 10, 1e-3
    config = PDEConfig(L=64, xlim=1.0, T=1.0, dt=dt,
                       tracer_window_time=window * dt)
    assert config.tracer_window == window
    # gamma=0 -> no noise; spin +1 in an m=+1 field at beta=50 -> flip rate
    # clipped to 1e-8, so velocity is constant lam = 1.0
    params = make_pde_params(gamma=0.0, lam=1.0, beta=50.0)
    n_tr = 8
    tr = TracerState(pos=jnp.zeros((n_tr,), jnp.float32),
                     unwrapped=jnp.zeros((n_tr,), jnp.float32),
                     spin=jnp.ones((n_tr,), jnp.float32),
                     hist=jnp.zeros((window, n_tr), jnp.float32))
    m_field = jnp.ones((64,), jnp.float32)
    key = jax.random.PRNGKey(0)
    recs = []
    for n in range(3 * window):
        key, sub = jax.random.split(key)
        tr, v_eff, D_eff = _tracer_update(config, params, m_field, tr, sub,
                                          jnp.asarray(n))
        recs.append((float(v_eff), float(D_eff)))
    assert np.isnan(recs[window - 1][0])        # window not yet filled
    for v, D in recs[window:]:
        assert abs(v - 1.0) < 1e-5              # was 0.9 before the fix
        assert abs(D) < 1e-8


def test_record_every_thins_per_step_series():
    """config.record_every thins the returned records to n_records rows
    (every record_every-th iteration) without touching the dynamics — the
    thinned series equals the full run's rows [::record_every]."""
    import jax
    from hydrolim_tpu.pde.init import pde_initialize
    from hydrolim_tpu.pde.stepper import build_pde_ops, pde_solve

    kw = dict(L=64, xlim=1.0, T=0.02, dt=1e-3, bc="periodic",
              snapshot_interval=10, n_tracers=8)
    c1 = PDEConfig(**kw)
    c5 = PDEConfig(**kw, record_every=5)
    assert c5.n_records == c5.nsteps // 5 + 1
    params = make_pde_params(gamma=0.05, lam=0.6, beta=1.5)
    ops = build_pde_ops(c1, params)
    key = jax.random.PRNGKey(7)
    rho_p, rho_m, tr = pde_initialize(c1, key, mode="homogeneous",
                                      rho0=1.0, noise=0.1, n_tracers=8)
    k2 = jax.random.PRNGKey(9)
    full = pde_solve(c1, params, ops, rho_p, rho_m, tr, k2)
    thin = pde_solve(c5, params, ops, rho_p, rho_m, tr, k2)
    assert thin.records.m_mean.shape[0] == c5.n_records
    for name in ("m_mean", "var", "v_eff", "D_eff"):
        np.testing.assert_array_equal(
            np.asarray(getattr(thin.records, name)),
            np.asarray(getattr(full.records, name))[::5])
    np.testing.assert_array_equal(np.asarray(thin.rho_p),
                                  np.asarray(full.rho_p))


def test_fetch_snapshots_false_drops_blocks_keeps_records():
    """The sweep drivers' transfer opt-out: records identical, snapshot
    blocks empty (they are ~0.4 GB at reference scale)."""
    from hydrolim_tpu.sweeps.pde_sweeps import run_pde_ensemble

    config = PDEConfig(L=64, T=0.1, dt=1e-3, gaussian_kernel=True,
                       kernel_sigma=0.05, snapshot_interval=50, n_tracers=16)
    kw = dict(gamma=0.2, lam=0.6, n_runs=2, seed=3, n_tracers=16)
    full, fb = run_pde_ensemble(config, [0.5, 2.0], **kw)
    thin, fb2 = run_pde_ensemble(config, [0.5, 2.0], fetch_snapshots=False,
                                 **kw)
    np.testing.assert_array_equal(fb, fb2)
    np.testing.assert_array_equal(np.asarray(full.records.m_mean),
                                  np.asarray(thin.records.m_mean))
    np.testing.assert_array_equal(np.asarray(full.records.v_eff),
                                  np.asarray(thin.records.v_eff))
    np.testing.assert_array_equal(np.asarray(full.rho_p),
                                  np.asarray(thin.rho_p))
    assert full.snapshots.shape[1] > 0
    assert thin.snapshots.shape[1] == 0 and thin.m_snapshots.shape[1] == 0


def test_gamma_zero_ensemble_promotes_to_identity_solver():
    """run_pde_ensemble must resolve diffusion_solver='auto' to 'identity'
    at gamma=0 like the IMEXPDE facade (the 'magn' sweep variant would
    otherwise pay two (L, L) DFT round-trips per step computing A^-1 = I,
    and accumulate f32 round-trip noise)."""
    import numpy as np

    from hydrolim_tpu.core.config import PDEConfig
    from hydrolim_tpu.sweeps.pde_sweeps import run_pde_ensemble

    kw = dict(L=64, T=0.02, dt=1e-3, bc="periodic", gaussian_kernel=True,
              kernel_sigma=0.05, snapshot_interval=10, n_tracers=8)
    res_auto, _ = run_pde_ensemble(
        PDEConfig(**kw), [1.5], gamma=0.0, lam=0.6, n_runs=2, seed=5,
        n_tracers=8)
    res_id, _ = run_pde_ensemble(
        PDEConfig(**kw, diffusion_solver="identity"), [1.5], gamma=0.0,
        lam=0.6, n_runs=2, seed=5, n_tracers=8)
    # the promotion makes 'auto' the SAME program as explicit 'identity'
    np.testing.assert_array_equal(np.asarray(res_auto.rho_p),
                                  np.asarray(res_id.rho_p))
    np.testing.assert_array_equal(np.asarray(res_auto.records.m_mean),
                                  np.asarray(res_id.records.m_mean))
    # and the spectral solve at gamma=0 is the identity up to f32 noise
    res_fft, _ = run_pde_ensemble(
        PDEConfig(**kw, diffusion_solver="fft"), [1.5], gamma=0.0,
        lam=0.6, n_runs=2, seed=5, n_tracers=8)
    np.testing.assert_allclose(np.asarray(res_fft.rho_p),
                               np.asarray(res_id.rho_p), rtol=2e-4,
                               atol=2e-6)
