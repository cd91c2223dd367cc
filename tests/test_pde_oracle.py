"""The XLA IMEX PDE step against an independent float64 NumPy step over
{global, smooth, narrow} magnetization × {periodic, Neumann} ×
{bidirectional, anchored_minus}, and the replica independence of the
vmapped batch solve the sweep drivers run."""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.sparse import diags
from scipy.sparse.linalg import spsolve

from hydrolim_tpu.core.config import PDEConfig, PDEParams, make_pde_params
from hydrolim_tpu.pde.init import pde_initialize
from hydrolim_tpu.pde.stepper import build_pde_ops, pde_solve, pde_step

#: (L, kernel_sigma, diffusion_solver) per magnetization mode: the global
#: mean (σ past the 1e5 sentinel), a dense circulant smoothing, and a
#: kernel two sites wide on a lattice past the banded-convolution threshold
#: (fields/magnetization.py), solved by the banded kernel there as well
MODES = {"global": (64, 2e5, "auto"), "smooth": (64, 0.05, "auto"),
         "narrow": (4224, 2.0 / 4224, "banded")}


def _oracle_step(rho_p, rho_m, *, dx, dt, gamma, lam, beta, bc, model,
                 sigma):
    """One IMEX step in float64, written from the discretization: sparse
    implicit diffusion, Curie–Weiss reaction at the pre-step magnetization
    (periodic Gaussian smoothing, or the global mean past σ = 1e5), upwind
    advection, clip, and renormalization to the post-diffusion mass."""
    L = rho_p.shape[0]
    D = diags([1.0, -2.0, 1.0], [-1, 0, 1], shape=(L, L)).tolil()
    if bc == "periodic":
        D[0, -1] = D[-1, 0] = 1.0
    else:
        D[0, 1] = D[-1, -2] = 2.0
    A = (diags(np.ones(L), 0) - gamma * dt * D / dx ** 2).tocsc()
    p, m = spsolve(A, rho_p), spsolve(A, rho_m)

    num, den = rho_p - rho_m, rho_p + rho_m
    if sigma > 1e5:
        mag = np.full(L, num.sum() / (den.sum() + 1e-12))
    else:
        j = np.arange(L)
        k = np.exp(-0.5 * (np.minimum(j, L - j) * dx / sigma) ** 2)
        K = np.fft.rfft(k / k.sum())
        conv = lambda x: np.fft.irfft(np.fft.rfft(x) * K, n=L)
        mag = conv(num) / (conv(den) + 1e-12)
    cw = lambda s: np.clip(np.exp(-beta * s * mag), 1e-8, 1e8)
    R_p = cw(-1) * m - cw(+1) * p

    def d_back(x):                      # right-moving species
        d = np.empty(L)
        d[1:] = (x[1:] - x[:-1]) / dx
        d[0] = (x[0] - x[-1]) / dx if bc == "periodic" else 0.0
        return d

    def d_fwd(x):                       # left-moving species
        d = np.empty(L)
        d[:-1] = (x[1:] - x[:-1]) / dx
        d[-1] = (x[0] - x[-1]) / dx if bc == "periodic" else 0.0
        return d

    if model == "bidirectional":
        p2 = np.clip(p + dt * (-lam * d_back(p) + R_p), 0, None)
        m2 = np.clip(m + dt * (lam * d_fwd(m) - R_p), 0, None)
    else:                               # reaction, then advect rho_p only
        p_star = np.clip(p + dt * R_p, 0, None)
        m2 = np.clip(m - dt * R_p, 0, None)
        p2 = np.clip(p_star - dt * lam * d_back(p_star), 0, None)
    scale = (p + m).sum() / (p2 + m2).sum()
    return p2 * scale, m2 * scale


@pytest.mark.parametrize("model", ["bidirectional", "anchored_minus"])
@pytest.mark.parametrize("bc", ["periodic", "neumann"])
@pytest.mark.parametrize("mode", list(MODES))
def test_pde_step_matches_float64_oracle(mode, bc, model):
    L, sigma, solver = MODES[mode]
    dx = 1.0 / L
    # advective CFL 0.25 and a diffusive number γ·dt/dx² ≈ 0.6
    dt = 0.25 * dx / 0.6
    gamma = 0.6 * dx * dx / dt
    rng = np.random.default_rng(zlib.crc32(f"{mode}{bc}{model}".encode()))
    rho_p = 1.0 + 0.3 * rng.standard_normal(L).clip(-3, 3)
    rho_m = 1.0 + 0.3 * rng.standard_normal(L).clip(-3, 3)
    config = PDEConfig(L=L, xlim=1.0, T=dt, dt=dt, bc=bc,
                       active_model=model, gaussian_kernel=True,
                       kernel_sigma=sigma, diffusion_solver=solver)
    params = make_pde_params(gamma=gamma, lam=0.6, beta=1.5)
    ops = build_pde_ops(config, params)
    p1, m1 = pde_step(config, params, ops, jnp.asarray(rho_p, jnp.float32),
                      jnp.asarray(rho_m, jnp.float32))
    p_ref, m_ref = _oracle_step(rho_p, rho_m, dx=dx, dt=dt, gamma=gamma,
                                lam=0.6, beta=1.5, bc=bc, model=model,
                                sigma=sigma)
    np.testing.assert_allclose(np.asarray(p1), p_ref, rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(m1), m_ref, rtol=5e-4, atol=1e-5)


def _batch(B=3, L=64):
    config = PDEConfig(L=L, T=0.05, dt=1e-3, gaussian_kernel=True,
                       kernel_sigma=0.05, snapshot_interval=10, n_tracers=16,
                       fft_kmax=8)
    params_b = PDEParams(gamma=jnp.full(B, 0.2), lam=jnp.full(B, 0.6),
                         beta=jnp.asarray([0.5, 1.5, 2.5][:B]))
    ops = build_pde_ops(config, make_pde_params(gamma=0.2, lam=0.6, beta=0.0))
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    rp, rm, tr = jax.vmap(lambda k: pde_initialize(
        config, k, mode="homogeneous", noise=0.2, n_tracers=16))(keys)
    solve = jax.jit(jax.vmap(
        lambda p, a, b, t, k: pde_solve(config, p, ops, a, b, t, k)))
    return config, ops, params_b, (rp, rm, tr), keys, solve


def test_vmapped_solve_matches_single_replicas():
    """Each replica of the vmapped batch solve equals its own unbatched
    solve (fields and per-step records; batching may only reassociate)."""
    config, ops, params_b, (rp, rm, tr), keys, solve = _batch()
    res = solve(params_b, rp, rm, tr, keys)
    for i in range(3):
        take = lambda x: jax.tree.map(lambda a: a[i], x)
        one = pde_solve(config, take(params_b), ops, rp[i], rm[i], take(tr),
                        keys[i])
        for got, want in ((res.rho_p[i], one.rho_p),
                          (res.records.m_mean[i], one.records.m_mean),
                          (res.records.v_eff[i], one.records.v_eff)):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       rtol=1e-5, atol=1e-7)


def test_vmapped_solve_replicas_independent():
    """Changing one replica's β leaves every other replica of the batch
    bit-identical: the batch axis carries no coupling."""
    _, _, params_b, (rp, rm, tr), keys, solve = _batch()
    a = solve(params_b, rp, rm, tr, keys)
    b = solve(params_b._replace(beta=params_b.beta.at[0].set(3.0)), rp, rm,
              tr, keys)
    assert not np.array_equal(np.asarray(a.rho_p[0]), np.asarray(b.rho_p[0]))
    for leaf_a, leaf_b in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(leaf_a)[1:],
                                      np.asarray(leaf_b)[1:])
