"""PDE experiment drivers.

Batched re-designs of the three reference driver scripts:

- :func:`pde_single_run` — `IMEX_PDE_solver_run.py` (L=1000, T=20, γ=0,
  λ=0.6, β=2, periodic, kernel σ=0.005, seed=58),
- :func:`pde_beta_sweep` — `IMEX_PDE_solver_run_sweep.py`: β grid × runs
  with near-global kernel (σ=1e5−10), windowed v/D means vs theory overlay.
  The reference's nested Python loops (:19-25) become one vmapped batch:
  β enters only through the flip rate, so the whole (β × runs) grid advances
  in a single compiled scan.
- :func:`pde_kernel_sigma_sweep` — `IMEX_PDE_solver_run_sweep_magn{,2}.py`:
  per-σ run ensembles (vmapped over runs; σ loops in Python since it changes
  the compiled smoothing operator), |m|/|v|/D/Var mean±std band figures.
  ``variant='magn'`` (T=40, γ=0, β=0.5) / ``'magn2'`` (T=10, γ=0.2, β=0.75).
"""
from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from hydrolim_tpu.core.config import (
    PDE_ENGINES,
    PDEConfig,
    PDEParams,
    check_engine,
    make_pde_params,
)
from hydrolim_tpu.pde.init import pde_initialize
from hydrolim_tpu.pde.stepper import build_pde_ops, pde_solve
from hydrolim_tpu.theory.meanfield import compute_m_of_beta


def run_pde_ensemble(config: PDEConfig, beta_values, *, gamma: float,
                     lam: float, n_runs: int, seed: int = 0,
                     mode: str = "homogeneous", rho0: float = 1.0,
                     noise: float = 0.3, n_tracers: int = 1000,
                     engine: str = "xla", fetch_snapshots: bool = True,
                     mesh=None, n_devices=None, ckpt_dir=None):
    """Vmapped (β × runs) PDE batch; returns the batched PDESolveResult and
    the flattened β array.  ``engine='xla'`` is the one engine.

    ``fetch_snapshots=False`` skips transferring the per-interval ρ
    snapshot blocks (empty (B, 0, L) arrays in the result) — the sweep
    drivers only consume the per-step records, and the snapshot blocks
    dominate the device→host transfer at reference scale (1600 blocks ×
    33 replicas × 2 fields ≈ 0.4 GB).

    ``mesh=``/``n_devices=`` shard the flattened (β × runs) batch over the
    mesh's 'sweep' axis (batch padded to the mesh multiple with
    bit-identical real replicas — parallel.mesh.pad_batch).

    ``ckpt_dir=`` makes the in-flight grid program preemption-safe: the
    batched snapshot-block scan runs through
    :func:`~hydrolim_tpu.utils.checkpoint.run_pde_ensemble_checkpointed`
    (bit-identical stitched result); composes with
    ``n_devices=``/``mesh=`` — a resumed carry is re-placed with the run's
    sweep sharding."""
    from hydrolim_tpu.parallel.mesh import pad_and_shard, resolve_sweep_mesh

    check_engine(engine, PDE_ENGINES)
    if float(gamma) == 0.0 and config.diffusion_solver == "auto":
        # A = I exactly at gamma=0: skip the spectral solve entirely (the
        # IMEXPDE facade does the same).  Without this, the 'magn' variant
        # (gamma=0, 80k steps) pays two (L, L) DFT round-trips per step
        # that compute the identity — and accumulates f32 round-trip noise
        # the reference's exact spsolve(I, rho) doesn't have.
        config = dataclasses.replace(config, diffusion_solver="identity")
    beta_values = np.atleast_1d(np.asarray(beta_values, dtype=np.float32))
    flat_beta = np.repeat(beta_values, n_runs)
    B = flat_beta.shape[0]
    params_b = PDEParams(
        gamma=jnp.full((B,), gamma, jnp.float32),
        lam=jnp.full((B,), lam, jnp.float32),
        beta=jnp.asarray(flat_beta))
    ops = build_pde_ops(config, make_pde_params(gamma=gamma, lam=lam,
                                                beta=0.0))
    mesh = resolve_sweep_mesh(mesh, n_devices)
    params_b, Bp = pad_and_shard(mesh, params_b, B)
    keys = jax.random.split(jax.random.PRNGKey(seed), Bp)
    init_fn = functools.partial(pde_initialize, config, mode=mode, rho0=rho0,
                                noise=noise, n_tracers=n_tracers)
    rho_p, rho_m, tracers = jax.vmap(init_fn)(keys)
    solve_keys = jax.vmap(lambda k: jax.random.fold_in(k, 1))(keys)
    if ckpt_dir is not None:
        from hydrolim_tpu.utils.checkpoint import (
            run_pde_ensemble_checkpointed,
        )

        res = run_pde_ensemble_checkpointed(
            config, params_b, ops, rho_p, rho_m, tracers, solve_keys,
            ckpt_dir=ckpt_dir, keep_snapshots=fetch_snapshots, mesh=mesh)
    else:
        solve = jax.vmap(
            lambda p, rp, rm, tr, k: pde_solve(config, p, ops, rp, rm, tr,
                                               k))
        res = solve(params_b, rho_p, rho_m, tracers, solve_keys)
    if Bp != B:
        res = jax.tree.map(lambda a: a[:B], res)
    if not fetch_snapshots:
        res = res._replace(snapshots=jnp.zeros((B, 0, config.L)),
                           m_snapshots=jnp.zeros((B, 0, config.L)),
                           snap_times=jnp.zeros((B, 0)))
    return jax.device_get(res), flat_beta


def pde_single_run(outdir: str = "IMEX_output", seed: int = 58,
                   ckpt_dir=None, **overrides):
    """Single-run driver (IMEX_PDE_solver_run.py:7-34).  ``ckpt_dir=``
    routes the solve through the facade's mid-run checkpoint/resume."""
    from hydrolim_tpu.pde.system import IMEXPDE

    kw = dict(L=1000, T=20.0, dt=5e-4, gamma=0.0, lam=0.6, beta=2.0,
              bc="periodic", active_model="bidirectional",
              gaussian_kernel=True, kernel_sigma=0.005, snapshot_interval=50,
              outdir=outdir, seed=seed)
    kw.update(overrides)
    solver = IMEXPDE(**kw)
    solver.initialize(mode="homogeneous", rho0=1.0, noise=0.3)
    if ckpt_dir is not None:
        solver.solve_checkpointed(ckpt_dir=ckpt_dir)
    else:
        solver.solve()
    solver.plot_all()
    solver.plot_individual()
    return solver.get_output()


def pde_beta_sweep(beta_values=None, n_runs: int = 3, T: float = 40.0,
                   t_min: float = 20.0, t_max: float = 40.0,
                   gamma: float = 0.2, lam: float = 0.6,
                   kernel_sigma: float = 1e5 - 10, L: int = 1000,
                   dt: float = 5e-4, seed: int = 0, n_tracers: int = 1000,
                   outdir: str = ".", plot_result: bool = True,
                   engine: str = "xla", n_devices=None,
                   ckpt_dir=None) -> Dict:
    """β sweep with theory overlay (IMEX_PDE_solver_run_sweep.py).

    v per run is |nanmean v_eff(t)| over [t_min, t_max] (:53-59); errorbars
    vs λ·tanh(βm_β) and γ+λ²/(2cosh³) (:80-132)."""
    if beta_values is None:
        beta_values = np.linspace(0, 3, 11)
    beta_values = np.asarray(beta_values, dtype=float)
    config = PDEConfig(L=L, T=T, dt=dt, bc="periodic",
                       active_model="bidirectional", gaussian_kernel=True,
                       kernel_sigma=kernel_sigma, snapshot_interval=2000,
                       fft_kmax=8)
    res, flat_beta = run_pde_ensemble(config, beta_values, gamma=gamma,
                                      lam=lam, n_runs=n_runs, seed=seed,
                                      n_tracers=n_tracers, engine=engine,
                                      fetch_snapshots=False,
                                      n_devices=n_devices,
                                      ckpt_dir=ckpt_dir)
    t = np.linspace(0, T, config.nsteps + 1)
    mask = (t >= t_min) & (t <= t_max)
    n_iters = config.nsteps + 1

    v_mean, v_err, D_mean, D_err = [], [], [], []
    for b_idx in range(len(beta_values)):
        v_runs, D_runs = [], []
        for r in range(n_runs):
            i = b_idx * n_runs + r
            v_ts = np.asarray(res.records.v_eff[i])[:n_iters]
            D_ts = np.asarray(res.records.D_eff[i])[:n_iters]
            v_runs.append(abs(np.nanmean(v_ts[mask])))
            D_runs.append(np.nanmean(D_ts[mask]))
        v_runs, D_runs = np.array(v_runs), np.array(D_runs)
        v_mean.append(v_runs.mean())
        v_err.append(v_runs.std(ddof=1) / np.sqrt(n_runs) if n_runs > 1 else 0)
        D_mean.append(D_runs.mean())
        D_err.append(D_runs.std(ddof=1) / np.sqrt(n_runs) if n_runs > 1 else 0)
    v_mean, v_err = np.array(v_mean), np.array(v_err)
    D_mean, D_err = np.array(D_mean), np.array(D_err)

    beta_dense = np.linspace(beta_values.min(), max(beta_values.max(), 1e-9),
                             400)
    m_dense = compute_m_of_beta(beta_dense)
    v_theory = lam * np.tanh(beta_dense * m_dense)
    D_theory = gamma + lam ** 2 / (2 * np.cosh(beta_dense * m_dense) ** 3)

    if plot_result:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        out = Path(outdir)
        out.mkdir(parents=True, exist_ok=True)
        for sim, err, th, ylabel, fname in (
                (v_mean, v_err, v_theory, r"$v_{\mathrm{eff}}$",
                 "pde_v_eff_vs_beta.png"),
                (D_mean, D_err, D_theory, r"$D_{\mathrm{eff}}$",
                 "pde_D_eff_vs_beta.png")):
            plt.figure(figsize=(6, 4))
            plt.errorbar(beta_values, sim, yerr=err, fmt="o", capsize=4,
                         label="PDE simulation ± SE")
            plt.plot(beta_dense, th, "--", color="navy", label="theory")
            plt.xlabel(r"$\beta$")
            plt.ylabel(ylabel)
            plt.legend()
            plt.grid()
            plt.tight_layout()
            plt.savefig(out / fname, dpi=200)
            plt.close()

    return dict(beta_values=beta_values, v_mean=v_mean, v_err=v_err,
                D_mean=D_mean, D_err=D_err)


MAGN_VARIANTS = {
    # IMEX_PDE_solver_run_sweep_magn.py:25-42
    "magn": dict(T=40.0, gamma=0.0, beta=0.5),
    # IMEX_PDE_solver_run_sweep_magn2.py (diff at :27-31)
    "magn2": dict(T=10.0, gamma=0.2, beta=0.75),
}

REFERENCE_KERNEL_SIGMAS = [0.0005, 0.005, 0.05, 0.1, 1.0]


def pde_kernel_sigma_sweep(kernel_sigma_values=None, n_runs: int = 5,
                           variant: str = "magn", base_seed: int = 100,
                           L: int = 1000, dt: float = 5e-4, lam: float = 0.6,
                           n_tracers: int = 1000, outdir: str = ".",
                           plot_result: bool = True,
                           record_every: int = 1, engine: str = "xla",
                           n_devices=None, ckpt_dir=None,
                           **overrides) -> Dict:
    """Kernel-σ sweep: per-σ time series of |m|, |v_eff|, D_eff, Var(t)
    (mean ± std bands across runs).  Seeds follow the reference scheme
    seed = base + 1000·k_idx + r (:64) via fold_in."""
    if kernel_sigma_values is None:
        kernel_sigma_values = REFERENCE_KERNEL_SIGMAS
    v = dict(MAGN_VARIANTS[variant])
    v.update(overrides)
    T, gamma, beta = v["T"], v["gamma"], v["beta"]

    m_results, v_results, D_results, var_results = {}, {}, {}, {}
    for k_idx, sigma in enumerate(kernel_sigma_values):
        config = PDEConfig(L=L, T=T, dt=dt, bc="periodic",
                           active_model="bidirectional",
                           gaussian_kernel=True, kernel_sigma=float(sigma),
                           snapshot_interval=2000, fft_kmax=8,
                           record_every=record_every)
        res, _ = run_pde_ensemble(config, [beta], gamma=gamma, lam=lam,
                                  n_runs=n_runs,
                                  seed=base_seed + 1000 * k_idx,
                                  n_tracers=n_tracers, engine=engine,
                                  fetch_snapshots=False,
                                  n_devices=n_devices,
                                  ckpt_dir=None if ckpt_dir is None else
                                  str(Path(ckpt_dir) / f"sigma_{sigma:.4g}"))
        n_rec = config.n_records        # nsteps+1 thinned by record_every
        m_results[sigma] = np.abs(np.asarray(res.records.m_mean)[:, :n_rec])
        v_results[sigma] = np.abs(np.asarray(res.records.v_eff)[:, :n_rec])
        D_results[sigma] = np.asarray(res.records.D_eff)[:, :n_rec]
        var_results[sigma] = np.asarray(res.records.var)[:, :n_rec]

    if plot_result:
        _plot_magn_bands(kernel_sigma_values, m_results, v_results,
                         D_results, var_results, T, outdir)
    return dict(m=m_results, v=v_results, D=D_results, var=var_results,
                T=T, gamma=gamma, beta=beta)


def _plot_magn_bands(sigmas, m_results, v_results, D_results, var_results,
                     T, outdir) -> None:
    """The four mean±std band figures (IMEX_PDE_solver_run_sweep_magn.py
    :100-204)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    colors = plt.cm.Blues(np.linspace(0.4, 0.9, len(sigmas)))
    t = np.linspace(0, T, m_results[sigmas[0]].shape[1])

    panels = (
        (m_results, r"$|m(t)|$", "magnitude_magnetization_sweep.png",
         dict(xlim=(0, min(10, T)), ylim=(0, 1))),
        (v_results, r"$|v_{\mathrm{eff}}(t)|$",
         "magnitude_velocity_sweep.png", dict(xlim=(0.05, min(10, T)))),
        (D_results, r"$D_{\mathrm{eff}}(t)$", "diffusion_sweep.png", {}),
        (var_results, r"$\mathrm{Var}(t)$", "variance_sweep.png", {}),
    )
    for results, ylabel, fname, lims in panels:
        plt.figure(figsize=(8, 5))
        for color, sigma in zip(colors, sigmas):
            data = results[sigma]
            mean = np.nanmean(data, axis=0)
            std = np.nanstd(data, axis=0)
            plt.plot(t, mean, color=color, lw=2, label=rf"$\sigma={sigma}$")
            plt.fill_between(t, mean - std, mean + std, color=color,
                             alpha=0.25)
        plt.xlabel("$t$")
        plt.ylabel(ylabel)
        plt.legend()
        plt.grid()
        if "xlim" in lims:
            plt.xlim(*lims["xlim"])
        if "ylim" in lims:
            plt.ylim(*lims["ylim"])
        plt.tight_layout()
        plt.savefig(out / fname, dpi=200)
        plt.close()
