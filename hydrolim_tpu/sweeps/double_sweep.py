"""(N, β) double sweep — exclusion-constant calibration.

Mirrors `PARTICLE_solver_BIOLOGY_EXCLUSION_double_sweep.py`: per particle
count N, the blocking probability p_block(β) is fitted with the 2-parameter
model ρ_block = (ρ̄/K)·(f + g/cosh(β·m_β)) (:290-317); the per-N (f, g) fits
are then meta-fitted over x = ρ̄ with f(x) = C0 − C1·x and g(x) = C2/x^{3/2}
(:877-961) — this is the pipeline that produced the frozen C0/C1/C2
constants (BASELINE.md).  The double-sweep branch scales the tanh fixed
point by 0.62 (:228, SURVEY.md §2.4) — exposed as ``m_scale``.

The defaults here are ``DOUBLE_SWEEP_PS_KWARGS`` — the reference double
sweep's OWN physics block (:666-694), which differs from the β-sweep's
(rate_diffusion 0.005 vs 0.02, rate_active 10 vs 5, kernel σ 0.02 vs
0.005, plus-gradient decay 0.2 vs 0.35).  Rounds 1-3 initially ran this
driver on the β-sweep config; the fitted constants then land ~2× off the
frozen C2 (see VALIDATION.md round-3 closing).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
from scipy.optimize import curve_fit

from hydrolim_tpu.sweeps.beta_sweep import DEFAULT_PS_KWARGS, sweep_over_betas
from hydrolim_tpu.theory.meanfield import compute_m_of_beta_non

# The reference's double sweep runs a DIFFERENT physics configuration than
# its β-sweep (PARTICLE_solver_BIOLOGY_EXCLUSION_double_sweep.py:666-694):
# slower diffusion, faster active hopping, a 4× wider interaction kernel,
# and a steeper initial plus-gradient (decay_length 0.2, :698-714 — the
# minus profile is flat so its decay_length never enters).  The frozen
# C0/C1/C2 constants (BASELINE.md) were produced at THIS configuration.
DOUBLE_SWEEP_PS_KWARGS: Dict = dict(
    DEFAULT_PS_KWARGS, rate_diffusion=0.005, rate_active=10,
    local_kernel_sigma=0.02)
DOUBLE_SWEEP_DECAY_LENGTH = 0.2


def rho_model(beta, f, g, rho_bar, K, m_beta):
    """ρ_block model (:290-292)."""
    return (rho_bar / K) * (f + g / np.cosh(np.asarray(beta) * m_beta))


def fit_blocking_fg(beta_values, block_means, block_ses, rho_bar, K,
                    p0=(4.0, 1.0), bounds=([0, 0], [100, 20])):
    """(f, g) fit of p_block(β) (:294-317)."""
    beta_values = np.asarray(beta_values, dtype=float)

    def model(beta, f, g):
        m_beta = compute_m_of_beta_non(beta)
        return rho_model(beta, f, g, rho_bar, K, m_beta)

    sigma = np.asarray(block_ses, dtype=float)
    sigma = np.where(sigma > 0, sigma, max(1e-6, np.nanmax(sigma)))
    popt, pcov = curve_fit(model, beta_values, np.asarray(block_means),
                           sigma=sigma, absolute_sigma=True, p0=list(p0),
                           bounds=bounds, maxfev=2_000_000)
    f_err, g_err = np.sqrt(np.diag(pcov))
    return popt[0], popt[1], f_err, g_err


def f_model(x, C0, C1):
    return C0 - C1 * x


def g_model(x, C2):
    return C2 / x ** 1.5


def _plot_fg(out: Path, x_vals, f_vals, f_errs, g_vals, g_errs,
             C0: float, C1: float, C2: float) -> None:
    """f_fit.png / g_fit.png — the reference's meta-fit figures (:877-961);
    shared by both double-sweep drivers."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x_dense = np.linspace(np.min(x_vals), np.max(x_vals), 300)
    for vals, errs, model, args, label, fname in (
            (f_vals, f_errs, f_model, (C0, C1), r"$C_0 - C_1 x$",
             "f_fit.png"),
            (g_vals, g_errs, g_model, (C2,), r"$C_2 / x^{3/2}$",
             "g_fit.png")):
        plt.figure(figsize=(6, 4))
        plt.errorbar(x_vals, vals, yerr=errs, fmt="o", capsize=3,
                     label="fit data")
        plt.plot(x_dense, model(x_dense, *args), "--", label=label)
        plt.xlabel("x")
        plt.ylabel(fname[0])
        plt.legend()
        plt.grid(True)
        plt.tight_layout()
        plt.savefig(out / fname, dpi=200)
        plt.close()


def double_sweep_fused(beta_values, list_N_part: Sequence[float],
                       n_runs_per_beta: int = 4,
                       ps_kwargs: Optional[Dict] = None,
                       run_kwargs: Optional[Dict] = None, outdir: str = ".",
                       seed: int = 0, plot_result: bool = True,
                       chunk_size: int = 44, engine: str = "particle",
                       n_devices: Optional[int] = None, ckpt_dir=None,
                       resume: bool = True,
                       stop_after_chunks: Optional[int] = None) -> Dict:
    """The whole (N × β × replicas) grid as ONE compiled program.

    N enters only through the Poisson init intensities, so every grid point
    shares array shapes (buffer sized for max N) and the triple loop of the
    reference (:851-873) compiles exactly once; the batch executes in
    fixed-size chunks (``chunk_size`` replicas, same shapes ⇒ same
    executable) to bound device memory.  Blocking-probability (f, g) fits
    and the C0/C1/C2 meta-fit run host-side afterwards.

    ``ckpt_dir=`` makes the grid preemption-safe at chunk granularity
    (a *chunk ledger*): each replica chunk's blocking probabilities are
    written atomically after the chunk completes, and a resumed call
    (``resume=True``) re-executes only the chunks whose ledger entry is
    missing — chunks draw independent ``fold_in(seed, c0)`` keys, so the
    stitched result is bit-identical to an uninterrupted run.  Unlike the
    mid-scan checkpoints (utils.checkpoint), ``chunk_size`` IS part of the
    ledger hash here: it determines the key schedule, not just I/O layout.
    ``stop_after_chunks=k`` executes at most ``k`` new chunks and returns
    ``None`` if incomplete (simulated-preemption test hook; honored with
    or without a ledger).  ``engine`` is ``'particle'`` or
    ``'lattice_gas'`` (the K-slot site engine)."""
    import jax

    from hydrolim_tpu.core.config import PARTICLE_ENGINES, check_engine

    from hydrolim_tpu.sweeps.beta_sweep import (
        DEFAULT_PS_KWARGS,
        config_from_kwargs,
        make_exp_gradient,
    )
    from hydrolim_tpu.sweeps.ensemble import (
        broadcast_params,
        ensemble_dt,
        run_particle_ensemble,
    )

    check_engine(engine, PARTICLE_ENGINES)
    beta_values = np.asarray(beta_values, dtype=float)
    list_N_part = np.asarray(list_N_part, dtype=float)
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    base = dict(DOUBLE_SWEEP_PS_KWARGS, **(ps_kwargs or {}))
    rk = dict(T=10, obs_dt=0.1, record_fft=False, record_var=True)
    rk.update(run_kwargs or {})

    L = int(base["L"])
    N_max = int(list_N_part.max())
    config = config_from_kwargs(dict(base, N=N_max))
    nN, nB, nr = len(list_N_part), len(beta_values), n_runs_per_beta
    B = nN * nB * nr

    # per-replica Poisson profiles: (B, L)
    prof_p = np.zeros((B, L), np.float32)
    prof_m = np.zeros((B, L), np.float32)
    flat_beta = np.zeros((B,), np.float32)
    i = 0
    for N_part in list_N_part:
        g = make_exp_gradient(L=L, N=int(N_part), frac_plus=0.75,
                              decay_length=DOUBLE_SWEEP_DECAY_LENGTH,
                              anchor_positions=None)
        for b in beta_values:
            for _ in range(nr):
                prof_p[i] = g[2]
                prof_m[i] = g[3]
                flat_beta[i] = b
                i += 1

    dt = ensemble_dt(config, beta_max=float(beta_values.max()),
                     rate_diffusion=float(base["rate_diffusion"]),
                     rate_active=float(base["rate_active"]))
    T, obs_dt = float(rk["T"]), float(rk["obs_dt"])
    record_fft = bool(rk.get("record_fft", False))

    # run in fixed-size chunks (identical shapes → one executable); the
    # blocking estimator runs ON DEVICE for the whole chunk (# the per-replica host loop dominated at 836+ replicas)
    from hydrolim_tpu.observables.batched import batched_estimates
    from hydrolim_tpu.parallel.mesh import (
        resolve_sweep_mesh,
        shard_batch,
        sweep_axis_size,
    )

    mesh = resolve_sweep_mesh(None, n_devices)
    n_sw = sweep_axis_size(mesh)
    # chunk stride is mesh-independent (same fold_in(seed, c0) keys for
    # every mesh size); each chunk pads up to the mesh multiple instead —
    # see run_sweep_grid
    Cs = min(chunk_size, B)
    Bp = -(-Cs // n_sw) * n_sw
    p_block_flat = np.zeros((B,), float)
    times = np.arange(0.0, T, obs_dt)
    ledger = None
    if ckpt_dir is not None:
        # chunk ledger (see docstring): n_devices is deliberately NOT
        # hashed — the chunk stride and keys are mesh-independent, and the
        # on-device estimator agrees across shard layouts to ~1 ulp
        # (parallel.mesh.pad_batch, float-record reassociation).  Kwarg
        # values go to config_hash unmangled (it normalizes ndarrays by
        # value and callables by name — a repr() would truncate large
        # arrays and let different grids collide).
        from hydrolim_tpu.sweeps.persistence import config_hash
        from hydrolim_tpu.utils.checkpoint import _atomic_savez, _resume_prefix

        ledger = Path(ckpt_dir)
        ledger.mkdir(parents=True, exist_ok=True)
        run_hash = config_hash({
            "beta_values": beta_values.tolist(),
            "list_N_part": list_N_part.tolist(), "nr": nr,
            "base": dict(base), "rk": dict(rk),
            "seed": seed, "chunk_size": Cs, "engine": engine})
        _resume_prefix(ledger, run_hash, what="double sweep",
                       resume=resume, chunk_size=Cs, n_units=B,
                       size_key="chunk_size", unit_key="B",
                       adopt_chunk_size=False, scan_prefix=False)
    executed = 0
    incomplete = False
    for c0 in range(0, B, Cs):
        if ledger is not None:
            cpath = ledger / f"chunk_{c0:07d}.npz"
            if cpath.exists():
                with np.load(cpath) as z:
                    vals = z["p_block"]
                p_block_flat[c0:c0 + len(vals)] = vals
                continue
        if stop_after_chunks is not None and executed >= stop_after_chunks:
            incomplete = True
            break
        n_real = min(Cs, B - c0)
        sl = slice(c0, c0 + n_real)
        pad = Bp - n_real
        take = lambda a: np.concatenate(
            [a[sl], np.repeat(a[c0:c0 + 1], pad, axis=0)], axis=0) \
            if pad else a[sl]
        params_c = broadcast_params(
            config, beta=take(flat_beta),
            rate_diffusion=float(base["rate_diffusion"]),
            rate_active=float(base["rate_active"]))
        if mesh is not None:
            params_c = shard_batch(mesh, params_c, Bp)
        ckey = jax.random.fold_in(jax.random.PRNGKey(seed), c0)
        if engine == "lattice_gas":
            from hydrolim_tpu.particles.lattice_gas_k import run_lattice_gas_k

            frames, _ = run_lattice_gas_k(
                config, params_c, ckey, T=T, obs_dt=obs_dt, dt=dt,
                rho0_plus=take(prof_p), rho0_minus=take(prof_m),
                record_fft=False)
            total, rho_p, m_g = frames.total, frames.rho_p, frames.m_global
        else:
            res = run_particle_ensemble(
                config, params_c, ckey, T=T, obs_dt=obs_dt, dt=dt,
                rho0_plus=take(prof_p), rho0_minus=take(prof_m),
                record_pos=False, record_fft=record_fft)
            total, rho_p, m_g = (res.frames.total, res.frames.rho_p,
                                 res.frames.m_global)
        est = jax.device_get(batched_estimates(
            total, m_g, rho_p, times,
            dx=config.dx, xlim=float(config.xlim), has_positions=False))
        p_block_flat[sl] = np.asarray(est.p_block)[:n_real]
        if ledger is not None:
            _atomic_savez(ledger / f"chunk_{c0:07d}.npz",
                          p_block=p_block_flat[sl])
        executed += 1
    if incomplete:
        return None

    K = int(base["site_capacity"])
    f_fit, f_err, g_fit, g_err, per_N = [], [], [], [], []
    idx = 0
    for N_part in list_N_part:
        block_means, block_ses = [], []
        for b in beta_values:
            blks = []
            for _ in range(nr):
                blks.append(p_block_flat[idx])
                idx += 1
            blks = np.asarray(blks)
            block_means.append(blks.mean())
            block_ses.append(blks.std(ddof=1) / np.sqrt(nr) if nr > 1
                             else 0.0)
        rho_bar = float(N_part) / L
        f_v, g_v, f_e, g_e = fit_blocking_fg(beta_values, block_means,
                                             block_ses, rho_bar, K)
        f_fit.append(f_v)
        f_err.append(f_e)
        g_fit.append(g_v)
        g_err.append(g_e)
        per_N.append({"N": float(N_part), "block_means": block_means,
                      "block_ses": block_ses})

    x_vals = list_N_part / L
    f_vals = np.asarray(f_fit)
    f_errs = np.where(np.asarray(f_err) > 0, f_err, 1e-3)
    g_vals = np.asarray(g_fit)
    g_errs = np.where(np.asarray(g_err) > 0, g_err, 1e-3)
    (C0, C1), pcov_f = curve_fit(f_model, x_vals, f_vals, sigma=f_errs,
                                 absolute_sigma=True)
    (C2,), pcov_g = curve_fit(g_model, x_vals, g_vals, sigma=g_errs,
                              absolute_sigma=True)
    C0_err, C1_err = np.sqrt(np.diag(pcov_f))
    C2_err = float(np.sqrt(pcov_g[0, 0]))
    if plot_result:
        _plot_fg(out, x_vals, f_vals, f_errs, g_vals, g_errs,
                 float(C0), float(C1), float(C2))
    return {"N_values": list_N_part, "f_fit": f_vals,
            "f_err": np.asarray(f_err), "g_fit": g_vals,
            "g_err": np.asarray(g_err), "C0": float(C0), "C1": float(C1),
            "C2": float(C2), "C0_err": float(C0_err),
            "C1_err": float(C1_err), "C2_err": C2_err, "per_N": per_N}


def double_sweep(beta_values, list_N_part: Sequence[float],
                 n_runs_per_beta: int = 4, ps_kwargs: Optional[Dict] = None,
                 run_kwargs: Optional[Dict] = None, outdir: str = ".",
                 seed: int = 0, plot_result: bool = True) -> Dict:
    """Full (N × β × replicas) pipeline (:851-961).

    Returns {'N_values', 'f_fit', 'f_err', 'g_fit', 'g_err',
    'C0', 'C1', 'C2', 'per_N'}; also saves f_fit.png / g_fit.png."""
    beta_values = np.asarray(beta_values, dtype=float)
    list_N_part = np.asarray(list_N_part, dtype=float)
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)

    base = dict(DOUBLE_SWEEP_PS_KWARGS, **(ps_kwargs or {}))
    rk = dict(T=10, obs_dt=0.1, record_fft=True, record_var=True)
    rk.update(run_kwargs or {})

    from hydrolim_tpu.sweeps.beta_sweep import make_exp_gradient

    f_fit, f_err, g_fit, g_err, per_N = [], [], [], [], []
    for n_idx, N_part in enumerate(list_N_part):
        pk = dict(base, N=int(N_part))
        grad = make_exp_gradient(L=int(pk["L"]), N=int(N_part),
                                 frac_plus=0.75,
                                 decay_length=DOUBLE_SWEEP_DECAY_LENGTH,
                                 anchor_positions=None)
        save = sweep_over_betas(
            beta_values, n_runs_per_beta=n_runs_per_beta, run=True,
            ps_kwargs=pk, run_kwargs=rk,
            init_kwargs=dict(rho0_plus=grad[0], rho0_minus=grad[1]),
            npz_path=str(out / f"beta_sweep_N{int(N_part)}.npz"),
            outdir=str(out), seed=seed + 10_000 * n_idx, do_fit=False,
            plot_result=False)
        rho_bar = float(N_part) / float(pk["L"])
        K = int(pk["site_capacity"])
        f_v, g_v, f_e, g_e = fit_blocking_fg(
            beta_values, save["block_means"], save["block_ses"], rho_bar, K)
        f_fit.append(f_v)
        f_err.append(f_e)
        g_fit.append(g_v)
        g_err.append(g_e)
        per_N.append({"N": float(N_part), "save": {
            k: save[k] for k in ("means", "ses", "D_means", "D_ses",
                                 "block_means", "block_ses", "m_means")}})

    x_vals = list_N_part / float(base["L"])
    f_vals = np.asarray(f_fit)
    f_errs = np.where(np.asarray(f_err) > 0, f_err, 1e-3)
    g_vals = np.asarray(g_fit)
    g_errs = np.where(np.asarray(g_err) > 0, g_err, 1e-3)

    (C0, C1), pcov_f = curve_fit(f_model, x_vals, f_vals, sigma=f_errs,
                                 absolute_sigma=True)
    (C2,), pcov_g = curve_fit(g_model, x_vals, g_vals, sigma=g_errs,
                              absolute_sigma=True)
    C0_err, C1_err = np.sqrt(np.diag(pcov_f))
    C2_err = float(np.sqrt(pcov_g[0, 0]))

    if plot_result:
        _plot_fg(out, x_vals, f_vals, f_errs, g_vals, g_errs,
                 float(C0), float(C1), float(C2))

    return {"N_values": list_N_part, "f_fit": f_vals, "f_err": np.asarray(f_err),
            "g_fit": g_vals, "g_err": np.asarray(g_err),
            "C0": float(C0), "C1": float(C1), "C2": float(C2),
            "C0_err": float(C0_err), "C1_err": float(C1_err),
            "C2_err": C2_err, "per_N": per_N}
