"""Microscopic (β × σ) phase diagram on the K-slot exclusion engine — the
particle-side twin of the macroscopic ``run_pde_phase_diagram.py``.

Beyond-reference science, second half: the reference only ever sweeps β at
one kernel width (PARTICLE_solver_BIOLOGY_EXCLUSION_sweep_beta.py:828-1028)
or σ at a couple of β (…sweep_kernel_sigma.py); this driver maps the full
(interaction strength β × interaction range σ) plane with the MICROSCOPIC
exclusion model — 32 β × 2 seeds = 64 replicas per σ program × 16 σ = 1024
replicas at reference per-replica scale (L=1000, K=3, ~5000 Δt steps) — and
overlays its phase boundary β_c(σ) on the hydrodynamic-limit (PDE) one.
The two boundaries agreeing within finite-N broadening is the
hydrodynamic-limit claim itself, now read off a whole phase PLANE instead
of the single-β cross-engine figure (run_cross_engine_validation.py).

Engine: each σ is one vmapped `run_lattice_gas_k` program over the
64-replica batch (σ is baked into the smoothing operator); σ=0 (the
global-magnetization row, mean-field limit) runs without the smoothing
operator entirely.

Physics read-outs per (β, σ), mirroring the PDE driver exactly:
- order parameter |⟨m_global⟩_t| (abs of the late-window time mean,
  t ≥ 0.6 T — the same convention as the PDE driver, so the overlay
  compares like with like; a replica that breaks into sign-wandering
  domains time-averages toward 0, which is exactly the "no global
  order" read-out): the Curie–Weiss flip law gives m = tanh(β m) in
  the mean-field row, so β_c = 1 there; finite interaction range
  shifts/broadens it,
- band contrast ⟨std_x(ρ_total)/mean_x(ρ_total)⟩ over the same window —
  spatial structure (narrow kernels in the ordered phase; note the
  microscopic field keeps shot noise ~ sqrt(L/N) even when uniform,
  unlike the noiseless PDE).

Usage:
  python experiments/run_particle_phase_diagram.py [--small]
  python experiments/run_particle_phase_diagram.py --replot  # from JSON
"""
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import time

import numpy as np


def run_grid(beta_values, sigma_values, n_seeds, *, L, N, K, T, obs_dt,
             rate_diffusion, rate_active, seed=0):
    """One batched exclusion program per σ; σ <= 0 means global m.

    Returns (n_sigma, n_beta) grids of the late-window order parameter and
    band contrast.  Rates are the reference sweep's unscaled lattice rates
    (beta_sweep.DEFAULT_PS_KWARGS: rate_diffusion=0.02, rate_active=5,
    scale_rates=False), but periodic + bidirectional — the phase-plane
    model whose σ → ∞ row is the exactly-solvable Curie–Weiss limit."""
    import jax

    from hydrolim_tpu.core.config import ParticleConfig, auto_dt
    from hydrolim_tpu.particles.lattice_gas_k import run_lattice_gas_k
    from hydrolim_tpu.sweeps.ensemble import broadcast_params

    nb, ns = len(beta_values), n_seeds
    beta_max = float(np.max(beta_values))
    m_grid = np.zeros((len(sigma_values), nb))
    band_grid = np.zeros_like(m_grid)
    for si, sigma in enumerate(sigma_values):
        config = ParticleConfig(
            L=L, xlim=1.0, init="fixed", N=N, scale_rates=False,
            local_kernel_sigma=float(sigma), periodic=True,
            site_capacity=K, active_model="bidirectional")
        params = broadcast_params(config, beta=beta_values,
                                  rate_diffusion=rate_diffusion,
                                  rate_active=rate_active, n_runs=ns)
        dt = auto_dt(config, params, beta_max=beta_max)
        nsteps = int(round(T / dt))
        key = jax.random.fold_in(jax.random.PRNGKey(seed), si)
        t0 = time.perf_counter()
        frames, _slots = run_lattice_gas_k(
            config, params, key, T=T, obs_dt=obs_dt, dt=dt,
            record_fft=False)
        m_ts = np.asarray(frames.m_global)       # (B, M)
        rho_ts = np.asarray(frames.total)        # (B, M, L)
        wall = time.perf_counter() - t0
        M = m_ts.shape[1]
        late = np.arange(M) * obs_dt >= 0.6 * T
        m_abs = np.abs(m_ts[:, late].mean(axis=1))
        band = (rho_ts[:, late].std(axis=2)
                / np.maximum(rho_ts[:, late].mean(axis=2), 1e-12)).mean(axis=1)
        m_grid[si] = m_abs.reshape(nb, ns).mean(axis=1)
        band_grid[si] = band.reshape(nb, ns).mean(axis=1)
        print(f"# sigma={sigma:.4g}: {nb * ns} replicas x {nsteps} steps "
              f"(dt={dt:.2e}) in {wall:.1f}s",
              flush=True)
    return dict(beta=list(map(float, beta_values)),
                sigma=list(map(float, sigma_values)), n_seeds=n_seeds,
                L=L, N=N, K=K, T=T, obs_dt=obs_dt,
                rate_diffusion=rate_diffusion, rate_active=rate_active,
                m=m_grid.tolist(), band=band_grid.tolist(),
                replicas=len(sigma_values) * nb * n_seeds)


def crossing_curve(beta, m_rows, level=0.5):
    """β at which each σ row first crosses ``level`` (linear interp);
    NaN where the row never orders."""
    beta = np.asarray(beta)
    out = []
    for row in np.asarray(m_rows):
        above = row > level
        if not above.any() or above[0]:
            out.append(np.nan)
            continue
        j = int(np.argmax(above))
        b0, b1, m0, m1 = beta[j - 1], beta[j], row[j - 1], row[j]
        out.append(b0 + (b1 - b0) * (level - m0) / max(m1 - m0, 1e-12))
    return np.asarray(out)


def plot_grid(data, outdir=".", pde_json=None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    beta = np.asarray(data["beta"])
    sigma = np.asarray(data["sigma"])
    pde = None
    if pde_json:
        with open(pde_json) as f:
            pde = json.load(f)
    # the global-m row (σ <= 0) is the σ → ∞ mean-field limit: plot it one
    # log-decade above the widest finite σ OF EITHER dataset, so the PDE's
    # quasi-global sentinel (σ ~ 1e5) maps to the same rung and neither
    # mean-field point lands inside the other's finite-σ band
    def _finite(vals):
        v = np.asarray(vals, float)
        return v[(v > 0) & (v < 100)]

    finite = _finite(sigma)
    if pde is not None:
        finite = np.concatenate([finite, _finite(pde["sigma"])])
    top = (finite.max() * 10.0) if finite.size else 1.0
    sig_plot = sigma.copy()
    sig_plot[sig_plot <= 0] = top

    n_panels = 3 if pde_json else 2
    fig, axes = plt.subplots(1, n_panels, figsize=(5.5 * n_panels, 4.2))
    for ax, key, title in (
            (axes[0], "m", r"order parameter  $|\langle m\rangle_t|$"),
            (axes[1], "band",
             r"band contrast  std$_x\rho\,/\,$mean$_x\rho$")):
        grid = np.asarray(data[key])
        pm = ax.pcolormesh(beta, sig_plot, grid, shading="nearest",
                           cmap="viridis")
        ax.set_yscale("log")
        ax.axvline(1.0, color="w", ls="--", lw=1)
        ax.set_xlabel(r"$\beta$")
        ax.set_ylabel(r"kernel width $\sigma$" if ax is axes[0] else "")
        ax.set_title(title)
        fig.colorbar(pm, ax=ax)
    if pde is not None:
        ax = axes[2]
        pc = crossing_curve(data["beta"], data["m"])
        ax.plot(pc, sig_plot, "o-", label=f"particles (N={data['N']}, "
                f"K={data['K']})")
        psig = np.asarray(pde["sigma"], float)
        psig[psig > 100] = top     # PDE quasi-global sentinel row
        ax.plot(crossing_curve(pde["beta"], pde["m"]), psig, "s--",
                label="PDE (hydrodynamic limit)")
        ax.axvline(1.0, color="k", ls=":", lw=1,
                   label=r"mean-field $\beta_c{=}1$")
        ax.set_yscale("log")
        ax.set_xlabel(r"$\beta$")
        ax.set_title(r"phase boundary $\beta_c(\sigma)$: micro vs macro")
        ax.legend(fontsize=8)
        ax.set_xlim(beta.min(), beta.max())
    fig.suptitle(
        f"Particle (β × σ) phase diagram — {data['replicas']} replicas, "
        f"L={data['L']}, N={data['N']}, K={data['K']}, T={data['T']} "
        f"(window [{0.6 * data['T']:.0f},{data['T']:.0f}])", fontsize=10)
    fig.tight_layout()
    path = _os.path.join(outdir, "particle_phase_diagram.png")
    fig.savefig(path, dpi=150)
    plt.close(fig)
    print(f"# wrote {path}")


def check_physics(data):
    """The diagram's own sanity pins (printed + asserted)."""
    m = np.asarray(data["m"])
    beta = np.asarray(data["beta"])
    N_eff = data["N"] * data["n_seeds"]
    # global-m row (last) = Curie-Weiss: ordered at beta >> 1, disordered
    # (|m| ~ 1/sqrt(N)) at beta ~ 0
    top = m[-1]
    lo = top[beta <= 0.3].mean()
    hi = top[beta >= 2.5].mean()
    print(f"# global-m row: |<m>_t|(beta<=0.3)={lo:.3f}, (beta>=2.5)={hi:.3f} "
          f"(shot floor ~{1.0 / np.sqrt(N_eff):.3f})")
    assert hi > 0.7, f"ordered phase missing in the mean-field row ({hi:.3f})"
    assert lo < max(0.25, 4.0 / np.sqrt(N_eff)), \
        f"disordered phase missing in the mean-field row ({lo:.3f})"
    cross = crossing_curve(beta, m[None, -1])[0]
    print(f"# global-m row 0.5-crossing at beta={cross:.2f} "
          f"(mean-field beta_c=1)")
    assert 0.8 <= cross <= 1.8, cross


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="CPU smoke: 6 beta x 3 sigma x 1 seed, L=128")
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--pde-json", default=None,
                    help="pde_phase_diagram.json for the boundary overlay "
                         "(default: docs/figures/phase_diagram/ copy if "
                         "present)")
    ap.add_argument("--replot", action="store_true",
                    help="redraw the figure from the saved JSON")
    args = ap.parse_args()
    _os.makedirs(args.outdir, exist_ok=True)
    jpath = _os.path.join(args.outdir, "particle_phase_diagram.json")
    pde_json = args.pde_json
    if pde_json is None:
        cand = _os.path.join(_os.path.dirname(_os.path.abspath(__file__)),
                             _os.pardir, "docs", "figures", "phase_diagram",
                             "pde_phase_diagram.json")
        pde_json = cand if _os.path.exists(cand) else None
    if args.replot:
        with open(jpath) as f:
            data = json.load(f)
        plot_grid(data, args.outdir, pde_json=pde_json)
        return
    if args.small:
        data = run_grid(np.linspace(0, 3, 6), [0.02, 0.1, 0.0], 1,
                        L=128, N=96, K=3, T=6.0, obs_dt=0.5,
                        rate_diffusion=0.02, rate_active=5.0)
    else:
        # σ grid matches run_pde_phase_diagram exactly (so the boundary
        # overlay shares rows); σ=0 is the global-m mean-field row (the
        # particle analog of the PDE's quasi-global sentinel)
        sigmas = list(np.geomspace(0.002, 2.0, 15)) + [0.0]
        data = run_grid(np.linspace(0, 3, 32), sigmas, 2,
                        L=1000, N=1500, K=3, T=20.0, obs_dt=0.25,
                        rate_diffusion=0.02, rate_active=5.0)
    with open(jpath, "w") as f:
        json.dump(data, f)
    plot_grid(data, args.outdir, pde_json=pde_json)
    check_physics(data)


if __name__ == "__main__":
    main()
