"""Dense (β × σ) PDE phase diagram through the batched PDE ensemble.

Beyond-reference science: the reference only ever sweeps β at fixed kernel
width (IMEX_PDE_solver_run_sweep.py:26-40) or σ at a couple of β
(IMEX_PDE_solver_run_sweep_magn*.py).  This driver maps the full
(interaction strength β × interaction range σ) plane — 32 β × 16 σ × 2
seeds = 1024 replicas at reference per-replica scale (L=1000, dt=5e-4) —
the batch regime one device holds, where the vmapped solve amortizes its
per-step launch overhead over the whole σ row.

Physics read-outs per (β, σ):
- order parameter |⟨m⟩_t| (abs of the late-window time mean) — the flocking
  transition: m = tanh(β m) gives β_c = 1 in the mean-field (σ → ∞)
  limit; finite interaction range shifts/broadens the transition,
- band contrast std_x(ρ)/mean_x(ρ) at final time — spatial structure
  (traveling bands form for NARROW kernels in the ordered phase; the
  quasi-global kernel stays spatially uniform).

Each σ is one vmapped program of B = 32 β × n_seeds replicas (σ is
baked into the smoothing operator, so it cannot vary inside a program).

Usage:
  python experiments/run_pde_phase_diagram.py [--small]
  python experiments/run_pde_phase_diagram.py --replot   # from saved JSON
"""
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import time

import numpy as np


def run_grid(beta_values, sigma_values, n_seeds, *, L, T, dt, gamma, lam,
             n_tracers, seed=0):
    """One batched program per σ; returns dict of (n_sigma, n_beta) grids."""
    from hydrolim_tpu.core.config import PDEConfig
    from hydrolim_tpu.sweeps.pde_sweeps import run_pde_ensemble

    nb, ns = len(beta_values), n_seeds
    nsteps = int(round(T / dt))
    t = np.linspace(0.0, T, nsteps + 1)
    late = t >= 0.6 * T
    m_grid = np.zeros((len(sigma_values), nb))
    band_grid = np.zeros_like(m_grid)
    v_grid = np.zeros_like(m_grid)
    for si, sigma in enumerate(sigma_values):
        config = PDEConfig(L=L, T=T, dt=dt, bc="periodic",
                           active_model="bidirectional",
                           gaussian_kernel=True, kernel_sigma=float(sigma),
                           snapshot_interval=nsteps, fft_kmax=8,
                           n_tracers=n_tracers)
        t0 = time.perf_counter()
        res, _ = run_pde_ensemble(config, beta_values, gamma=gamma, lam=lam,
                                  n_runs=ns, seed=seed + si,
                                  n_tracers=n_tracers,
                                  fetch_snapshots=False)
        wall = time.perf_counter() - t0
        m_ts = np.asarray(res.records.m_mean)[:, :nsteps + 1]
        v_ts = np.asarray(res.records.v_eff)[:, :nsteps + 1]
        rho = np.asarray(res.rho_p) + np.asarray(res.rho_m)   # (B, L) final
        m_abs = np.abs(np.nanmean(m_ts[:, late], axis=1))
        band = rho[:, :L].std(axis=1) / np.maximum(
            rho[:, :L].mean(axis=1), 1e-12)
        v_abs = np.abs(np.nanmean(np.where(np.isfinite(v_ts[:, late]),
                                           v_ts[:, late], np.nan), axis=1))
        m_grid[si] = m_abs.reshape(nb, ns).mean(axis=1)
        band_grid[si] = band.reshape(nb, ns).mean(axis=1)
        v_grid[si] = v_abs.reshape(nb, ns).mean(axis=1)
        print(f"# sigma={sigma:.4g}: {nb * ns} replicas x {nsteps} steps "
              f"in {wall:.1f}s", flush=True)
    return dict(beta=list(map(float, beta_values)),
                sigma=list(map(float, sigma_values)), n_seeds=n_seeds,
                L=L, T=T, dt=dt, gamma=gamma, lam=lam,
                m=m_grid.tolist(), band=band_grid.tolist(),
                v=v_grid.tolist(),
                replicas=len(sigma_values) * nb * n_seeds)


def plot_grid(data, outdir="."):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    beta = np.asarray(data["beta"])
    sigma = np.asarray(data["sigma"])
    fig, axes = plt.subplots(1, 2, figsize=(11, 4.2), sharey=True)
    for ax, key, title in ((axes[0], "m", r"order parameter  $|\langle m\rangle_t|$"),
                           (axes[1], "band",
                            r"band contrast  std$_x\rho\,/\,$mean$_x\rho$")):
        grid = np.asarray(data[key])
        pm = ax.pcolormesh(beta, sigma, grid, shading="nearest",
                           cmap="viridis")
        ax.set_yscale("log")
        ax.axvline(1.0, color="w", ls="--", lw=1,
                   label=r"mean-field $\beta_c{=}1$" if key == "m" else None)
        ax.set_xlabel(r"$\beta$")
        ax.set_title(title)
        fig.colorbar(pm, ax=ax)
    axes[0].set_ylabel(r"kernel width $\sigma$")
    axes[0].legend(loc="upper left", fontsize=8)
    fig.suptitle(
        f"PDE (β × σ) phase diagram — {data['replicas']} replicas, "
        f"L={data['L']}, T={data['T']} (window [{0.6 * data['T']:.0f},"
        f"{data['T']:.0f}])", fontsize=10)
    fig.tight_layout()
    path = _os.path.join(outdir, "pde_phase_diagram.png")
    fig.savefig(path, dpi=150)
    plt.close(fig)
    print(f"# wrote {path}")


def check_physics(data):
    """The diagram's own sanity pins (printed + asserted)."""
    m = np.asarray(data["m"])
    beta = np.asarray(data["beta"])
    # widest kernel row ≈ mean-field: ordered at beta >> 1, disordered
    # at beta ≈ 0
    top = m[-1]
    lo = top[beta <= 0.3].mean()
    hi = top[beta >= 2.5].mean()
    print(f"# widest-sigma row: |<m>_t|(beta<=0.3)={lo:.3f}, "
          f"(beta>=2.5)={hi:.3f}")
    assert hi > 0.7, f"ordered phase missing at wide sigma ({hi:.3f})"
    assert lo < 0.25, f"disordered phase missing at wide sigma ({lo:.3f})"
    # transition location: first beta where the widest row crosses 1/2
    # should bracket the mean-field beta_c = 1
    cross = beta[np.argmax(top > 0.5)]
    print(f"# widest-sigma 0.5-crossing at beta={cross:.2f} "
          f"(mean-field beta_c=1)")
    assert 0.8 <= cross <= 1.6, cross


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="CPU smoke: 6 beta x 3 sigma x 1 seed, L=128")
    ap.add_argument("--outdir", default=".")
    ap.add_argument("--replot", action="store_true",
                    help="redraw the figure from the saved JSON")
    args = ap.parse_args()
    _os.makedirs(args.outdir, exist_ok=True)
    jpath = _os.path.join(args.outdir, "pde_phase_diagram.json")
    if args.replot:
        with open(jpath) as f:
            data = json.load(f)
        plot_grid(data, args.outdir)
        return
    if args.small:
        data = run_grid(np.linspace(0, 3, 6), [0.02, 0.2, 9e4], 1,
                        L=128, T=0.5, dt=1e-3, gamma=0.2, lam=0.6,
                        n_tracers=16)
    else:
        # sigma from ~2 grid sites (narrow rolls) through matmul smoothing
        # to the reference's quasi-global sentinel (exact global mean)
        sigmas = list(np.geomspace(0.002, 2.0, 15)) + [1e5 - 10]
        data = run_grid(np.linspace(0, 3, 32), sigmas, 2,
                        L=1000, T=10.0, dt=5e-4, gamma=0.2, lam=0.6,
                        n_tracers=64)
    with open(jpath, "w") as f:
        json.dump(data, f)
    plot_grid(data, args.outdir)
    if not args.small:
        check_physics(data)


if __name__ == "__main__":
    main()
