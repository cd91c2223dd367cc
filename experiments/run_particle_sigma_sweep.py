"""(σ, β) double sweep over interaction-kernel widths.

Reference driver: PARTICLE_solver_BIOLOGY_EXCLUSION_sweep_beta_2.py
:1277-1293 (σ ∈ {1e-4 … 0.3, 0} × 11 β × 5 runs).

Usage: python experiments/run_particle_sigma_sweep.py [--small]
"""
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np

from hydrolim_tpu.sweeps.sigma_sweep import (
    REFERENCE_SIGMA_VALUES,
    plot_D_eff_all_sigmas,
    plot_D_eff_vs_sigma_all_beta,
    plot_v_eff_all_sigmas,
    plot_v_eff_vs_sigma_all_beta,
    sweep_over_sigmas,
)


def main(small: bool = False, outdir: str = "sigma_sweep_out",
         run: bool = True, engine: str = "particle",
         n_devices: int = None, ckpt_dir: str = None):
    if small:
        sigmas = [0.005, 0.05, 0]
        betas = np.linspace(0, 3, 4)
        ps = dict(L=200, N=100)
        rk = dict(T=4.0, obs_dt=0.2)
        n_runs = 2
    else:
        sigmas = REFERENCE_SIGMA_VALUES
        betas = np.linspace(0, 3, 11)
        ps, rk, n_runs = None, None, 5
    results = sweep_over_sigmas(sigmas, betas, n_runs_per_beta=n_runs,
                                run=run, ps_kwargs=ps, run_kwargs=rk,
                                outdir=outdir, engine=engine,
                                n_devices=n_devices, ckpt_dir=ckpt_dir)
    plot_v_eff_all_sigmas(results, outdir)
    plot_D_eff_all_sigmas(results, outdir)
    plot_v_eff_vs_sigma_all_beta(results, outdir)
    plot_D_eff_vs_sigma_all_beta(results, outdir)
    for s in sorted(results):
        print(f"sigma={s:g}: v(beta) = {np.round(results[s]['v_mean'], 4)}")
    return results


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--small", action="store_true")
    p.add_argument("--outdir", default="sigma_sweep_out")
    p.add_argument("--replot", action="store_true")
    p.add_argument("--engine", default="particle",
                   choices=["particle", "lattice_gas"])
    p.add_argument("--n-devices", type=int, default=None)
    p.add_argument("--ckpt-dir", default=None,
                   help="mid-run checkpoint/resume dir (engine=lattice_gas)")
    a = p.parse_args()
    main(a.small, a.outdir, run=not a.replot, engine=a.engine,
         n_devices=a.n_devices, ckpt_dir=a.ckpt_dir)
