"""Particle β-sweep — the reference's flagship exclusion experiment.

Reference driver: PARTICLE_solver_BIOLOGY_EXCLUSION_sweep_beta.py:1030-1034
(β = linspace(0,3,11) × 3 runs at L=1000, N=500, T=20).  The whole
(β × replicas) grid runs as ONE vmapped program on device.

Usage: python experiments/run_particle_beta_sweep.py [--outdir DIR] [--small]
"""
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np

from hydrolim_tpu.sweeps.beta_sweep import sweep_over_betas


def main(outdir: str = "beta_sweep_out", small: bool = False,
         run: bool = True, engine: str = "particle", n_runs: int = None,
         n_devices: int = None, ckpt_dir: str = None):
    beta_values = np.linspace(0, 3, 5 if small else 11)
    over = dict(L=200, N=100) if small else {}
    rk = dict(T=4.0, obs_dt=0.2) if small else None
    save = sweep_over_betas(
        beta_values,
        n_runs_per_beta=n_runs or (2 if small else 3), run=run,
        ps_kwargs=over or None, run_kwargs=rk, engine=engine,
        npz_path=f"{outdir}/beta_sweep_results.npz", outdir=outdir, seed=0,
        n_devices=n_devices, ckpt_dir=ckpt_dir)
    print("v_eff(beta):", np.round(save["means"], 4))
    print("D_eff(beta):", np.round(save["D_means"], 4))
    print("p_block(beta):", np.round(save["block_means"], 4))
    print(f"fit (theta, tau): {save['popt']}")
    return save


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default="beta_sweep_out")
    p.add_argument("--small", action="store_true")
    p.add_argument("--replot", action="store_true",
                   help="reload the npz checkpoint instead of re-running")
    p.add_argument("--engine", default="particle",
                   choices=["particle", "lattice_gas"])
    p.add_argument("--n-runs", type=int, default=None)
    p.add_argument("--n-devices", type=int, default=None,
                   help="shard the (beta x runs) batch over this many "
                        "devices ('sweep'-axis DP; see parallel.mesh)")
    p.add_argument("--ckpt-dir", default=None,
                   help="mid-run checkpoint/resume dir (engine=lattice_gas)")
    a = p.parse_args()
    main(a.outdir, a.small, run=not a.replot, engine=a.engine,
         n_runs=a.n_runs, n_devices=a.n_devices, ckpt_dir=a.ckpt_dir)
