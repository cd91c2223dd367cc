"""Local-structure (pattern formation) β-sweep.

Reference driver: PARTICLE_solver_BIOLOGY_local_structure.py:671-753
(L=1000, N=900, T=40, periodic, 11 β × 3 runs) → structure observables +
the full figure inventory.

Usage: python experiments/run_particle_local_structure.py [--small]
"""
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np

from hydrolim_tpu.sweeps.local_structure import (
    load_structure_results,
    save_structure_results,
    sweep_betas_for_structures,
)
from hydrolim_tpu.viz.structure_plots import run_all_plots


def main(small: bool = False, outdir: str = "local_structure_out",
         run: bool = True, engine: str = "particle",
         n_devices: int = None, ckpt_dir: str = None):
    npz = f"{outdir}/beta_sweep_local_structure.npz"
    if small:
        betas = np.linspace(0, 3, 4)
        ps = dict(L=200, N=180, periodic=True)
        rk = dict(T=4.0, obs_dt=0.2)
        n_runs = 2
    else:
        betas = np.linspace(0, 3, 11)
        ps, rk, n_runs = None, None, 3
    if run:
        results = sweep_betas_for_structures(betas, n_runs, ps_kwargs=ps,
                                             run_kwargs=rk, keep_outs=True,
                                             engine=engine,
                                             n_devices=n_devices,
                                             ckpt_dir=ckpt_dir)
        import pathlib
        pathlib.Path(outdir).mkdir(parents=True, exist_ok=True)
        save_structure_results(results, npz)
    else:
        results = load_structure_results(npz)
    run_all_plots(results, outdir=outdir,
                  L=(ps or {}).get("L", 1000))
    for b in sorted(results):
        r = results[b]
        print(f"beta={b:.2f}: var={r['var_mean']:.4f} "
              f"lowk={r['low_k_power_mean']:.4f} k*={r['dominant_k_mode']}")
    return results


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--small", action="store_true")
    p.add_argument("--outdir", default="local_structure_out")
    p.add_argument("--replot", action="store_true")
    p.add_argument("--engine", default="particle",
                   choices=["particle", "lattice_gas"])
    p.add_argument("--n-devices", type=int, default=None)
    p.add_argument("--ckpt-dir", default=None,
                   help="mid-run checkpoint/resume dir (engine=lattice_gas)")
    a = p.parse_args()
    main(a.small, a.outdir, run=not a.replot, engine=a.engine,
         n_devices=a.n_devices, ckpt_dir=a.ckpt_dir)
