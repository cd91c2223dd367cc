"""PDE experiment drivers: single run, β sweep, kernel-σ sweeps.

Reference drivers: IMEX_PDE_solver_run.py, IMEX_PDE_solver_run_sweep.py,
IMEX_PDE_solver_run_sweep_magn{,2}.py.

Usage:
  python experiments/run_pde_experiments.py single [--small]
  python experiments/run_pde_experiments.py beta   [--small]
  python experiments/run_pde_experiments.py magn   [--small]
  python experiments/run_pde_experiments.py magn2  [--small]
"""
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np

from hydrolim_tpu.sweeps.pde_sweeps import (
    pde_beta_sweep,
    pde_kernel_sigma_sweep,
    pde_single_run,
)


def main(which: str, small: bool = False, outdir: str = "pde_out",
         n_devices: int = None,
         ckpt_dir: str = None):
    if which == "single":
        kw = dict(L=128, T=2.0, dt=1e-3) if small else {}
        if ckpt_dir is not None:
            kw["ckpt_dir"] = ckpt_dir
        out = pde_single_run(outdir=outdir, **kw)
        print("final m:", out["m_series"][-1])
        return out
    if which == "beta":
        if small:
            r = pde_beta_sweep(np.linspace(0, 3, 4), n_runs=2, T=6.0,
                               t_min=4.0, t_max=6.0, L=128, dt=1e-3,
                               n_tracers=200, outdir=outdir,
                               n_devices=n_devices, ckpt_dir=ckpt_dir)
        else:
            r = pde_beta_sweep(outdir=outdir, n_devices=n_devices,
                               ckpt_dir=ckpt_dir)
        print("v(beta):", np.round(r["v_mean"], 4))
        print("D(beta):", np.round(r["D_mean"], 4))
        return r
    if which in ("magn", "magn2"):
        kw = dict(L=128, dt=1e-3, n_tracers=100, T=2.0,
                  kernel_sigma_values=[0.005, 0.05, 1.0], n_runs=2) \
            if small else {}
        r = pde_kernel_sigma_sweep(variant=which, outdir=outdir,
                                   n_devices=n_devices, ckpt_dir=ckpt_dir,
                                   **kw)
        print("final |m| per sigma:",
              {s: float(np.mean(v[:, -1])) for s, v in r["m"].items()})
        return r
    raise SystemExit(f"unknown experiment {which!r}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("which", choices=["single", "beta", "magn", "magn2"])
    p.add_argument("--small", action="store_true")
    p.add_argument("--outdir", default="pde_out")
    p.add_argument("--n-devices", type=int, default=None,
                   help="shard the (beta x runs) batch over this many "
                        "devices ('sweep'-axis DP)")
    p.add_argument("--ckpt-dir", default=None,
                   help="mid-run checkpoint/resume dir (composes with "
                        "--n-devices)")
    a = p.parse_args()
    main(a.which, a.small, a.outdir,
         n_devices=a.n_devices, ckpt_dir=a.ckpt_dir)
