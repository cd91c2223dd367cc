"""(N, β) double sweep — calibration of the exclusion constants C0/C1/C2.

Reference driver: PARTICLE_solver_BIOLOGY_EXCLUSION_double_sweep.py:851-961
(N = linspace(50,950,19) × 11 β × 4 runs, T=10; per-N (f,g) blocking fits,
then meta-fits f(x)=C0−C1·x, g(x)=C2/x^{3/2}).

Usage: python experiments/run_particle_double_sweep.py [--small]
"""
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np

from hydrolim_tpu.sweeps.double_sweep import double_sweep_fused


def main(small: bool = False, outdir: str = "double_sweep_out",
         engine: str = "particle", n_devices: int = None,
         ckpt_dir: str = None):
    if small:
        betas = np.linspace(0, 3, 4)
        Ns = np.linspace(40, 160, 4)
        kw = dict(ps_kwargs=dict(L=200), run_kwargs=dict(T=3.0, obs_dt=0.2),
                  n_runs_per_beta=2)
    else:
        betas = np.linspace(0, 3, 11)
        Ns = np.linspace(50, 950, 19)
        kw = dict(n_runs_per_beta=4, run_kwargs=dict(T=10, obs_dt=0.1))
    # fused: the whole (N x beta x runs) grid is one compiled program
    res = double_sweep_fused(betas, Ns, outdir=outdir, engine=engine,
                             n_devices=n_devices, ckpt_dir=ckpt_dir, **kw)
    print("f(rho):", np.round(res["f_fit"], 3))
    print("g(rho):", np.round(res["g_fit"], 3))
    print(f"C0={res['C0']:.6f}  C1={res['C1']:.6f}  C2={res['C2']:.6f}")
    print("(frozen reference constants: C0=1.25529 C1=0.60229 C2=0.15327)")
    return res


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--small", action="store_true")
    p.add_argument("--outdir", default="double_sweep_out")
    p.add_argument("--engine", default="particle",
                   choices=["particle", "lattice_gas"])
    p.add_argument("--n-devices", type=int, default=None)
    p.add_argument("--ckpt-dir", default=None,
                   help="chunk-ledger checkpoint/resume dir")
    a = p.parse_args()
    main(a.small, a.outdir, engine=a.engine, n_devices=a.n_devices,
         ckpt_dir=a.ckpt_dir)
