"""Measure in-flight checkpointing overhead at the flagship sweep scale:
the same run with and without ``ckpt_dir=``,
warm-compiled, fresh checkpoint directory for the timed pass so every
chunk's atomic npz write is included.

Two surfaces, matching docs/OPERATIONS.md's preemption-safety table:
- the flagship particle β-sweep (reference scale: 11 β × 3 runs, L=1000,
  N=500, T=20 — PARTICLE_solver_BIOLOGY_EXCLUSION_sweep_beta.py:1030-1034)
  on the slot engine, and
- the PDE β-ensemble (reference sweep scale, IMEX_PDE_solver_run_sweep.py)
  through ``run_pde_ensemble(ckpt_dir=)``.

The checkpointed path runs the scan in chunks with a host npz write after
each; the chunk loop is pipelined (the next chunk is dispatched before the
previous chunk's write completes), so the expected overhead is the
serialized fraction of (fetch + tmp-write + rename) that does not hide
behind device execution.

Prints one JSON line per surface; run on the GPU:
    python experiments/measure_ckpt_overhead.py [--small]
"""
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import json
import shutil
import tempfile
import time

import numpy as np


def _timed(fn, warm_reps=1):
    """Warm once (compiles), then time a single full pass."""
    for _ in range(warm_reps):
        fn(warm=True)
    t0 = time.perf_counter()
    fn(warm=False)
    return time.perf_counter() - t0


def measure_particle(small):
    from hydrolim_tpu.sweeps.beta_sweep import sweep_over_betas

    beta = np.linspace(0, 3, 5 if small else 11)
    over = dict(L=200, N=100) if small else {}
    rk = dict(T=4.0, obs_dt=0.2) if small else None
    n_runs = 2 if small else 3
    base = tempfile.mkdtemp(prefix="ckpt_overhead_")

    def run(ckpt, warm):
        outdir = _os.path.join(base, "out")
        shutil.rmtree(outdir, ignore_errors=True)
        ck = None
        if ckpt:
            ck = _os.path.join(base, "warm_ck" if warm else "timed_ck")
            shutil.rmtree(ck, ignore_errors=True)
        sweep_over_betas(beta, n_runs_per_beta=n_runs, ps_kwargs=over or None,
                         run_kwargs=rk, engine="lattice_gas",
                         npz_path=_os.path.join(outdir, "r.npz"),
                         outdir=outdir, seed=0, ckpt_dir=ck)

    straight = _timed(lambda warm: run(False, warm))
    ckpt = _timed(lambda warm: run(True, warm))
    shutil.rmtree(base, ignore_errors=True)
    return dict(surface="particle_beta_sweep_lattice_gas",
                grid=f"{len(beta)}beta x {n_runs}runs",
                straight_s=round(straight, 3), ckpt_s=round(ckpt, 3),
                overhead_pct=round(100.0 * (ckpt - straight) / straight, 2))


def measure_pde(small):
    from hydrolim_tpu.core.config import PDEConfig
    from hydrolim_tpu.sweeps.pde_sweeps import run_pde_ensemble

    if small:
        config = PDEConfig(L=128, T=0.5, dt=1e-3, bc="periodic",
                           gaussian_kernel=True, kernel_sigma=1e5 - 10,
                           snapshot_interval=100, fft_kmax=8, n_tracers=16)
        beta, n_runs = np.linspace(0, 3, 4), 1
    else:
        config = PDEConfig(L=1000, T=10.0, dt=5e-4, bc="periodic",
                           gaussian_kernel=True, kernel_sigma=1e5 - 10,
                           snapshot_interval=1000, fft_kmax=8,
                           n_tracers=1000, tracer_window_time=0.25)
        beta, n_runs = np.linspace(0, 3, 11), 3
    base = tempfile.mkdtemp(prefix="ckpt_overhead_pde_")

    def run(ckpt, warm):
        ck = None
        if ckpt:
            ck = _os.path.join(base, "warm_ck" if warm else "timed_ck")
            shutil.rmtree(ck, ignore_errors=True)
        run_pde_ensemble(config, beta, gamma=0.2, lam=0.6, n_runs=n_runs,
                         seed=0, n_tracers=config.n_tracers, ckpt_dir=ck)

    straight = _timed(lambda warm: run(False, warm))
    ckpt = _timed(lambda warm: run(True, warm))
    shutil.rmtree(base, ignore_errors=True)
    return dict(surface="pde_beta_ensemble",
                grid=f"{len(beta)}beta x {n_runs}runs",
                straight_s=round(straight, 3), ckpt_s=round(ckpt, 3),
                overhead_pct=round(100.0 * (ckpt - straight) / straight, 2))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true", help="CPU smoke scale")
    args = ap.parse_args()
    for row in (measure_particle(args.small), measure_pde(args.small)):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
