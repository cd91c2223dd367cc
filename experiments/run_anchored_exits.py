"""Anchored binding/exit β-sweep — the reference's commented-out anchored
configuration run end-to-end.

Reference: PARTICLE_solver_BIOLOGY_EXCLUSION_sweep_beta.py:845-856 (anchors
(0.25, 0.60, 0.80), k_on=10, k_off=5, k_exit=5, minus_anchor,
immobilize_when_anchored, K=1, L=1000, N=500) with the exits-per-anchor
figure + A·ρ̄·Sₐ·(1−m_β)/2 fit of :660-825 / :975-982 (``plot_outs``) that
the reference leaves commented out.

Exercises the bind → immobilize → exit event channels at sweep scale: minus
particles binding at anchor sites (k_on), unbinding (k_off), and absorbing
exits of bound anchored particles (k_exit), with N shrinking over the run.

NB: the reference's commented-out config says ``site_capacity=1``, but its
own bind-eligibility gate ``occ_total[pos] < K`` counts the particle itself
(PARTICLE_solver_CLASS.py:342-344), so at K=1 binding can never fire — run
at K=3 (default here, matching the flagship single-run capacity) for the
channels to be live.  ``--K 1`` reproduces the reference's zero-exit
behavior exactly.

Usage: python experiments/run_anchored_exits.py [--outdir DIR] [--small] [--K 3]
"""
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np

from hydrolim_tpu.sweeps.beta_sweep import make_exp_gradient, sweep_over_betas
from hydrolim_tpu.viz.exit_plots import plot_outs

ANCHORS = (0.25, 0.60, 0.80)


def main(outdir: str = "anchored_exits_out", small: bool = False,
         seed: int = 11, K: int = 3, engine: str = "lattice_gas"):
    L, N = (200, 100) if small else (1000, 500)
    T, obs_dt = (4.0, 0.2) if small else (20.0, 0.1)
    n_beta, n_runs = (3, 2) if small else (11, 3)
    beta_values = np.linspace(0.0, 3.0, n_beta)

    ps_kwargs = dict(
        L=L, xlim=1, rate_diffusion=0.02, rate_active=5, N=N,
        init="poisson", scale_rates=False, local_kernel_sigma=0.005,
        minus_anchor=True, periodic=False, immobilize_when_anchored=True,
        anchor_radius=0.003, anchor_positions=list(ANCHORS),
        site_capacity=K, crowding_suppresses_rates=False,
        k_on=10, k_off=5, k_exit=5,
    )
    # one gradient factory call covers both profiles: decay_length only
    # shapes the + profile, the − profile is flat + anchor peaks
    # (sweeps/beta_sweep.py:58-63), so a second call with a different decay
    # would return an identical minus profile
    grad_p = make_exp_gradient(L=L, N=N, frac_plus=0.75, decay_length=0.35,
                               anchor_positions=ANCHORS,
                               anchor_peak_width=0.01, anchor_peak_mass=0.03)
    init_kwargs = dict(rho0_plus=grad_p[0], rho0_minus=grad_p[1])
    run_kwargs = dict(T=T, obs_dt=obs_dt)

    save = sweep_over_betas(
        beta_values, n_runs_per_beta=n_runs, ps_kwargs=ps_kwargs,
        init_kwargs=init_kwargs, run_kwargs=run_kwargs,
        npz_path=f"{outdir}/anchored_exits_sweep.npz", outdir=outdir,
        seed=seed, keep_outs=True, do_fit=False, plot_result=False,
        engine=engine)

    outs_flat = save["outs"]
    total_mean, total_std, region_mean, region_std = plot_outs(
        beta_values, n_runs, ps_kwargs, run_kwargs, outs_flat,
        do_theory_fit=True, plot_theory=True, outdir=outdir)
    print("total exits per beta:", np.round(total_mean, 2))
    print("per-anchor exits at beta=0:", np.round(region_mean[0], 2))
    print(f"figure: {outdir}/exits_vs_beta.png")
    return total_mean, region_mean


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default="anchored_exits_out")
    p.add_argument("--small", action="store_true")
    p.add_argument("--K", type=int, default=3)
    p.add_argument("--engine", default="lattice_gas",
                   choices=["particle", "lattice_gas"])
    a = p.parse_args()
    main(a.outdir, a.small, K=a.K, engine=a.engine)
