"""Local-structure β-sweep (pattern-formation analysis).

Mirrors `PARTICLE_solver_BIOLOGY_local_structure.py`:
``sweep_beta_structure_ensemble`` (:105-165),
``sweep_betas_for_structures`` (:167-193), npz persistence (:625-641) and the
reference's `__main__` configuration (:671-753).  The ensemble×β grid runs as
one vmapped program (hydrolim_tpu.sweeps.ensemble).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import numpy as np

from hydrolim_tpu.core.config import PARTICLE_ENGINES, check_engine
from hydrolim_tpu.observables.structure import extract_structure_observables_from_out
from hydrolim_tpu.sweeps.beta_sweep import (
    make_exp_gradient,
    run_sweep_grid,
)
from hydrolim_tpu.sweeps.ensemble import frames_to_out

# Reference local-structure configuration
# (PARTICLE_solver_BIOLOGY_local_structure.py:671-726): faster diffusion
# than the β-sweep (0.05), non-periodic, 'fixed' init at N=900, obs_dt=1.
# (The reference passes exp-gradient rho0± callables alongside
# init='fixed', but its _init_fixed ignores them — uniform sites, uniform
# spins, PARTICLE_solver_CLASS.py:141-158 — so they are dead kwargs; our
# init_fixed implements the same law.)
DEFAULT_STRUCTURE_PS_KWARGS: Dict = dict(
    L=1000, xlim=1, rate_diffusion=0.05, rate_active=5, flip_rate_fn=None,
    init="fixed", N=900, scale_rates=False, local_kernel_sigma=0.005,
    minus_anchor=True, periodic=False, immobilize_when_anchored=True,
    anchor_radius=0.003, anchor_positions=None, site_capacity=1,
    crowding_suppresses_rates=False, k_on=0, k_off=0, k_exit=0,
)
DEFAULT_STRUCTURE_RUN_KWARGS: Dict = dict(T=40, obs_dt=1.0, record_fft=True,
                                          record_var=True)


def sweep_beta_structure_ensemble(beta, n_runs: int, ps_kwargs: Dict,
                                  init_kwargs: Optional[Dict],
                                  run_kwargs: Dict,
                                  start_fraction: float = 0.5,
                                  k_max: Optional[int] = None,
                                  rng_seeds=None, seed: int = 0,
                                  keep_outs: bool = True) -> Dict:
    """One β, n replicas → ensemble-averaged structure observables
    (:105-165 return schema)."""
    if rng_seeds is not None:
        seed = int(np.asarray(rng_seeds).flat[0])
    config, res, _ = run_sweep_grid(np.asarray([beta]), n_runs, ps_kwargs,
                                    init_kwargs, run_kwargs, seed=seed)
    T, obs_dt = float(run_kwargs["T"]), float(run_kwargs["obs_dt"])
    results = []
    for r in range(n_runs):
        out = frames_to_out(res.frames, r, config, T, obs_dt,
                            final_state=res.final_state)
        obs = extract_structure_observables_from_out(
            out, start_fraction=start_fraction, k_max=k_max)
        results.append({**obs, "out": out if keep_outs else None})

    arr = lambda key: np.array([r[key] for r in results])
    se = lambda a: a.std(ddof=1) / np.sqrt(n_runs) if n_runs > 1 else 0.0
    fft_stack = np.stack([r["fft_mean"] for r in results], axis=0)
    return {
        "var_mean": arr("var_mean").mean(),
        "var_se": se(arr("var_mean")),
        "low_k_power_mean": arr("low_k_power").mean(),
        "low_k_power_se": se(arr("low_k_power")),
        "dominant_k_mode": int(np.round(arr("dominant_k").mean())),
        "m_local_var_mean": arr("m_local_var").mean(),
        "m_local_var_se": se(arr("m_local_var")),
        "fft_mean_mean": fft_stack.mean(axis=0),
        "fft_mean_se": (fft_stack.std(axis=0, ddof=1) / np.sqrt(n_runs)
                        if n_runs > 1 else np.zeros(fft_stack.shape[1])),
        "lowk_var_mean": arr("lowk_variance").mean(),
        "lowk_var_se": se(arr("lowk_variance")),
        "raw": results,
    }


def _lattice_gas_outs(beta_values, n_runs, ps_kwargs, init_kwargs,
                      run_kwargs, seed,
                      n_devices: Optional[int] = None, ckpt_dir=None):
    """Run the (β × replicas) grid on the site-centric lattice-gas engine
    (K=1 occ field, or the K>1 slot engine) and return reference-schema out
    dicts per replica (structure observables need no particle identity,
    so no tracers are tagged).  ``ckpt_dir=`` routes the grid
    through the checkpointed runners (utils.checkpoint) for mid-run
    preemption safety — XLA engines; composes with ``n_devices=`` (the
    resumed carry is re-placed with the run's sweep sharding)."""
    import jax

    from hydrolim_tpu.particles.init import eval_profile
    from hydrolim_tpu.particles.lattice_gas import run_lattice_gas
    from hydrolim_tpu.particles.lattice_gas_k import run_lattice_gas_k
    from hydrolim_tpu.sweeps.beta_sweep import config_from_kwargs
    from hydrolim_tpu.sweeps.ensemble import broadcast_params, ensemble_dt

    config = config_from_kwargs(ps_kwargs)
    assert config.exclusion, "lattice-gas engines require site_capacity"
    if config.K > 1:
        run_lattice_gas = run_lattice_gas_k
    rho0_p = rho0_m = None
    if config.init == "poisson":
        rho0_p = eval_profile(init_kwargs["rho0_plus"], config.L)
        rho0_m = eval_profile(init_kwargs["rho0_minus"], config.L)
    params = broadcast_params(
        config, beta=beta_values,
        rate_diffusion=float(ps_kwargs["rate_diffusion"]),
        rate_active=float(ps_kwargs["rate_active"]), n_runs=n_runs)
    dt = ensemble_dt(config, beta_max=float(np.max(beta_values)),
                     rate_diffusion=float(ps_kwargs["rate_diffusion"]),
                     rate_active=float(ps_kwargs["rate_active"]))
    T, obs_dt = float(run_kwargs["T"]), float(run_kwargs["obs_dt"])
    from hydrolim_tpu.parallel.mesh import pad_and_shard, resolve_sweep_mesh

    mesh = resolve_sweep_mesh(None, n_devices)
    B = params.beta.shape[0]
    params, _Bp = pad_and_shard(mesh, params, B)
    if ckpt_dir is not None:
        from hydrolim_tpu.utils.checkpoint import (
            run_lattice_gas_checkpointed,
            run_lattice_gas_k_checkpointed,
        )

        run_lattice_gas = functools.partial(
            run_lattice_gas_k_checkpointed if config.K > 1
            else run_lattice_gas_checkpointed, ckpt_dir=ckpt_dir, mesh=mesh)
    frames, _ = run_lattice_gas(config, params, jax.random.PRNGKey(seed),
                                T=T, obs_dt=obs_dt, dt=dt,
                                rho0_plus=rho0_p, rho0_minus=rho0_m)
    frames = jax.tree.map(lambda a: np.asarray(a)[:B],
                          jax.device_get(frames))
    times = np.arange(0.0, T, obs_dt)

    def out_for(i):
        return {
            "times_obs": times,
            "rho_p_list": np.asarray(frames.rho_p[i]),
            "rho_m_list": np.asarray(frames.rho_m[i]),
            "total_list": np.asarray(frames.total[i]),
            "m_local_list": np.asarray(frames.m_local[i]),
            "m_global": np.asarray(frames.m_global[i]),
            "var_list": np.asarray(frames.var[i]),
            "fft_amp_list": np.asarray(frames.fft_amp[i]),
        }

    return config, out_for


def sweep_betas_for_structures(beta_values, n_runs_per_beta: int,
                               ps_kwargs: Optional[Dict] = None,
                               init_kwargs: Optional[Dict] = None,
                               run_kwargs: Optional[Dict] = None,
                               start_fraction: float = 0.5,
                               k_max: Optional[int] = None, seed: int = 0,
                               keep_outs: bool = True,
                               engine: str = "particle",
                               n_devices: Optional[int] = None,
                               ckpt_dir=None) -> Dict:
    """β grid → {β: ensemble results} (:167-193).  The full
    (β × replicas) grid runs as one vmapped program.

    ``engine='lattice_gas'`` uses the site-centric K=1 engine — the
    structure observables need no particle identity, and the lattice-gas
    step is ~15× faster than the particle-centric exclusion path."""
    ps_kwargs = dict(DEFAULT_STRUCTURE_PS_KWARGS, **(ps_kwargs or {}))
    run_kwargs = dict(DEFAULT_STRUCTURE_RUN_KWARGS, **(run_kwargs or {}))
    if init_kwargs is None and ps_kwargs.get("init") == "poisson":
        # reference profile shape (:683-691; only reaches the sampler when
        # a caller overrides init='poisson' — 'fixed' ignores profiles)
        g = make_exp_gradient(L=int(ps_kwargs["L"]), N=int(ps_kwargs["N"]),
                              frac_plus=0.75, decay_length=0.2,
                              anchor_positions=None)
        init_kwargs = dict(rho0_plus=g[0], rho0_minus=g[1])
    beta_values = np.asarray(beta_values, dtype=float)
    if check_engine(engine, PARTICLE_ENGINES) == "lattice_gas":
        config, out_for = _lattice_gas_outs(
            beta_values, n_runs_per_beta, ps_kwargs, init_kwargs,
            run_kwargs, seed, n_devices=n_devices, ckpt_dir=ckpt_dir)
    else:
        config, res, _ = run_sweep_grid(beta_values, n_runs_per_beta,
                                        ps_kwargs, init_kwargs, run_kwargs,
                                        seed=seed, n_devices=n_devices,
                                        ckpt_dir=ckpt_dir)
    T, obs_dt = float(run_kwargs["T"]), float(run_kwargs["obs_dt"])
    results = {}
    for b_idx, beta in enumerate(beta_values):
        per_run = []
        for r in range(n_runs_per_beta):
            i = b_idx * n_runs_per_beta + r
            if engine == "lattice_gas":
                out = out_for(i)
            else:
                out = frames_to_out(res.frames, i, config, T, obs_dt,
                                    final_state=res.final_state)
            obs = extract_structure_observables_from_out(
                out, start_fraction=start_fraction, k_max=k_max)
            per_run.append({**obs, "out": out if keep_outs else None})
        arr = lambda key: np.array([x[key] for x in per_run])
        se = lambda a: (a.std(ddof=1) / np.sqrt(n_runs_per_beta)
                        if n_runs_per_beta > 1 else 0.0)
        fft_stack = np.stack([x["fft_mean"] for x in per_run], axis=0)
        results[float(beta)] = {
            "var_mean": arr("var_mean").mean(),
            "var_se": se(arr("var_mean")),
            "low_k_power_mean": arr("low_k_power").mean(),
            "low_k_power_se": se(arr("low_k_power")),
            "dominant_k_mode": int(np.round(arr("dominant_k").mean())),
            "m_local_var_mean": arr("m_local_var").mean(),
            "m_local_var_se": se(arr("m_local_var")),
            "fft_mean_mean": fft_stack.mean(axis=0),
            "fft_mean_se": (fft_stack.std(axis=0, ddof=1)
                            / np.sqrt(n_runs_per_beta)
                            if n_runs_per_beta > 1
                            else np.zeros(fft_stack.shape[1])),
            "lowk_var_mean": arr("lowk_variance").mean(),
            "lowk_var_se": se(arr("lowk_variance")),
            "raw": per_run,
        }
    return results


def save_structure_results(results: Dict, path: str) -> None:
    """npz persistence of the β→observables map (:625-633)."""
    flat = {}
    for beta, res in results.items():
        key = f"b{beta:.6f}"
        for name, val in res.items():
            if name == "raw":
                continue
            flat[f"{key}__{name}"] = np.asarray(val)
    flat["beta_values"] = np.asarray(sorted(results.keys()))
    np.savez(path, **flat)


def load_structure_results(path: str) -> Dict:
    """Inverse of :func:`save_structure_results` (:636-641)."""
    data = np.load(path, allow_pickle=True)
    betas = data["beta_values"]
    results = {}
    for beta in betas:
        key = f"b{float(beta):.6f}"
        res = {}
        for name in data.files:
            if name.startswith(key + "__"):
                val = data[name]
                res[name[len(key) + 2:]] = (val.item() if val.ndim == 0
                                            else val)
        results[float(beta)] = res
    return results
