"""β-sweep driver — the reference's flagship particle experiment.

Mirrors `PARTICLE_solver_BIOLOGY_EXCLUSION_sweep_beta.py`:
- ``make_exp_gradient`` IC factory (:16-53, duplicated across 5 files there;
  single canonical copy here),
- ``sweep_beta_ensemble`` (:56-117) — one β, n replicas,
- ``sweep_over_betas`` (:828-1028) — full β grid with npz checkpointing
  (run-flag pattern, :933-970), the (θ,γ) NB fit and the standard figures.

Batched difference: the reference's two nested Python loops
(β × replicas, :75,:895) collapse into ONE vmapped program — the entire
(n_beta × n_runs) grid advances per compiled step; estimators reduce
per-replica on host afterwards.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import jax
import numpy as np

from hydrolim_tpu.core.config import (
    PARTICLE_ENGINES,
    ParticleConfig,
    check_engine,
)
from hydrolim_tpu.particles.lattice_gas import tracer_valid_mask
from hydrolim_tpu.observables.estimators import (
    compute_blocking_probability,
    compute_D_eff_active,
    compute_mean_magnetization,
    compute_rho_eff,
    compute_v_eff_and_window,
)
from hydrolim_tpu.sweeps.ensemble import (
    broadcast_params,
    ensemble_dt,
    frames_to_out,
    run_particle_ensemble,
)
from hydrolim_tpu.fit.veff_fit import fit_and_plot_v_eff


# ---------------------------------------------------------------------------
# IC factory
# ---------------------------------------------------------------------------

def _profile_lookup(profile: np.ndarray, L: int):
    """x ∈ [0, 1] → nearest-site profile value; vectorized over array x
    (scalar in → scalar float out, preserving the reference callables'
    contract)."""

    def f(x):
        idx = np.clip(np.rint(np.asarray(x) * L).astype(int), 0, L - 1)
        val = profile[idx]
        return float(val) if np.ndim(x) == 0 else val

    return f


def make_exp_gradient(
    L: int,
    N: int,
    frac_plus: float,
    decay_length: float,
    anchor_positions=(0.25, 0.60),
    anchor_peak_width: float = 0.01,
    anchor_peak_mass: float = 0.03,
):
    """ρ₀± profile factory (spec: PARTICLE_solver_BIOLOGY_EXCLUSION.py
    :16-53): the + species decays exponentially from x = 0 with scale
    ``decay_length``; the − species is flat (baseline 0.05) plus one
    Gaussian bump of mass weight ``anchor_peak_mass`` per anchor; each
    shape is normalized to unit mass and scaled to ``N·frac_plus`` /
    ``N·(1−frac_plus)`` particles.  Returns
    ``[ρ₀₊ callable, ρ₀₋ callable, ρ₊ array, ρ₋ array]`` — the callables
    evaluate the nearest lattice site and accept scalars or arrays.
    Numeric identity with the reference factory is pinned by
    tests/test_sweeps.py::test_make_exp_gradient_golden."""
    xs = np.arange(L) / float(L)
    plus_shape = np.exp(-xs / decay_length)
    minus_shape = np.full(L, 0.05)
    if anchor_positions is not None and len(tuple(anchor_positions)):
        centers = np.asarray(tuple(anchor_positions), float)[:, None]
        minus_shape = minus_shape + anchor_peak_mass * np.exp(
            -0.5 * ((xs[None, :] - centers) / anchor_peak_width) ** 2
        ).sum(axis=0)
    rho_plus = N * frac_plus * plus_shape / plus_shape.sum()
    rho_minus = N * (1.0 - frac_plus) * minus_shape / minus_shape.sum()
    return [_profile_lookup(rho_plus, L), _profile_lookup(rho_minus, L),
            rho_plus, rho_minus]


# ---------------------------------------------------------------------------
# kwargs → config plumbing
# ---------------------------------------------------------------------------

DEFAULT_PS_KWARGS: Dict = dict(
    L=1000, xlim=1, rate_diffusion=0.02, rate_active=5, flip_rate_fn=None,
    init="poisson", N=500, scale_rates=False, local_kernel_sigma=0.005,
    minus_anchor=True, periodic=False, immobilize_when_anchored=True,
    anchor_radius=0.003, anchor_positions=None, site_capacity=1,
    crowding_suppresses_rates=False, k_on=0, k_off=0, k_exit=0,
)  # reference sweep configuration (:837-857)

DEFAULT_RUN_KWARGS: Dict = dict(T=20, obs_dt=0.1, record_fft=True,
                                record_var=True)  # (:829-834)


class _PsShim:
    """Minimal `ps`-like object for estimator signatures (dx, L, K)."""

    def __init__(self, config: ParticleConfig):
        self.config = config
        self.L = config.L
        self.dx = config.dx
        self.K = config.site_capacity
        self.xlim = config.xlim


def config_from_kwargs(ps_kwargs: Dict, **extra) -> ParticleConfig:
    kw = dict(ps_kwargs)
    flip_fn = kw.pop("flip_rate_fn", None)
    anchors = kw.pop("anchor_positions", None)
    # a particle exits at most once -> N slots always bound the exit log
    exit_buffer = (int(kw["N"]) if float(kw.get("k_exit", 0)) and anchors
                   else 0)
    extra.setdefault("exit_buffer", exit_buffer)
    if flip_fn is not None:
        extra.setdefault("flip_rate_fn", flip_fn)
    return ParticleConfig(
        L=int(kw["L"]), xlim=float(kw["xlim"]), init=kw.get("init", "fixed"),
        N=int(kw["N"]), scale_rates=bool(kw.get("scale_rates", True)),
        local_kernel_sigma=float(kw.get("local_kernel_sigma", 0.005)),
        periodic=bool(kw.get("periodic", False)),
        minus_anchor=bool(kw.get("minus_anchor", True)),
        immobilize_when_anchored=bool(kw.get("immobilize_when_anchored", True)),
        anchor_positions=tuple(anchors) if anchors else None,
        anchor_radius=float(kw.get("anchor_radius", 0.005)),
        site_capacity=kw.get("site_capacity", 1),
        crowding_suppresses_rates=bool(kw.get("crowding_suppresses_rates", False)),
        suppress_flip_when_bound=bool(kw.get("suppress_flip_when_bound", True)),
        active_model=kw.get("active_model", "plus_forward"),
        **extra)


def _profiles(config: ParticleConfig, init_kwargs: Optional[Dict]):
    if config.init != "poisson":
        return None, None
    assert init_kwargs is not None, "poisson init requires init_kwargs"
    from hydrolim_tpu.particles.init import eval_profile

    return (eval_profile(init_kwargs["rho0_plus"], config.L),
            eval_profile(init_kwargs["rho0_minus"], config.L))


# ---------------------------------------------------------------------------
# vmapped sweep core
# ---------------------------------------------------------------------------

def run_sweep_grid_lattice_gas(beta_values, n_runs: int, ps_kwargs: Dict,
                               init_kwargs: Optional[Dict],
                               run_kwargs: Dict, seed: int = 0,
                               n_tracers: Optional[int] = None,
                               mesh=None, n_devices: Optional[int] = None,
                               ckpt_dir=None, chunk_frames: int = 64,
                               stop_after_chunks: Optional[int] = None):
    """(β × replicas) grid on the site-centric lattice-gas engine (K=1 occ
    field or the K>1 slot engine — both far above particle-centric exclusion
    throughput); returns (config, out_for(i) accessor, dt).  Tagged tracers
    provide the displacement positions for D_eff; the default tags EVERY
    particle (n_tracers=N), matching the reference's all-particle tracking
    (``..._sweep_beta.py:500-525``) — pass a smaller count to trade
    estimator variance for record memory.

    ``mesh=``/``n_devices=`` shard the flattened (β × replicas) batch over
    a device mesh ('sweep' axis, pure DP): the batch is padded to the mesh
    multiple (results bit-identical to the 1-device run — prefix-stable
    key splits; see parallel.mesh.pad_batch) and pad replicas dropped.

    ``ckpt_dir=`` checkpoints the grid every ``chunk_frames`` frames;
    ``stop_after_chunks`` halts after that many new chunks and returns
    None (a resumed call picks up from the last complete chunk)."""
    from hydrolim_tpu.parallel.mesh import pad_and_shard, resolve_sweep_mesh
    from hydrolim_tpu.particles.lattice_gas import run_lattice_gas
    from hydrolim_tpu.particles.lattice_gas_k import run_lattice_gas_k

    config = config_from_kwargs(ps_kwargs)
    assert config.exclusion, "lattice-gas engines require site_capacity"
    if config.K > 1:
        run_lattice_gas = run_lattice_gas_k
    rho0_p, rho0_m = _profiles(config, init_kwargs)
    rates = dict(
        rate_diffusion=float(ps_kwargs["rate_diffusion"]),
        rate_active=float(ps_kwargs["rate_active"]),
        k_on=float(ps_kwargs.get("k_on", 0)),
        k_off=float(ps_kwargs.get("k_off", 0)),
        k_exit=float(ps_kwargs.get("k_exit", 0)))
    params = broadcast_params(config, beta=beta_values, n_runs=n_runs,
                              **rates)
    dt = ensemble_dt(config, beta_max=float(np.max(beta_values)), **rates)
    T, obs_dt = float(run_kwargs["T"]), float(run_kwargs["obs_dt"])
    record_fft = bool(run_kwargs.get("record_fft", True))
    times = np.arange(0.0, T, obs_dt)
    key = jax.random.PRNGKey(seed)
    mesh = resolve_sweep_mesh(mesh, n_devices)
    B = params.beta.shape[0]
    params, _Bp = pad_and_shard(mesh, params, B)
    unpad = lambda tree: jax.tree.map(lambda a: np.asarray(a)[:B], tree)
    if config.anchor_positions is not None:
        from hydrolim_tpu.particles.lattice_gas_k import (
            run_lattice_gas_anchored,
        )

        frames, _, exit_log = run_lattice_gas_anchored(
            config, params, key, T=T, obs_dt=obs_dt, dt=dt,
            rho0_plus=rho0_p, rho0_minus=rho0_m, record_fft=record_fft)
        frames, exit_log = unpad(jax.device_get((frames, exit_log)))
        out_for = _lattice_gas_out_accessor(frames, times,
                                            exit_log=exit_log)
        return config, out_for, dt, frames
    # tag budget: Poisson inits realize a profile-determined count that can
    # exceed N (up to the n_buf headroom) — tag the whole buffer so every
    # realized particle carries an identity (surplus tags are
    # TRACER_INVALID); 'fixed' inits realize exactly N
    full_tags = config.n_buf if config.init == "poisson" else config.N
    n_tracers = full_tags if n_tracers is None else min(n_tracers, full_tags)
    if ckpt_dir is not None:
        # mid-run preemption safety for the whole in-flight grid program
        # (the npz cache only skips COMPLETED sweeps); composes with mesh=
        # — the restored carry is re-placed with the run's sweep sharding
        # (utils.checkpoint._place), trajectories bit-identical either way
        from hydrolim_tpu.utils.checkpoint import (
            run_lattice_gas_checkpointed,
            run_lattice_gas_k_checkpointed,
        )

        ck_runner = (run_lattice_gas_k_checkpointed if config.K > 1
                     else run_lattice_gas_checkpointed)
        out = ck_runner(
            config, params, key, T=T, obs_dt=obs_dt, dt=dt,
            rho0_plus=rho0_p, rho0_minus=rho0_m, n_tracers=n_tracers,
            record_fft=record_fft, ckpt_dir=ckpt_dir, mesh=mesh,
            chunk_frames=chunk_frames, stop_after_chunks=stop_after_chunks)
        if out is None:
            return None
        frames, _ = out
    else:
        frames, _ = run_lattice_gas(config, params, key,
                                    T=T, obs_dt=obs_dt, dt=dt,
                                    rho0_plus=rho0_p, rho0_minus=rho0_m,
                                    n_tracers=n_tracers,
                                    record_fft=record_fft)
    frames = unpad(jax.device_get(frames))
    out_for = _lattice_gas_out_accessor(frames, times)
    return config, out_for, dt, frames


def _lattice_gas_out_accessor(frames, times, exit_log=None):

    def out_for(i):
        tr = np.asarray(frames.tracer_pos[i])
        if exit_log is not None:
            ec, et, ep = exit_log
            k = min(int(ec[i]), et.shape[1])
            exit_times = list(np.asarray(et[i][:k]))
            exit_positions = list(np.asarray(ep[i][:k]))
        else:
            exit_times, exit_positions = [], []
        return {
            "times_obs": times,
            "rho_p_list": np.asarray(frames.rho_p[i]),
            "rho_m_list": np.asarray(frames.rho_m[i]),
            "total_list": np.asarray(frames.total[i]),
            "m_local_list": np.asarray(frames.m_local[i]),
            "m_global": np.asarray(frames.m_global[i]),
            "var_list": np.asarray(frames.var[i]),
            "fft_amp_list": (np.asarray(frames.fft_amp[i])
                             if frames.fft_amp.shape[-1] else None),
            # tracer positions play the role of pos_frames for D_eff
            # (TRACER_INVALID marks invalid/phantom tags under sparse inits)
            "pos_frames": tr,
            "alive_frames": tracer_valid_mask(tr),
            "pos_list": None,
            "exit_times": exit_times,
            "exit_positions": exit_positions,
        }

    return out_for


def run_sweep_grid(beta_values, n_runs: int, ps_kwargs: Dict,
                   init_kwargs: Optional[Dict], run_kwargs: Dict,
                   seed: int = 0, chunk_size: int = 256, mesh=None,
                   n_devices: Optional[int] = None, ckpt_dir=None,
                   chunk_frames: int = 64,
                   stop_after_chunks: Optional[int] = None):
    """Run the full (β × replicas) grid vmapped; returns
    (config, batched frames on host, dt).

    Grids larger than ``chunk_size`` replicas run as equal-shape chunks of
    one compiled executable, which bounds the device-resident frame
    memory.

    ``mesh=``/``n_devices=`` shard each chunk's batch over the mesh's
    'sweep' axis.  The chunk STRIDE (and hence each chunk's
    fold_in(seed, c0) key) never depends on the mesh — each chunk's batch
    is padded up to the mesh multiple instead, so replicas are
    bit-identical to the 1-device run for any chunk_size/mesh combination
    (prefix-stable key splits — parallel.mesh.pad_batch).

    ``ckpt_dir=`` makes each in-flight replica chunk preemption-safe on
    the TIME axis (utils.checkpoint.run_particle_ensemble_checkpointed,
    one subdirectory per replica chunk); completed replica chunks resume
    instantly from their stored frames.  Composes with ``mesh=`` (the
    restored carry is re-placed with the run's sweep sharding).
    ``chunk_frames``/``stop_after_chunks`` as in
    :func:`run_sweep_grid_lattice_gas`; a halted run returns None."""
    from hydrolim_tpu.parallel.mesh import (
        resolve_sweep_mesh,
        shard_batch,
        sweep_axis_size,
    )

    config = config_from_kwargs(ps_kwargs)
    rho0_p, rho0_m = _profiles(config, init_kwargs)
    beta_flat = np.repeat(np.asarray(beta_values, dtype=np.float32), n_runs)
    B = beta_flat.shape[0]
    rates = dict(
        rate_diffusion=float(ps_kwargs["rate_diffusion"]),
        rate_active=float(ps_kwargs["rate_active"]),
        k_on=float(ps_kwargs.get("k_on", 0)),
        k_off=float(ps_kwargs.get("k_off", 0)),
        k_exit=float(ps_kwargs.get("k_exit", 0)))
    dt = ensemble_dt(config, beta_max=float(np.max(beta_values)), **rates)
    T, obs_dt = float(run_kwargs["T"]), float(run_kwargs["obs_dt"])

    mesh = resolve_sweep_mesh(mesh, n_devices)
    n_sw = sweep_axis_size(mesh)
    # chunk STRIDE stays at the unsharded value so the per-chunk
    # fold_in(seed, c0) keys are identical for every mesh size; each chunk's
    # batch is padded up to the mesh multiple instead (prefix-stable key
    # splits keep the real replicas bit-identical — parallel/mesh.py)
    Cs = min(chunk_size, B)
    Bp = -(-Cs // n_sw) * n_sw
    chunks = []
    for c0 in range(0, B, Cs):
        n_real = min(Cs, B - c0)
        pad = Bp - n_real
        bc = np.concatenate([beta_flat[c0:c0 + n_real],
                             np.repeat(beta_flat[c0:c0 + 1], pad)])
        params = broadcast_params(config, beta=bc, **rates)
        if mesh is not None:
            params = shard_batch(mesh, params, Bp)
        ckey = jax.random.fold_in(jax.random.PRNGKey(seed), c0)
        record_pos = bool(run_kwargs.get("record_pos", True))
        record_fft = bool(run_kwargs.get("record_fft", True))
        if ckpt_dir is not None:
            from hydrolim_tpu.particles.init import init_particles
            from hydrolim_tpu.utils.checkpoint import (
                run_particle_ensemble_checkpointed,
            )

            # same init fan-out as run_particle_ensemble: per-replica key
            # splits of the chunk key, then the batched chunked scan;
            # mesh= composes (the checkpoint driver re-places the carry)
            keys = jax.random.split(ckey, Bp)
            states = jax.vmap(
                lambda k: init_particles(config, k, rho0_p, rho0_m))(keys)
            res = run_particle_ensemble_checkpointed(
                config, params, states, T=T, obs_dt=obs_dt, dt=dt,
                ckpt_dir=Path(ckpt_dir) / f"replicas_{c0:05d}",
                record_pos=record_pos, record_fft=record_fft, mesh=mesh,
                chunk_frames=chunk_frames,
                stop_after_chunks=stop_after_chunks)
            if res is None:
                return None
        else:
            res = run_particle_ensemble(
                config, params, ckey,
                T=T, obs_dt=obs_dt, dt=dt, rho0_plus=rho0_p,
                rho0_minus=rho0_m,
                record_pos=record_pos, record_fft=record_fft)
        res = jax.device_get(res)
        if pad:  # every frames/final_state leaf carries the batch on axis 0
            res = jax.tree.map(lambda a: a[:n_real], res)
        chunks.append(res)
    if len(chunks) == 1:
        return config, chunks[0], dt
    res = jax.tree.map(lambda *a: np.concatenate(a, axis=0), *chunks)
    return config, res, dt


def _estimates_for_replica(out: Dict, ps: _PsShim):
    mean_v, v_ts, times, si, ei, frac = compute_v_eff_and_window(out, ps)
    D_eff = compute_D_eff_active(out, ps, si, ei)
    m_mean = compute_mean_magnetization(out, si, ei)
    rho_eff = compute_rho_eff(out, si, ei,
                              xlim=float(getattr(ps, "xlim", 1.0)))
    block = compute_blocking_probability(out, si, ei)
    return mean_v, D_eff, m_mean, rho_eff, block


def sweep_beta_ensemble(beta, n_runs: int = 10, ps_kwargs: Optional[Dict] = None,
                        init_kwargs: Optional[Dict] = None,
                        run_kwargs: Optional[Dict] = None,
                        rng_seeds=None, seed: int = 0,
                        estimator: str = "device", mesh=None,
                        n_devices: Optional[int] = None):
    """Single-β ensemble with the reference's 14-tuple return (:56-117).

    Shares the batched on-device estimator path with ``sweep_over_betas``
    (``estimator='device'``, the default — one jitted program for all
    replicas); ``'host'`` keeps the per-replica NumPy estimators."""
    ps_kwargs = dict(DEFAULT_PS_KWARGS, **(ps_kwargs or {}))
    run_kwargs = dict(DEFAULT_RUN_KWARGS, **(run_kwargs or {}))
    if rng_seeds is not None:
        seed = int(np.asarray(rng_seeds).flat[0])
    config, res, dt = run_sweep_grid(np.asarray([beta]), n_runs, ps_kwargs,
                                     init_kwargs, run_kwargs, seed=seed,
                                     mesh=mesh, n_devices=n_devices)
    ps = _PsShim(config)
    T, obs_dt = float(run_kwargs["T"]), float(run_kwargs["obs_dt"])
    out_list = [frames_to_out(res.frames, r, config, T, obs_dt,
                              final_state=res.final_state)
                for r in range(n_runs)]
    if estimator == "device":
        from hydrolim_tpu.observables.batched import batched_estimates

        f = res.frames
        est = jax.device_get(batched_estimates(
            f.total, f.m_global, f.rho_p, np.arange(0.0, T, obs_dt),
            f.pos, f.alive, dx=config.dx, xlim=float(config.xlim),
            has_positions=f.pos.shape[-1] > 0))
        v_list = list(np.asarray(est.v_eff, float)[:n_runs])
        D_list = list(np.asarray(est.D_eff, float)[:n_runs])
        m_list = list(np.asarray(est.m_mean, float)[:n_runs])
        rho_list = list(np.asarray(est.rho_eff, float)[:n_runs])
        block_list = list(np.asarray(est.p_block, float)[:n_runs])
    else:
        v_list, D_list, m_list, rho_list, block_list = [], [], [], [], []
        for out in out_list:
            v, D, m, rho, blk = _estimates_for_replica(out, ps)
            v_list.append(v)
            D_list.append(D)
            m_list.append(m)
            rho_list.append(rho)
            block_list.append(blk)

    def _stats(vals):
        a = np.asarray(vals, dtype=float)
        std = a.std(ddof=1) if a.size > 1 else 0.0
        return float(a.mean()), float(std), float(std / np.sqrt(max(1, a.size)))

    mean, std, se = _stats(v_list)
    m_mean, m_std, m_se = _stats(m_list)
    rho_mean, _, rho_se = _stats(rho_list)
    block_mean, _, block_se = _stats(block_list)
    D_mean, _, D_se = _stats(D_list)
    return (mean, std, se, np.asarray(v_list), out_list, m_mean, m_std, m_se,
            rho_mean, rho_se, block_mean, block_se, D_mean, D_se)


def sweep_over_betas(beta_values, n_runs_per_beta: int = 10, run: bool = True,
                     save_dict: Optional[Dict] = None,
                     ps_kwargs: Optional[Dict] = None,
                     init_kwargs: Optional[Dict] = None,
                     run_kwargs: Optional[Dict] = None,
                     npz_path: str = "beta_sweep_results.npz",
                     outdir: str = ".", seed: int = 0,
                     keep_outs: bool = False, do_fit: bool = True,
                     plot_result: bool = True,
                     engine: str = "particle",
                     estimator: str = "device", mesh=None,
                     n_devices: Optional[int] = None,
                     ckpt_dir=None, chunk_frames: int = 64,
                     stop_after_chunks: Optional[int] = None
                     ) -> Optional[Dict]:
    """Full β sweep (:828-1028): one vmapped grid run → estimator means ±
    SE per β → npz checkpoint → (θ,γ) fit and figures.  ``run=False``
    reloads ``npz_path`` and re-plots without re-simulating.

    ``estimator='device'`` (particle engine only) evaluates all five
    estimators for every replica in one jitted batched program
    (observables.batched) — estimation stays ≪ sim time at 10³+ replicas;
    ``'host'`` keeps the per-replica NumPy path.

    ``mesh=``/``n_devices=`` shard the (β × replicas) batch over a device
    mesh (pure sweep-axis DP; per-replica observables bit-identical to the
    1-device run — see run_sweep_grid / parallel.mesh).

    ``engine`` is ``'particle'`` or ``'lattice_gas'`` (the site-centric
    engines; exclusion configs only).  ``ckpt_dir=`` checkpoints the grid
    program every ``chunk_frames`` frames; with ``stop_after_chunks`` the
    call halts after that many new chunks and returns None, and the next
    call with the same ``ckpt_dir`` resumes bit-identically."""
    beta_values = np.asarray(beta_values, dtype=float)
    ps_kwargs = dict(DEFAULT_PS_KWARGS, **(ps_kwargs or {}))
    run_kwargs = dict(DEFAULT_RUN_KWARGS, **(run_kwargs or {}))
    if init_kwargs is None and ps_kwargs.get("init") == "poisson":
        grad = make_exp_gradient(L=int(ps_kwargs["L"]), N=int(ps_kwargs["N"]),
                                 frac_plus=0.75, decay_length=0.35,
                                 anchor_positions=None)
        init_kwargs = dict(rho0_plus=grad[0], rho0_minus=grad[1])

    check_engine(engine, PARTICLE_ENGINES)
    if run:
        lg_frames = None
        ckpt = dict(mesh=mesh, n_devices=n_devices, ckpt_dir=ckpt_dir,
                    chunk_frames=chunk_frames,
                    stop_after_chunks=stop_after_chunks)
        if engine == "lattice_gas":
            grid = run_sweep_grid_lattice_gas(
                beta_values, n_runs_per_beta, ps_kwargs, init_kwargs,
                run_kwargs, seed=seed, **ckpt)
            if grid is None:
                return None
            config, out_for, dt, lg_frames = grid
        else:
            grid = run_sweep_grid(beta_values, n_runs_per_beta, ps_kwargs,
                                  init_kwargs, run_kwargs, seed=seed, **ckpt)
            if grid is None:
                return None
            config, res, dt = grid
        ps = _PsShim(config)
        T, obs_dt = float(run_kwargs["T"]), float(run_kwargs["obs_dt"])
        nb = len(beta_values)
        per_beta = {k: [] for k in
                    ("means", "stds", "ses", "D_means", "D_ses", "m_means",
                     "m_stds", "m_ses", "rho_means", "rho_ses", "block_means",
                     "block_ses")}
        raw_by_beta = []
        outs = []
        dev_est = None
        if estimator == "device":
            from hydrolim_tpu.observables.batched import batched_estimates

            times = np.arange(0.0, T, obs_dt)
            if engine == "lattice_gas":
                f = lg_frames
                tr = np.asarray(f.tracer_pos)
                dev_est = jax.device_get(batched_estimates(
                    f.total, f.m_global, f.rho_p, times, tr,
                    tracer_valid_mask(tr), dx=config.dx,
                    xlim=float(config.xlim),
                    has_positions=tr.shape[-1] > 0))
            else:
                f = res.frames
                dev_est = jax.device_get(batched_estimates(
                    f.total, f.m_global, f.rho_p, times, f.pos, f.alive,
                    dx=config.dx, xlim=float(config.xlim),
                    has_positions=f.pos.shape[-1] > 0))
        for b in range(nb):
            vals = {"v": [], "D": [], "m": [], "rho": [], "blk": []}
            beta_outs = []
            for r in range(n_runs_per_beta):
                ri = b * n_runs_per_beta + r
                if dev_est is not None:
                    v, D, m, rho, blk = (
                        float(dev_est.v_eff[ri]), float(dev_est.D_eff[ri]),
                        float(dev_est.m_mean[ri]), float(dev_est.rho_eff[ri]),
                        float(dev_est.p_block[ri]))
                    out = None
                    if keep_outs:
                        out = (out_for(ri) if engine == "lattice_gas" else
                               frames_to_out(res.frames, ri, config, T,
                                             obs_dt,
                                             final_state=res.final_state))
                else:
                    if engine == "lattice_gas":
                        out = out_for(ri)
                    else:
                        out = frames_to_out(res.frames, ri, config, T,
                                            obs_dt,
                                            final_state=res.final_state)
                    v, D, m, rho, blk = _estimates_for_replica(out, ps)
                for k, x in zip(("v", "D", "m", "rho", "blk"),
                                (v, D, m, rho, blk)):
                    vals[k].append(x)
                if keep_outs:
                    beta_outs.append(out)
            stat = lambda a: (np.mean(a),
                              np.std(a, ddof=1) if len(a) > 1 else 0.0,
                              (np.std(a, ddof=1) if len(a) > 1 else 0.0)
                              / np.sqrt(max(1, len(a))))
            vm, vs, vse = stat(vals["v"])
            Dm, _, Dse = stat(vals["D"])
            mm, ms, mse = stat(vals["m"])
            rm, _, rse = stat(vals["rho"])
            bm, _, bse = stat(vals["blk"])
            for k, x in (("means", vm), ("stds", vs), ("ses", vse),
                         ("D_means", Dm), ("D_ses", Dse), ("m_means", mm),
                         ("m_stds", ms), ("m_ses", mse), ("rho_means", rm),
                         ("rho_ses", rse), ("block_means", bm),
                         ("block_ses", bse)):
                per_beta[k].append(x)
            raw_by_beta.append(np.asarray(vals["v"]))
            if keep_outs:
                outs.append(beta_outs)
        arrays = {k: np.asarray(v) for k, v in per_beta.items()}
        save_dict = {"beta_values": beta_values, **arrays,
                     "ps_kwargs": ps_kwargs, "dt": dt}
        Path(npz_path).parent.mkdir(parents=True, exist_ok=True)
        np.savez(npz_path, **{k: v for k, v in save_dict.items()
                              if k != "ps_kwargs"},
                 ps_kwargs=np.asarray(
                     {k: v for k, v in ps_kwargs.items()
                      if not callable(v)}, dtype=object))
    else:
        data = np.load(npz_path, allow_pickle=True)
        save_dict = dict(data)
        beta_values = save_dict["beta_values"]
        ps_kwargs = save_dict["ps_kwargs"].item()
        arrays = {k: save_dict[k] for k in
                  ("means", "stds", "ses", "D_means", "D_ses", "m_means",
                   "m_stds", "m_ses", "rho_means", "rho_ses", "block_means",
                   "block_ses")}
        outs = []

    if do_fit:
        popt, pcov, fit_out = fit_and_plot_v_eff(
            beta_values, ps_kwargs, arrays["means"], arrays["stds"],
            arrays["ses"], arrays["m_means"], arrays["m_stds"],
            arrays["m_ses"], arrays["rho_means"], arrays["rho_ses"],
            arrays["block_means"], arrays["block_ses"],
            plot_result=plot_result, outdir=outdir)
        save_dict.update(popt=popt, pcov=pcov, fit_out=fit_out)
        if plot_result:
            from hydrolim_tpu.viz.sweep_plots import plot_D_eff_vs_beta

            plot_D_eff_vs_beta(beta_values, arrays["D_means"],
                               arrays["D_ses"], ps_kwargs, outdir=outdir)
    if keep_outs:
        save_dict["outs"] = outs
    return save_dict
