"""On-card smoke test: the XLA particle and PDE engines end to end on an
NVIDIA GPU, through the public entry points, at the sizes researchers run.

    python chip_smoke.py              # one card: every single-card phase
    python chip_smoke.py --multi-gpu  # four cards: the sharded paths only

The script refuses to start unless JAX's default platform is ``gpu``: it
exits non-zero before any phase runs.  It prints the card's name and power
limit (nvidia-smi), ``jax.__version__`` and ``XLA_FLAGS``, then one line per
phase with its cold (compile + run) and warm wall times, the device's
``peak_bytes_in_use`` so far in the process, and its comparisons.  A failed
check raises, so the script exits non-zero with no result line; the last
line on success is ``{"ok": true, "device": {...}}``.

Single-card phases (each against a reference named in its docstring):

- ``meanfield``: τ-leap ensemble, 64 β × N=10⁵, L=1000, bidirectional,
  global m, periodic (BASELINE.json configs 1 and 4),
- ``exclusion_sweep``: the reference flagship exclusion β-sweep through
  ``sweep_over_betas(engine='lattice_gas')`` (L=1000, N=750, K=3,
  σ=0.002, active rate 5, walls, T=20, obs_dt=0.5, 11 β × 3 runs),
- ``pde_single``: ``IMEXPDE`` at the reference single-run scale (L=1000,
  T=20, dt=5e-4: 40,000 steps, 1000 tracers),
- ``pde_sweep``: ``pde_beta_sweep`` at 11 β × 3 runs at that scale,
- ``resume``: the flagship sweep checkpointed, halted after one chunk and
  resumed,
- ``precision``: every float matmul of the three engines asks for full f32
  (none may run in TF32).

``--multi-gpu`` (4 cards): the L=65,536 lattice of
``experiments/run_large_lattice.py`` over a 4-way 'space' mesh against one
card, and the flagship sweep with ``n_devices=4`` against ``n_devices=1``.

Tolerances (why each is what it is):

- τ-leap GPU-vs-CPU comparisons: the threefry bits are the same on both
  backends, but f32 ``exp`` and reduction order may differ, which flips a
  rare event decision and lets trajectories drift apart.  So unless the
  state is bit-equal, the ensemble means must agree within 3 combined
  standard errors (pooled over the β grid).
- PDE fields GPU-vs-CPU after 2,000 steps: deterministic f32 arithmetic
  whose only differences are rounding and reassociation; max relative
  difference ≤ ``PDE_FIELD_RTOL``.
- Mass: the IMEX step renormalizes total mass every step, so it moves only
  by f32 rounding: relative drift ≤ 1e-4 over the whole solve.
- Checkpoint resume: bit-identical by construction (per-frame keys).
- Multi-card: particle trajectories bit-identical (integer state, count
  reductions); the sweep's float records within ``MESH_RTOL`` where matmul
  records reassociate across shard shapes; PDE fields within
  ``PDE_FIELD_RTOL`` (their per-step mass sums reassociate across shards,
  and 1,500 steps compound the ulps).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

#: PDE fields, GPU vs CPU after 2,000 steps (max |Δ| / max |ρ|)
PDE_FIELD_RTOL = 1e-4
#: float records, 4 cards vs 1 card (max |Δ| / max |x|): a few f32 ulps
MESH_RTOL = 1e-5
#: the flagship exclusion sweep (PARTICLE_solver_BIOLOGY_EXCLUSION.py:55-94)
FLAGSHIP_PS = dict(L=1000, xlim=1, N=750, rate_diffusion=0.0, rate_active=5,
                   init="fixed", scale_rates=False, local_kernel_sigma=0.002,
                   minus_anchor=True, periodic=False, site_capacity=3,
                   anchor_positions=None, k_on=0, k_off=0, k_exit=0)
FLAGSHIP_BETAS = np.linspace(0.0, 3.0, 11)


def _device_or_exit():
    """The default devices when they are GPUs; exit non-zero otherwise."""
    import jax

    try:
        devices = jax.devices()
    except RuntimeError as e:
        sys.exit(f"chip_smoke: JAX found no usable backend: {e}")
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: needs a GPU; JAX's default platform is "
                 f"{devices[0].platform!r}")
    return devices


def _peak_bytes() -> int:
    import jax

    return int(jax.devices()[0].memory_stats().get("peak_bytes_in_use", 0))


def _cold_warm(fn):
    """Run ``fn`` twice; returns (result of the warm run, cold s, warm s).
    ``fn`` must return host data or block on its device results."""
    t0 = time.perf_counter()
    fn()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = fn()
    return out, cold, time.perf_counter() - t0


def _on_cpu(fn):
    """``fn()`` with JAX's default device set to the host CPU."""
    import jax

    with jax.default_device(jax.devices("cpu")[0]):
        return fn()


def _pooled_agree(a, a_se, b, b_se):
    """Agreement of two sets of ensemble means: (ok, z, bit_equal), where z
    is the summed difference over the grid in units of its combined
    standard error; ok when bit-equal or |z| ≤ 3."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    if np.array_equal(a, b):
        return True, 0.0, True
    se = float(np.sqrt(np.sum(np.square(a_se)) + np.sum(np.square(b_se))))
    z = float(np.sum(a - b)) / se if se > 0 else float("inf")
    return abs(z) <= 3.0, z, False


def _n_steps(T, obs_dt, dt):
    """τ-leap steps a recorded run takes: the frame scan advances
    ``substeps_for(obs_dt, dt)`` steps between consecutive frames."""
    from hydrolim_tpu.particles.run import substeps_for

    return substeps_for(obs_dt, dt) * (len(np.arange(0.0, T, obs_dt)) - 1)


def _report(name, cold, warm, checks):
    line = dict(cold_s=round(cold, 3), warm_s=round(warm, 3),
                peak_bytes_in_use=_peak_bytes(), checks=checks)
    print(f"phase {name}: {json.dumps(line)}", flush=True)


# ---------------------------------------------------------------------------
# single-card phases
# ---------------------------------------------------------------------------

def phase_meanfield(B=64, N=100_000, L=1000, T=20.0, obs_dt=1.0,
                    T_short=0.5, obs_dt_short=0.1):
    """τ-leap fast path through ``run_particle_ensemble``: the same call on
    the host CPU at ``T_short`` (3 combined SE, or bit-equal), and the
    late-window |m|(β) at ``T`` against the tanh fixed point."""
    import jax

    from hydrolim_tpu.core.config import ParticleConfig
    from hydrolim_tpu.sweeps.ensemble import (
        broadcast_params,
        ensemble_dt,
        run_particle_ensemble,
    )
    from hydrolim_tpu.theory.meanfield import m_fixed_point

    config = ParticleConfig(L=L, N=N, n_pad=N, init="fixed",
                            scale_rates=False, local_kernel_sigma=0.0,
                            periodic=True, site_capacity=None,
                            active_model="bidirectional")
    betas = np.linspace(0.0, 3.0, B)
    rates = dict(rate_diffusion=0.5, rate_active=2.0)
    dt = ensemble_dt(config, beta_max=3.0, **rates)

    def run(T_, obs_dt_):
        params = broadcast_params(config, beta=betas, **rates)
        res = run_particle_ensemble(config, params, jax.random.PRNGKey(0),
                                    T=T_, obs_dt=obs_dt_, dt=dt,
                                    record_pos=False)
        frames = res.frames
        return (jax.device_get(frames.m_global), jax.device_get(frames.var),
                jax.device_get(res.final_state.pos),
                list(frames.m_global.devices())[0].platform)

    (m_t, _, _, plat), cold, warm = _cold_warm(lambda: run(T, obs_dt))
    assert plat == jax.devices()[0].platform, plat     # the default device
    late = np.arange(0.0, T, obs_dt) >= 0.75 * T
    m_abs = np.abs(m_t[:, late]).mean(axis=1)
    m_th = m_fixed_point(betas)
    ordered, disordered = betas >= 1.5, betas <= 0.7
    err_ord = float(np.max(np.abs(m_abs[ordered] - m_th[ordered])))
    err_dis = float(np.max(m_abs[disordered]))
    assert err_ord < 0.02 and err_dis < 0.03, (err_ord, err_dis)

    m_g, var_g, pos_g, _ = run(T_short, obs_dt_short)
    m_c, var_c, pos_c, plat_c = _on_cpu(lambda: run(T_short, obs_dt_short))
    assert plat_c == "cpu", plat_c
    # one replica per β: each replica's own standard error is the spread of
    # the replicas (the short run stays near the β-independent start)
    se = lambda x: np.full(x.shape[0], x.std(ddof=1))
    ok_m, z_m, eq_m = _pooled_agree(m_g[:, -1], se(m_g[:, -1]),
                                    m_c[:, -1], se(m_c[:, -1]))
    ok_v, z_v, eq_v = _pooled_agree(var_g[:, -1], se(var_g[:, -1]),
                                    var_c[:, -1], se(var_c[:, -1]))
    assert ok_m and ok_v, (z_m, z_v)
    steps = _n_steps(T, obs_dt, dt)
    _report("meanfield", cold, warm, dict(
        B=B, N=N, T=T, steps=steps,
        particle_steps_per_s=B * N * steps / warm, m_ordered_max_err=err_ord,
        m_disordered_max=err_dis, cpu_T=T_short,
        cpu_state_bit_equal=bool(np.array_equal(pos_g, pos_c)),
        cpu_m_z=z_m, cpu_var_z=z_v, cpu_m_equal=eq_m, cpu_var_equal=eq_v))


def _flagship_sweep(T, obs_dt, outdir, **kw):
    """The flagship exclusion β-sweep through ``sweep_over_betas``."""
    from hydrolim_tpu.sweeps.beta_sweep import sweep_over_betas

    return sweep_over_betas(
        FLAGSHIP_BETAS, n_runs_per_beta=3, ps_kwargs=dict(FLAGSHIP_PS),
        run_kwargs=dict(T=T, obs_dt=obs_dt, record_fft=True,
                        record_var=True),
        npz_path=os.path.join(outdir, "sweep.npz"), outdir=outdir, seed=0,
        plot_result=False, engine="lattice_gas", **kw)


def _occupancy_checks(save):
    """Occupancy ≤ K in every frame of every replica and exact particle
    conservation, from the per-replica density series."""
    N, K, L = FLAGSHIP_PS["N"], FLAGSHIP_PS["site_capacity"], FLAGSHIP_PS["L"]
    counts = np.stack([np.asarray(o["total_list"], np.float64)
                       for outs in save["outs"] for o in outs]) * N / L
    ints = np.rint(counts)
    assert np.allclose(counts, ints, atol=1e-3), "non-integer occupancy"
    assert ints.max() <= K, f"site occupancy {ints.max()} > K={K}"
    assert np.all(ints.sum(-1) == N), "particle number not conserved"
    return int(ints.max())


def _slot_step_us(B, T=20.0, obs_dt=0.5):
    """Warm µs per step of the slot engine alone on the flagship config at
    batch ``B``, recording frames and tagging every particle as the sweep
    does: the baseline a fused exclusion kernel has to beat."""
    import jax

    from hydrolim_tpu.particles.lattice_gas_k import run_lattice_gas_k
    from hydrolim_tpu.sweeps.beta_sweep import config_from_kwargs
    from hydrolim_tpu.sweeps.ensemble import broadcast_params, ensemble_dt

    config = config_from_kwargs(FLAGSHIP_PS)
    rates = dict(rate_diffusion=0.0, rate_active=5.0)
    params = broadcast_params(config, beta=np.full(B, 0.7), **rates)
    dt = ensemble_dt(config, beta_max=3.0, **rates)
    _, _, warm = _cold_warm(lambda: jax.block_until_ready(run_lattice_gas_k(
        config, params, jax.random.PRNGKey(1), T=T, obs_dt=obs_dt, dt=dt,
        n_tracers=config.N)))
    return 1e6 * warm / _n_steps(T, obs_dt, dt)


def phase_exclusion_sweep(T=20.0, obs_dt=0.5, T_short=5.0):
    """Flagship β-sweep at ``T`` (occupancy ≤ K, exact conservation), and
    per-β v_eff and |m| against the host-CPU run of the same seed at
    ``T_short`` (3 combined SE pooled over β, or bit-equal).  Also times
    the slot engine's step alone at B=1 and B=16."""
    with tempfile.TemporaryDirectory() as td:
        save, cold, warm = _cold_warm(
            lambda: _flagship_sweep(T, obs_dt, td, keep_outs=True))
        occ_max = _occupancy_checks(save)
        short = lambda: _flagship_sweep(T_short, obs_dt, td, do_fit=False)
        g = short()
        c = _on_cpu(short)
    ok_v, z_v, eq_v = _pooled_agree(g["means"], g["ses"], c["means"],
                                    c["ses"])
    ok_m, z_m, eq_m = _pooled_agree(g["m_means"], g["m_ses"], c["m_means"],
                                    c["m_ses"])
    assert ok_v and ok_m, (z_v, z_m)
    _report("exclusion_sweep", cold, warm, dict(
        T=T, replicas=33, max_site_occupancy=occ_max, conserved=True,
        v_eff=[round(float(v), 5) for v in save["means"]],
        cpu_T=T_short, cpu_v_z=z_v, cpu_m_z=z_m,
        cpu_v_equal=eq_v, cpu_m_equal=eq_m,
        slot_step_us={f"B{b}": _slot_step_us(b) for b in (1, 16)}))
    return save


def _pde_single(T, outdir):
    """The reference single run (IMEX_PDE_solver_run.py:7-34) through the
    ``IMEXPDE`` facade; returns its output dict."""
    from hydrolim_tpu import IMEXPDE

    pde = IMEXPDE(L=1000, T=T, dt=5e-4, gamma=0.0, lam=0.6, beta=2.0,
                  bc="periodic", active_model="bidirectional",
                  gaussian_kernel=True, kernel_sigma=0.005,
                  snapshot_interval=50, outdir=outdir, seed=58)
    pde.initialize(mode="homogeneous", rho0=1.0, noise=0.3, n_tracers=1000)
    pde.solve()
    return pde.get_output()


def phase_pde_single(T=20.0, T_short=1.0):
    """40,000-step solve (mass conservation over the whole run) and ρ±
    against the host-CPU solve after ``T_short / dt`` = 2,000 steps."""
    with tempfile.TemporaryDirectory() as td:
        out, cold, warm = _cold_warm(lambda: _pde_single(T, td))
        g = _pde_single(T_short, td)
        c = _on_cpu(lambda: _pde_single(T_short, td))
    snaps = out["snapshots"]
    mass0 = float(np.sum(snaps[0], dtype=np.float64))
    mass1 = float(np.sum(out["rho_p"] + out["rho_m"], dtype=np.float64))
    drift = abs(mass1 - mass0) / mass0
    assert drift <= 1e-4, drift
    assert np.all(np.isfinite(out["m_series"]))
    rel = max(float(np.max(np.abs(g[k] - c[k])) / np.max(np.abs(c[k])))
              for k in ("rho_p", "rho_m"))
    assert rel <= PDE_FIELD_RTOL, rel
    _report("pde_single", cold, warm, dict(
        steps=int(round(T / 5e-4)), tracers=1000,
        us_per_step=1e6 * warm / round(T / 5e-4), mass_drift=drift,
        cpu_steps=int(round(T_short / 5e-4)), cpu_field_max_rel=rel,
        cpu_field_rtol=PDE_FIELD_RTOL))


def phase_pde_sweep(T=40.0, T_short=1.0):
    """``pde_beta_sweep`` (11 β × 3 runs, L=1000, dt=5e-4, 1000 tracers,
    IMEX_PDE_solver_run_sweep.py:19-40) at ``T``; per-β v_eff and D_eff
    against the host-CPU run at ``T_short`` (3 combined SE pooled over β,
    or bit-equal)."""
    from hydrolim_tpu.sweeps.pde_sweeps import pde_beta_sweep

    def sweep(T_):
        return pde_beta_sweep(n_runs=3, T=T_, t_min=T_ / 2, t_max=T_,
                              plot_result=False)

    res, cold, warm = _cold_warm(lambda: sweep(T))
    assert np.all(np.isfinite(res["v_mean"])) and np.all(
        np.isfinite(res["D_mean"]))
    g = sweep(T_short)
    c = _on_cpu(lambda: sweep(T_short))
    ok_v, z_v, eq_v = _pooled_agree(g["v_mean"], g["v_err"], c["v_mean"],
                                    c["v_err"])
    ok_d, z_d, eq_d = _pooled_agree(g["D_mean"], g["D_err"], c["D_mean"],
                                    c["D_err"])
    assert ok_v and ok_d, (z_v, z_d)
    _report("pde_sweep", cold, warm, dict(
        replicas=33, steps=int(round(T / 5e-4)),
        us_per_step=1e6 * warm / round(T / 5e-4),
        v_eff=[float(f"{v:.4g}") for v in res["v_mean"]],
        D_eff=[float(f"{v:.4g}") for v in res["D_mean"]],
        cpu_T=T_short, cpu_v_z=z_v, cpu_D_z=z_d,
        cpu_v_equal=eq_v, cpu_D_equal=eq_d))


def phase_resume(straight, T=20.0, obs_dt=0.5, chunk_frames=10):
    """The flagship sweep with ``ckpt_dir=``, halted after one chunk
    (``stop_after_chunks=1``) and resumed: bit-identical to ``straight``,
    the uninterrupted run of the same sweep."""
    with tempfile.TemporaryDirectory() as td:
        ck = os.path.join(td, "ckpt")
        t0 = time.perf_counter()
        halted = _flagship_sweep(T, obs_dt, td, ckpt_dir=ck,
                                 chunk_frames=chunk_frames,
                                 stop_after_chunks=1)
        cold = time.perf_counter() - t0
        assert halted is None, "the halted sweep returned a result"
        t0 = time.perf_counter()
        resumed = _flagship_sweep(T, obs_dt, td, ckpt_dir=ck,
                                  chunk_frames=chunk_frames)
        warm = time.perf_counter() - t0
    for key in ("means", "m_means", "D_means", "rho_means", "block_means"):
        assert np.array_equal(resumed[key], straight[key]), key
    _report("resume", cold, warm, dict(
        chunk_frames=chunk_frames, halted_after_chunks=1, bit_identical=True))


def phase_precision():
    """No float matmul of the particle, slot or PDE engine may run below
    full f32 (TF32) with ``jax.default_matmul_precision`` at its default:
    every ``dot_general`` in their programs must ask for HIGHEST."""
    import jax

    from hydrolim_tpu.core.config import PDEConfig, make_pde_params
    from hydrolim_tpu.pde.init import pde_initialize
    from hydrolim_tpu.pde.stepper import build_pde_ops, pde_solve
    from hydrolim_tpu.particles.lattice_gas_k import run_lattice_gas_k
    from hydrolim_tpu.sweeps.beta_sweep import config_from_kwargs
    from hydrolim_tpu.sweeps.ensemble import (
        broadcast_params,
        run_particle_ensemble,
    )
    from hydrolim_tpu.core.config import ParticleConfig
    from hydrolim_tpu.utils.debug import matmuls_below_highest

    assert jax.config.jax_default_matmul_precision is None
    t0 = time.perf_counter()
    key = jax.random.PRNGKey(0)
    flag = config_from_kwargs(FLAGSHIP_PS)
    pf = broadcast_params(flag, beta=[0.5, 2.0], rate_diffusion=0.0,
                          rate_active=5.0)
    bad = matmuls_below_highest(
        lambda k: run_lattice_gas_k(flag, pf, k, T=1.0, obs_dt=0.5, dt=0.01,
                                    n_tracers=8), key)
    mf = ParticleConfig(L=1000, N=1000, n_pad=1000, init="fixed",
                        scale_rates=False, local_kernel_sigma=0.0,
                        periodic=True, site_capacity=None,
                        active_model="bidirectional")
    pm = broadcast_params(mf, beta=[0.5, 2.0], rate_diffusion=0.5,
                          rate_active=2.0)
    bad += matmuls_below_highest(
        lambda k: run_particle_ensemble(mf, pm, k, T=1.0, obs_dt=0.5,
                                        dt=0.01, record_pos=False), key)
    for sigma, gamma in ((0.005, 0.0), (1e5 - 10, 0.2), (0.05, 0.2)):
        pc = PDEConfig(L=1000, T=0.01, dt=5e-4, gaussian_kernel=True,
                       kernel_sigma=sigma, snapshot_interval=10,
                       n_tracers=16, fft_kmax=8)
        pp = make_pde_params(gamma=gamma, lam=0.6, beta=2.0)
        ops = build_pde_ops(pc, pp)
        rp, rm, tr = pde_initialize(pc, key, mode="homogeneous", noise=0.3,
                                    n_tracers=16)
        bad += matmuls_below_highest(
            lambda k: pde_solve(pc, pp, ops, rp, rm, tr, k), key)
    assert not bad, bad
    wall = time.perf_counter() - t0
    _report("precision", wall, wall, dict(matmuls_below_highest=0))


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def phase_multi_gpu(n=4, L=65536, pde_steps=1500):
    """``run_large_lattice``'s path at L=65,536 over a ``space_mesh(n)``
    against one card (exact particle conservation, identical trajectories
    and m(β); PDE fields within ``PDE_FIELD_RTOL``), and the flagship sweep with
    ``n_devices=n`` against ``n_devices=1`` (per-replica m series identical
    up to ``MESH_RTOL``)."""
    import jax

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "experiments"))
    from run_large_lattice import run_particle, run_pde

    from hydrolim_tpu.parallel.spatial import space_mesh, space_sharding

    assert jax.device_count() >= n, jax.device_count()
    rel = lambda a, b: float(np.max(np.abs(np.asarray(a, np.float64)
                                           - np.asarray(b, np.float64)))
                             / max(np.max(np.abs(b)), 1e-30))
    def lattice_run(k):
        mesh = space_mesh(k)
        frames, occ, _ = run_particle(L, space_sharding(mesh))
        return (frames, occ) + run_pde(L, mesh, pde_steps)[:3]

    def sweep_run(k, td):
        return _flagship_sweep(20.0, 0.5, td, n_devices=k, keep_outs=True,
                               do_fit=False)

    with tempfile.TemporaryDirectory() as td:
        (lat_n, sw_n), cold, warm = _cold_warm(
            lambda: (lattice_run(n), sweep_run(n, td)))
        t0 = time.perf_counter()
        lat_1, sw_1 = lattice_run(1), sweep_run(1, td)
        wall_1 = time.perf_counter() - t0
    (f4, o4, m4, r4, mass4), (f1, o1, m1, r1, _) = lat_n, lat_1
    conserved = all(np.all(np.abs(o).reshape(2, -1).sum(-1) == L // 2)
                    for o in (o4, o1))
    pde_rel = max(max(rel(m4[b], m1[b]), rel(r4[b], r1[b])) for b in m4)
    drift = max(abs(ms[-1] - ms[0]) / ms[0] for ms in mass4.values())
    keys = ("m_global", "total_list", "m_local_list")
    per_rep = lambda s, key: np.stack(
        [np.asarray(o[key]) for outs in s["outs"] for o in outs])
    sweep_eq = all(np.array_equal(per_rep(sw_n, k), per_rep(sw_1, k))
                   for k in keys)
    sweep_rel = max(rel(per_rep(sw_n, k), per_rep(sw_1, k)) for k in keys)
    checks = dict(
        cards=n, L=L, particles_conserved=bool(conserved),
        lattice_trajectory_equal=bool(np.array_equal(o4, o1)),
        m_equal=bool(np.array_equal(f4.m_global, f1.m_global)),
        pde_max_rel=pde_rel, pde_field_rtol=PDE_FIELD_RTOL,
        pde_mass_drift=float(drift), sweep_bit_equal=sweep_eq,
        sweep_max_rel=sweep_rel, mesh_rtol=MESH_RTOL,
        one_card_wall_s=round(wall_1, 3))
    # report before asserting: a four-card run is the costly one to repeat
    _report("multi_gpu", cold, warm, checks)
    assert checks["particles_conserved"] and checks["m_equal"], checks
    assert checks["lattice_trajectory_equal"], checks
    assert pde_rel <= PDE_FIELD_RTOL and drift <= 1e-4, checks
    assert sweep_rel <= MESH_RTOL, checks


def select_phases(multi_gpu: bool):
    """Phase names in run order: the sharded phase alone with
    ``--multi-gpu``, every single-card phase otherwise."""
    if multi_gpu:
        return ["multi_gpu"]
    return ["precision", "meanfield", "exclusion_sweep", "resume",
            "pde_single", "pde_sweep"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi-gpu", action="store_true",
                    help="run only the sharded paths, on 4 cards")
    args = ap.parse_args(argv)
    devices = _device_or_exit()

    import jax

    from hydrolim_tpu.utils.profiling import card_name_and_power

    print(card_name_and_power(), flush=True)
    print(f"jax {jax.__version__}", flush=True)
    print(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')}", flush=True)
    phases = dict(precision=phase_precision, meanfield=phase_meanfield,
                  pde_single=phase_pde_single, pde_sweep=phase_pde_sweep,
                  multi_gpu=phase_multi_gpu)
    straight = None
    for name in select_phases(args.multi_gpu):
        if name == "exclusion_sweep":
            straight = phase_exclusion_sweep()
        elif name == "resume":       # against the straight sweep's result
            phase_resume(straight)
        else:
            phases[name]()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
