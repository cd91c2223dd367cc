"""Throughput benchmark (BASELINE.json target) on one NVIDIA GPU.

Headline metric: particle-steps/sec at N=1e5 with a 64-point β-sweep
resident on one card (mean-field bench config: global magnetization,
bidirectional active hops, no exclusion — BASELINE.json configs 1/4), on
the XLA τ-leap path.  ``vs_baseline`` reports value / 1e9.

Secondary rows (``engines``): the K=3 exclusion flagship on the slot
engine, the K=1 lattice gas, IMEX PDE steps/sec (single and batched), the
full reference-scale PDE solve and the banded L=8192 PDE batch.  The
record names the device (platform, device_kind, count) and the card's
name and power limit.  A default platform other than the GPU gives an
error record: no row is ever timed on the CPU.
"""
import json
import os
import subprocess
import sys
import time

import jax

import hydrolim_tpu  # noqa: F401  (side effect: compile-cache config)
import jax.numpy as jnp
import numpy as np

from hydrolim_tpu.core.config import ParticleConfig
from hydrolim_tpu.particles.init import init_particles
from hydrolim_tpu.particles.stepper import build_static_arrays, step
from hydrolim_tpu.sweeps.ensemble import broadcast_params, ensemble_dt


#: timing windows per bench row: every row is measured as
#: ``_SAMPLES`` independent pipelined windows (each window = ``reps`` chained
#: dispatches, one sync), so the emitted record carries a spread and
#: diffs between runs can tell a regression from run-to-run variance.
_SAMPLES = int(os.environ.get("HYDROLIM_BENCH_SAMPLES", 3))


def bench_particle_steps(B=64, N=100_000, L=1000, K_steps=100, reps=5):
    config = ParticleConfig(
        L=L, N=N, n_pad=N, init="fixed", scale_rates=False,
        local_kernel_sigma=0.0, periodic=True, site_capacity=None,
        active_model="bidirectional")
    params = broadcast_params(config, beta=np.linspace(0.0, 3.0, B),
                              rate_diffusion=0.5, rate_active=2.0)
    dt = ensemble_dt(config, beta_max=3.0, rate_diffusion=0.5,
                     rate_active=2.0)
    statics = build_static_arrays(config)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    states = jax.jit(jax.vmap(lambda k: init_particles(config, k)))(keys)
    jax.block_until_ready(states.pos)

    @jax.jit
    def advance(params, states):
        def body(st, _):
            st = jax.vmap(
                lambda p, s: step(config, p, statics, s, dt,
                                  jnp.float32(0.0)))(params, st)
            return st, ()
        states, _ = jax.lax.scan(body, states, None, length=K_steps)
        return states

    states = advance(params, states)          # compile + warm
    jax.block_until_ready(states.pos)
    # pipelined sustained-throughput timing (see bench_k3_flagship)
    vals, walls = [], []
    for _ in range(_SAMPLES):
        t0 = time.perf_counter()
        for _ in range(reps):
            states = advance(params, states)
        jax.block_until_ready(states.pos)
        wall = (time.perf_counter() - t0) / reps
        vals.append(B * N * K_steps / wall)
        walls.append(wall)
    return vals, float(np.mean(walls))


def bench_pde_steps(L=1000, nsteps=2000, reps=3, B=1):
    """IMEX steps/sec; with B > 1 the batch advances together, so the
    aggregate replica-steps/sec shows the sweep-mode throughput."""
    from hydrolim_tpu.core.config import PDEConfig, make_pde_params
    from hydrolim_tpu.pde.stepper import build_pde_ops, pde_step

    config = PDEConfig(L=L, T=nsteps * 5e-4, dt=5e-4, bc="periodic",
                       gaussian_kernel=True, kernel_sigma=0.005)
    params = make_pde_params(gamma=0.2, lam=0.6, beta=2.0)
    ops = build_pde_ops(config, params)
    rng = np.random.default_rng(0)
    shape = (L,) if B == 1 else (B, L)
    p = jnp.asarray(rng.random(shape) / L, jnp.float32)
    m = jnp.asarray(rng.random(shape) / L, jnp.float32)

    @jax.jit
    def advance(p, m):
        def body(c, _):
            return pde_step(config, params, ops, c[0], c[1]), ()
        (p, m), _ = jax.lax.scan(body, (p, m), None, length=nsteps)
        return p, m

    p1, m1 = advance(p, m)
    jax.block_until_ready(p1)
    # pipelined sustained-throughput timing (see bench_k3_flagship)
    vals = []
    for _ in range(_SAMPLES):
        t0 = time.perf_counter()
        for _ in range(reps):
            p1, m1 = advance(p1, m1)
        jax.block_until_ready(p1)
        vals.append(nsteps / ((time.perf_counter() - t0) / reps))
    return vals


def bench_lattice_gas(B=64, L=1000, K_steps=500, reps=3):
    """Site-centric K=1 exclusion engine with full local-kernel smoothing."""
    from hydrolim_tpu.core.config import ParticleConfig
    from hydrolim_tpu.fields.magnetization import build_mfield_op
    from hydrolim_tpu.particles.lattice_gas import lg_init, lg_step
    from hydrolim_tpu.sweeps.ensemble import broadcast_params

    config = ParticleConfig(L=L, N=L // 2, init="fixed", scale_rates=False,
                            local_kernel_sigma=0.005, periodic=True,
                            site_capacity=1, active_model="plus_forward")
    params = broadcast_params(config, beta=np.linspace(0, 3, B),
                              rate_diffusion=0.02, rate_active=5.0)
    mf = build_mfield_op(L, config.dx, 0.005, True)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    occ = jax.jit(jax.vmap(lambda k: lg_init(config, k)))(keys)

    @jax.jit
    def advance(occ, key):
        def body(c, _):
            o, k = c
            k, sub = jax.random.split(k)
            subs = jax.random.split(sub, B)
            o, _aux = jax.vmap(
                lambda p, oo, kk: lg_step(config, p, mf, oo, kk, 4e-3))(
                    params, o, subs)
            return (o, k), ()
        (occ, key), _ = jax.lax.scan(body, (occ, key), None, length=K_steps)
        return occ, key

    key = jax.random.PRNGKey(1)
    occ, key = advance(occ, key)
    jax.block_until_ready(occ)
    # pipelined sustained-throughput timing (see bench_k3_flagship)
    vals = []
    for _ in range(_SAMPLES):
        t0 = time.perf_counter()
        for _ in range(reps):
            occ, key = advance(occ, key)
        jax.block_until_ready(occ)
        vals.append(B * (L // 2) * K_steps / ((time.perf_counter() - t0)
                                              / reps))
    return vals


def bench_k3_flagship(B=16, reps=2):
    """Reference flagship exclusion config (K=3, plus_forward, non-periodic,
    local kernel — PARTICLE_solver_BIOLOGY_EXCLUSION.py:55-94) on the
    site-centric slot engine.  Returns (single-replica, B-replica)
    particle-steps/sec."""
    from hydrolim_tpu.core.config import ParticleConfig
    from hydrolim_tpu.particles.lattice_gas_k import run_lattice_gas_k
    from hydrolim_tpu.sweeps.ensemble import broadcast_params

    config = ParticleConfig(L=1000, N=750, init="fixed", scale_rates=False,
                            local_kernel_sigma=0.002, periodic=False,
                            site_capacity=3, active_model="plus_forward",
                            minus_anchor=True)
    dt, T, obs_dt = 2e-3, 20.0, 0.5
    nsteps = int(T / dt)

    def run_once(nb):
        params = broadcast_params(config, beta=np.full(nb, 0.7),
                                  rate_diffusion=0.0, rate_active=5.0)
        f = lambda s: run_lattice_gas_k(config, params,
                                        jax.random.PRNGKey(s), T=T,
                                        obs_dt=obs_dt, dt=dt, n_tracers=64)
        _, slots = f(0)
        jax.block_until_ready(slots)
        # pipelined sustained-throughput timing: issue all reps without
        # intermediate blocking so host dispatch overlaps device compute
        vals, seed = [], 1
        for _ in range(_SAMPLES):
            t0 = time.perf_counter()
            outs = [f(seed + r) for r in range(reps)]
            seed += reps
            for _, slots in outs:
                jax.block_until_ready(slots)
            vals.append(nb * 750 * nsteps / ((time.perf_counter() - t0)
                                             / reps))
        return vals

    return run_once(1), run_once(B)


def bench_pde_banded_large_L(L=8192, nsteps=2000, B=4, reps=2):
    """Large-L PDE batch on the banded implicit solve (γ·dt/dx² O(1), dt
    scaled with dx): B replicas vmapped through ``pde_solve`` with records
    and 64 tracers.  Returns aggregate replica-steps/s samples."""
    from hydrolim_tpu.core.config import PDEConfig, PDEParams, make_pde_params
    from hydrolim_tpu.pde.init import pde_initialize
    from hydrolim_tpu.pde.stepper import build_pde_ops, pde_solve

    gamma, dt = 0.2, 2e-7
    config = PDEConfig(L=L, T=dt * nsteps, dt=dt, bc="periodic",
                       gaussian_kernel=False, snapshot_interval=nsteps // 4,
                       n_tracers=64, tracer_window_time=20 * dt, fft_kmax=8,
                       diffusion_solver="banded")
    params_b = PDEParams(gamma=jnp.full(B, gamma), lam=jnp.full(B, 0.6),
                         beta=jnp.linspace(0.5, 2.5, B))
    ops = build_pde_ops(config, make_pde_params(gamma=gamma, lam=0.6,
                                                beta=0.0))
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    init = jax.vmap(lambda k: pde_initialize(config, k, mode="homogeneous",
                                             noise=0.3, n_tracers=64))
    rp, rm, tr = init(keys)
    solve = jax.jit(jax.vmap(
        lambda p, a, b, t, k: pde_solve(config, p, ops, a, b, t, k)))
    run = lambda: solve(params_b, rp, rm, tr, keys)
    jax.block_until_ready(run().rho_p)
    vals = []
    for _ in range(min(2, _SAMPLES)):
        t0 = time.perf_counter()
        outs = [run() for _ in range(reps)]
        for o in outs:
            jax.block_until_ready(o.rho_p)
        vals.append(B * config.nsteps / ((time.perf_counter() - t0) / reps))
    return vals


def bench_pde_solve_full():
    """Full PDE solve at the reference single-run scale (L=1000, T=20,
    dt=5e-4, 1000 tracers, kernel σ=0.005 — IMEX_PDE_solver_run.py:7-34),
    including per-step records + tracer SDE.  Returns warm steps/sec."""
    from hydrolim_tpu import IMEXPDE

    pde = IMEXPDE(L=1000, T=20.0, dt=5e-4, gamma=0.0, lam=0.6, beta=2.0,
                  bc="periodic", gaussian_kernel=True, kernel_sigma=0.005,
                  seed=58)
    pde.initialize("poisson", noise=0.05, n_tracers=1000)
    pde.solve()                       # compile + warm
    vals, walls = [], []
    for _ in range(max(2, _SAMPLES - 1)):    # ~9.5 s per solve
        pde.initialize("poisson", noise=0.05, n_tracers=1000)
        t0 = time.perf_counter()
        pde.solve()
        dt_wall = time.perf_counter() - t0
        vals.append(pde.config.nsteps / dt_wall)
        walls.append(dt_wall)
    return vals, float(np.mean(walls))


def _emit(record):
    """The bench contract: exactly ONE JSON line on stdout, always."""
    print(json.dumps(record))


def _row(vals):
    """Engine record row: mean over the independent timing windows plus the
    relative peak-to-peak spread, so diffs between runs can tell a real
    regression from run-to-run variance."""
    vals = [float(v) for v in vals]
    v = float(np.mean(vals))
    spread = float((max(vals) - min(vals)) / v) if len(vals) > 1 and v else 0.0
    return {"value": v, "spread": round(spread, 4), "samples": len(vals)}


def _device_record() -> dict:
    from hydrolim_tpu.utils.profiling import card_name_and_power

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card_name_and_power()}


def main():
    device = _device_record()
    print(f"# device: {device}", file=sys.stderr)
    if device["platform"] != "gpu":
        _emit(_error_record("no GPU", device=device))
        return
    # per-engine record: {value, spread, samples} over _SAMPLES independent
    # pipelined timing windows (one sync after `reps` chained dispatches)
    engines = {}
    k3_1, k3_b = bench_k3_flagship()
    engines["k3_slot_single"] = _row(k3_1)
    engines["k3_slot_b16"] = _row(k3_b)
    print(f"# K=3 flagship (site-centric slot engine): "
          f"{np.mean(k3_1):.3e} particle-steps/sec single replica, "
          f"{np.mean(k3_b):.3e} at B=16", file=sys.stderr)
    pps_v, step_time = bench_particle_steps()
    engines["meanfield_xla"] = _row(pps_v)
    pps = float(np.mean(pps_v))
    print(f"# particle bench (XLA path): {pps:.3e} particle-steps/sec "
          f"(64x1e5 batch, {step_time * 1e3:.1f} ms / 100 steps)",
          file=sys.stderr)
    lg = bench_lattice_gas()
    engines["lattice_gas_k1"] = _row(lg)
    print(f"# lattice-gas bench (K=1 exclusion, local kernel): "
          f"{np.mean(lg):.3e} particle-equivalent steps/sec",
          file=sys.stderr)
    pde_sps = bench_pde_steps()
    engines["pde_imex_single"] = _row(pde_sps)
    print(f"# pde bench: {np.mean(pde_sps):.3e} IMEX steps/sec (L=1000)",
          file=sys.stderr)
    pde_sps_b = bench_pde_steps(B=32)
    engines["pde_imex_b32_aggregate"] = _row([32 * v for v in pde_sps_b])
    print(f"# pde bench (batched B=32): {32 * np.mean(pde_sps_b):.3e} "
          f"aggregate replica-steps/sec", file=sys.stderr)
    full_v, full_wall = bench_pde_solve_full()
    engines["pde_full_solve"] = _row(full_v)
    print(f"# pde full solve (reference single-run scale, records + "
          f"1000 tracers): {np.mean(full_v):.3e} steps/sec, "
          f"{full_wall:.1f} s wall for 40k steps", file=sys.stderr)
    bl = bench_pde_banded_large_L()
    engines["pde_banded_l8192_xla"] = _row(bl)
    print(f"# pde banded large-L (L=8192, B=4): {np.mean(bl):.3e} "
          f"aggregate replica-steps/sec", file=sys.stderr)
    _emit({
        "metric": "particle-steps/sec (N=1e5, 64-point beta sweep)",
        "value": pps,
        "unit": "particle-steps/s",
        "vs_baseline": pps / 1e9,
        "timing": "pipelined-mean",
        "samples_per_row": _SAMPLES,
        "device": device,
        "engines": engines,
    })


def _error_record(error: str, **extra):
    rec = {"error": error,
           "metric": "particle-steps/sec (N=1e5, 64-point beta sweep)",
           "value": None, "unit": "particle-steps/s", "vs_baseline": None,
           "timing": "pipelined-mean", "engines": {}}
    rec.update(extra)
    return rec


def _watchdog() -> None:
    """Run the bench body in a CHILD process under a hard deadline.

    A jax call that blocks inside backend C++ holds the GIL, so no
    in-process signal or timer can recover from a hung device.  The parent
    therefore does no jax work at all (it never initializes a backend, so
    the child has the card to itself): it re-execs this script with
    HYDROLIM_BENCH_CHILD=1, relays the child's one JSON line, and on a
    blown deadline kills the child and emits the error record itself."""
    deadline = float(os.environ.get("HYDROLIM_BENCH_DEADLINE", 1680.0))
    t0 = time.time()
    attempts = 0
    while True:
        attempts += 1
        env = dict(os.environ, HYDROLIM_BENCH_CHILD="1")
        if attempts > 1:
            # a signal death (SIGSEGV/SIGILL) can come from a bad
            # persistent-cache entry — retry once with the cache disabled
            # before giving up
            env["HYDROLIM_NO_COMPILATION_CACHE"] = "1"
        proc = subprocess.Popen(
            [sys.executable, "-u", os.path.abspath(__file__)],
            stdout=subprocess.PIPE, text=True, env=env)  # stderr: inherited
        timed_out = False
        try:
            out, _ = proc.communicate(timeout=deadline - (time.time() - t0))
        except subprocess.TimeoutExpired:
            timed_out = True
            proc.kill()
            out = proc.communicate()[0] or ""
        for line in reversed([l for l in out.splitlines() if l.strip()]):
            try:
                json.loads(line)
            except ValueError:
                continue
            print(line)
            return
        died_on_signal = (not timed_out and proc.returncode is not None
                          and proc.returncode < 0)
        if (died_on_signal and attempts == 1
                and time.time() - t0 < 0.5 * deadline):
            print(f"# bench child died on signal {-proc.returncode}; "
                  "retrying once with the compilation cache disabled",
                  file=sys.stderr)
            continue
        break
    if timed_out:
        _emit(_error_record(
            "bench timed out mid-run",
            detail=f"child still running at the {deadline:.0f} s deadline "
                   "— killed by the bench watchdog"))
    else:
        _emit(_error_record(
            "bench child died without a record",
            detail=f"child exited rc={proc.returncode} with no parseable "
                   f"JSON line on stdout (attempts={attempts})"))


if __name__ == "__main__":
    if (os.environ.get("HYDROLIM_BENCH_CHILD", "") != "1"
            and os.environ.get("HYDROLIM_BENCH_NO_WATCHDOG", "") != "1"):
        _watchdog()
        sys.exit(0)
    if (os.environ.get("HYDROLIM_BENCH_TEST_SIGNAL", "")
            and os.environ.get("HYDROLIM_NO_COMPILATION_CACHE", "") != "1"):
        # test hook for the watchdog: the first child (cache on) sends
        # itself this signal (SIGSEGV: the retry path; SIGSTOP: a hang);
        # the retry (cache off) proceeds normally
        os.kill(os.getpid(),
                int(os.environ["HYDROLIM_BENCH_TEST_SIGNAL"]))
    try:
        main()
    except Exception as exc:  # one parseable line, no matter what broke
        import traceback
        traceback.print_exc(file=sys.stderr)
        _emit(_error_record(f"{type(exc).__name__}: {exc}"))
        sys.exit(0)
