"""Large-lattice spatial-sharding run — science, not just a sharding test
(capability rows SURVEY.md §2.5 "spatial/sequence parallelism" and §5
"long-context").

Both engines at L far past the reference's 1000 sites, with the lattice
axis sharded over a 'space' device mesh (parallel/spatial.py — the ±1-site
stencils lower to halo exchanges, the global reductions to all-reduces;
tests/test_spatial_sharding.py pins the HLO):

- K = 1 site-centric lattice gas at L = 65536, N = L/2, two β
  (sub-/super-critical) — physics sanity: exact particle-number
  conservation on the final occupancy and m(β) against the tanh fixed
  point,
- IMEX PDE at the same L with the BANDED implicit solve
  (diffusion_solver='banded': the O(L·W) scale path; the dense/DFT solves
  are O(L²) and unshardable) — mass conservation and m(β).

Outputs one overview figure (coarse-grained profiles + m(t) for both
engines) and ``wall_time.json`` with per-engine wall-clock and aggregate
site-update throughput.

The mesh takes ``--n-devices`` devices of the default platform (default:
all of them) and fails when there are fewer.  On a CPU-only host, run with
``JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8``
for a virtual mesh; its wall times share one host's cores and are not a
scaling claim.

Usage: python experiments/run_large_lattice.py [--small] [--n-devices N]
       [--outdir DIR] [--seed N]
"""
import argparse
import json
import os as _os
import sys as _sys
import time

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))


def _parse():
    p = argparse.ArgumentParser()
    p.add_argument("--outdir", default="large_lattice_out")
    p.add_argument("--small", action="store_true",
                   help="L=4096 quick CPU smoke")
    p.add_argument("--n-devices", type=int, default=None,
                   help="devices of the 'space' mesh (default: all)")
    p.add_argument("--grid", action="store_true",
                   help="2-D mesh for the particle run: the two β replicas "
                        "ride a 'sweep' axis of 2 while 'space' shards the "
                        "lattice over n_devices/2 (parallel.spatial."
                        "grid_mesh) — replica DP composed with spatial "
                        "sharding; physics identical")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args()


BETAS = (0.5, 2.5)        # sub- and super-critical


def run_particle(L: int, shard, seed: int = 0):
    """K=1 lattice gas, N = L/2, global m, two β replicas, with the
    (B, L) occupancy placed by ``shard``.  Returns (frames, occ, n_steps)
    on the host; ``occ`` is the final occupancy."""
    import jax
    import numpy as np

    from hydrolim_tpu.core.config import ParticleConfig
    from hydrolim_tpu.particles.lattice_gas import run_lattice_gas
    from hydrolim_tpu.particles.run import substeps_for
    from hydrolim_tpu.sweeps.ensemble import broadcast_params, ensemble_dt

    # T = 4: the ordered branch needs ~2 time units to grow out of the
    # 1/sqrt(N) initial fluctuation and saturate at m_beta
    T, obs_dt = 4.0, 0.5
    betas = np.asarray(BETAS, np.float32)
    config = ParticleConfig(L=L, xlim=1, N=L // 2, init="fixed",
                            scale_rates=False, local_kernel_sigma=0.0,
                            periodic=True, site_capacity=1,
                            active_model="bidirectional")
    rd, ra = 0.5, 2.0
    params = broadcast_params(config, beta=betas, rate_diffusion=rd,
                              rate_active=ra)
    dt = ensemble_dt(config, beta_max=float(betas.max()), rate_diffusion=rd,
                     rate_active=ra)
    frames, occ = jax.device_get(run_lattice_gas(
        config, params, jax.random.PRNGKey(seed), T=T, obs_dt=obs_dt, dt=dt,
        record_fft=False, occ_sharding=shard))
    # the engine's own substep rule (ceil), not a re-derived round()
    n_steps = substeps_for(obs_dt, dt) * (len(np.arange(0.0, T, obs_dt)) - 1)
    return frames, occ, n_steps


def run_pde(L: int, mesh, nsteps: int, seed: int = 0):
    """IMEX PDE at lattice size L with the banded implicit solve, the
    lattice axis sharded over ``mesh``'s 'space' axis, one run per β.
    Returns ({β: m series}, {β: final ρ}, {β: mass series}, dt) on the
    host; m and mass are recorded every ``nsteps // 100`` steps.

    Large-L scaling: the explicit upwind advection sets dt = 0.5·dx/λ
    (CFL), and γ is then chosen so c = γ·dt/dx² = 2.5 keeps the banded
    inverse kernel narrow (ops/diffusion.py) — dt and γ scale with dx;
    the lattice-level diffusion rate γ/dx² stays O(c/dt)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hydrolim_tpu.core.config import PDEConfig, make_pde_params
    from hydrolim_tpu.parallel.spatial import space_sharding
    from hydrolim_tpu.pde.stepper import build_pde_ops, magnetization, pde_step

    lam = 0.6
    dx = 1.0 / L
    dt_pde = 0.5 * dx / lam
    gamma = 2.5 * dx * dx / dt_pde
    pcfg = PDEConfig(L=L, T=nsteps * dt_pde, dt=dt_pde, bc="periodic",
                     gaussian_kernel=False, diffusion_solver="banded",
                     snapshot_interval=max(nsteps // 4, 1), n_tracers=1)
    rec_every = max(nsteps // 100, 1)
    field_shard = space_sharding(mesh, batched=False)      # (L,): P('space')
    m_series, rho_fin, mass = {}, {}, {}
    for bi, beta in enumerate(BETAS):
        pparams = make_pde_params(gamma=gamma, lam=lam, beta=float(beta))
        ops = build_pde_ops(pcfg, pparams)
        rng = np.random.default_rng(seed + bi)
        # small noise: the CW-rate check assumes near-uniform m(x)
        rho0 = np.clip(1.0 + 0.05 * rng.standard_normal((2, L)), 0.0, None)
        rho0 = rho0 / rho0.sum() * L        # mean total density ~1
        # seed a magnetization imbalance so the supercritical branch orders
        rho_p = jax.device_put(jnp.asarray(1.2 * rho0[0], jnp.float32),
                               field_shard)
        rho_m = jax.device_put(jnp.asarray(0.8 * rho0[1], jnp.float32),
                               field_shard)

        @jax.jit
        def advance(rp, rm):
            def body(c, _):
                rp, rm = pde_step(pcfg, pparams, ops, c[0], c[1])
                return (rp, rm), ()

            def outer(c, _):
                c, _ = jax.lax.scan(body, c, None, length=rec_every)
                m = magnetization(pcfg, ops, c[0], c[1])
                return c, (jnp.mean(m), jnp.sum(c[0] + c[1]))

            (rp, rm), (m_t, mass_t) = jax.lax.scan(
                outer, (rp, rm), None, length=nsteps // rec_every)
            return rp, rm, m_t, mass_t

        rp, rm, m_t, mass_t = jax.device_get(advance(rho_p, rho_m))
        m_series[beta] = np.asarray(m_t)
        rho_fin[beta] = np.asarray(rp + rm)
        mass[beta] = np.asarray(mass_t)
    return m_series, rho_fin, mass, dt_pde


def main():
    a = _parse()

    import jax
    import numpy as np

    from hydrolim_tpu.parallel.spatial import (
        grid_mesh,
        grid_sharding,
        space_mesh,
        space_sharding,
    )
    from hydrolim_tpu.theory.meanfield import m_fixed_point

    if a.n_devices is None:
        a.n_devices = jax.device_count()
    L = 4096 if a.small else 65536
    N = L // 2
    T, obs_dt = 4.0, 0.5
    betas = np.asarray(BETAS, np.float32)
    _os.makedirs(a.outdir, exist_ok=True)
    record = {"L": L, "N": N, "n_devices": a.n_devices,
              "particle_mesh": "2d-grid" if a.grid else "1d-space"}

    mesh = space_mesh(a.n_devices)
    n_dev = mesh.devices.size
    axes = "'space' axis"
    if a.grid:
        pmesh = grid_mesh(2, max(a.n_devices // 2, 1))
        axes = f"(2 'sweep' x {pmesh.devices.shape[1]} 'space') grid"
    print(f"# mesh: {n_dev} x {mesh.devices.flat[0].platform} "
          f"({axes}), L={L}")

    # ---- particle engine: K=1 lattice gas, global m -----------------------
    shard = grid_sharding(pmesh) if a.grid else space_sharding(mesh)
    t0 = time.time()
    frames, occ, n_steps = run_particle(L, shard, seed=a.seed)
    wall_p = time.time() - t0
    record["particle"] = {
        "wall_s": wall_p, "steps": n_steps,
        "site_updates_per_s": 2 * L * n_steps / wall_p,
    }
    print(f"# lattice gas: {wall_p:.1f} s for {n_steps} steps x 2 replicas "
          f"({record['particle']['site_updates_per_s']:.3e} site-updates/s)")

    # physics sanity — exact conservation + CW magnetization law
    n_final = np.abs(np.asarray(occ)).reshape(2, -1).sum(-1)
    assert np.all(n_final == N), ("particle number not conserved", n_final)
    m_traj = np.abs(np.asarray(frames.m_global))           # (2, M)
    m_lo, m_hi = m_traj[0, -1], m_traj[1, -1]
    m_th = m_fixed_point(float(betas[1]))
    assert m_lo < 0.1, ("sub-critical |m| should stay small", m_lo)
    assert abs(m_hi - m_th) < 0.05, ("super-critical m off theory",
                                     m_hi, m_th)
    record["particle"].update(m_sub=float(m_lo), m_super=float(m_hi),
                              m_theory=float(m_th))

    # ---- PDE engine: banded implicit solve, pointwise m -------------------
    nsteps = 300 if a.small else 1500
    rec_every = max(nsteps // 100, 1)
    t0 = time.time()
    m_series, rho_fin, mass, dt_pde = run_pde(L, mesh, nsteps, seed=a.seed)
    wall_pde = time.time() - t0
    for beta in BETAS:
        ms = mass[beta]
        assert abs(ms[-1] - ms[0]) / ms[0] < 1e-4, (
            "PDE mass not conserved", ms[0], ms[-1])
    record["pde"] = {"wall_s": wall_pde, "dt": dt_pde,
                     "steps": 2 * nsteps,
                     "site_updates_per_s": 2 * L * nsteps / wall_pde}
    print(f"# pde (banded): {wall_pde:.1f} s for {nsteps} steps x 2 betas "
          f"({record['pde']['site_updates_per_s']:.3e} site-updates/s)")

    # physics sanity: the advection-CFL dt gives ~0.02 physical time units
    # — not enough to saturate m, but plenty to pin dm/dt against the CW
    # reaction law dm/dt = 2(sinh(βm) − m·cosh(βm)) (uniform-field limit;
    # the β=0.5 branch decays toward 0, the β=2.5 branch grows toward m_β)
    T_pde = nsteps * dt_pde
    record["pde"]["rates"] = {}
    for beta in BETAS:
        ms = m_series[beta]
        rate_meas = float((ms[-1] - ms[0]) / (T_pde - rec_every * dt_pde))
        m_mid = 0.5 * float(ms[0] + ms[-1])
        rate_th = 2.0 * (np.sinh(beta * m_mid) - m_mid * np.cosh(beta * m_mid))
        assert abs(rate_meas - rate_th) < 0.15 * abs(rate_th) + 1e-3, (
            "PDE m-drift off the CW reaction law", float(beta), rate_meas,
            rate_th)
        record["pde"]["rates"][f"beta={beta:g}"] = {
            "measured": rate_meas, "theory": float(rate_th)}
    assert m_series[BETAS[0]][-1] < m_series[BETAS[0]][0], \
        "sub-critical m must decay"
    assert m_series[BETAS[1]][-1] > m_series[BETAS[1]][0], \
        "super-critical m must grow"

    # ---- figure ------------------------------------------------------------
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def coarse(x, nbins=1024):
        return np.asarray(x).reshape(nbins, -1).mean(-1)

    xs = np.linspace(0, 1, 1024, endpoint=False)
    fig, axes = plt.subplots(2, 2, figsize=(11, 7))
    times = np.arange(0.0, T, obs_dt)
    for bi, beta in enumerate(betas):
        axes[0, 0].plot(xs, coarse(frames.total[bi, -1]),
                        label=f"β={beta:g}", lw=0.8)
        axes[0, 1].plot(times, m_traj[bi], label=f"β={beta:g}")
        axes[1, 0].plot(xs, coarse(rho_fin[float(beta)]),
                        label=f"β={beta:g}", lw=0.8)
        tt = (np.arange(len(m_series[float(beta)])) + 1) * rec_every * dt_pde
        axes[1, 1].plot(tt, np.abs(m_series[float(beta)]),
                        label=f"β={beta:g}")
    axes[0, 1].axhline(m_th, ls="--", c="k", lw=0.8,
                       label=r"$m_\beta$ theory")
    axes[0, 0].set_title(f"lattice gas ρ(x, T), L={L}")
    axes[0, 1].set_title("lattice gas |m|(t)")
    axes[1, 0].set_title("PDE ρ(x, T) (banded solve)")
    axes[1, 1].set_title("PDE |m|(t)")
    for ax in axes.flat:
        ax.legend(fontsize=8)
    fig.suptitle(f"L={L} lattice sharded over {n_dev} devices ({axes})")
    fig.tight_layout()
    fig.savefig(_os.path.join(a.outdir, "large_lattice_overview.png"),
                dpi=120)

    with open(_os.path.join(a.outdir, "wall_time.json"), "w") as f:
        json.dump(record, f, indent=1)
    print("# wrote", _os.path.join(a.outdir, "large_lattice_overview.png"),
          "and wall_time.json")
    print(json.dumps({k: v for k, v in record.items() if k != "L"}))


if __name__ == "__main__":
    main()
