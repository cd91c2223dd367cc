"""Mesh-sharding correctness (SURVEY.md §4: 1-device vs n-device results).

Runs on the 8 virtual CPU devices from conftest's
``--xla_force_host_platform_device_count=8``.
"""
import numpy as np
import jax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from hydrolim_tpu.core.config import ParticleConfig
from hydrolim_tpu.parallel.mesh import make_mesh, shard_params, sweep_sharding
from hydrolim_tpu.sweeps.ensemble import broadcast_params, ensemble_dt, run_particle_ensemble


def _cpu_count():
    try:
        return len(jax.devices("cpu"))
    except RuntimeError:
        return 0


pytestmark = pytest.mark.skipif(_cpu_count() < 8,
                                reason="needs 8 virtual CPU devices")


def _ensemble(config, params, key, **kw):
    return jax.device_get(run_particle_ensemble(config, params, key, **kw))


def test_sharded_ensemble_matches_unsharded():
    config = ParticleConfig(L=64, N=128, n_pad=128, init="fixed",
                            scale_rates=False, local_kernel_sigma=0.0,
                            periodic=True, site_capacity=None,
                            active_model="bidirectional")
    betas = np.linspace(0.0, 3.0, 8)
    params = broadcast_params(config, beta=betas, rate_diffusion=0.5,
                              rate_active=2.0)
    dt = ensemble_dt(config, beta_max=3.0, rate_diffusion=0.5,
                     rate_active=2.0)
    key = jax.random.PRNGKey(0)
    kw = dict(T=1.0, obs_dt=0.25, dt=dt, record_pos=False)

    base = _ensemble(config, params, key, **kw)

    mesh = make_mesh(8, devices=jax.devices("cpu"))
    params_sh = shard_params(mesh, params)
    sharded = _ensemble(config, params_sh, key, **kw)

    np.testing.assert_array_equal(np.asarray(base.frames.m_global),
                                  np.asarray(sharded.frames.m_global))
    np.testing.assert_array_equal(np.asarray(base.frames.total),
                                  np.asarray(sharded.frames.total))


def test_mesh_factorization_and_fallback():
    mesh = make_mesh(8, devices=jax.devices("cpu"))
    assert mesh.devices.size == 8
    assert mesh.devices.shape in ((4, 2), (2, 4))
    mesh2 = make_mesh(6, devices=jax.devices("cpu"))
    assert mesh2.devices.shape in ((3, 2), (2, 3))


def test_pad_batch_prefix_stability():
    """The padding contract parallel.mesh relies on: key splits and bit
    draws are prefix-stable in the batch size."""
    key = jax.random.PRNGKey(7)
    np.testing.assert_array_equal(
        np.asarray(jax.random.split(key, 6)),
        np.asarray(jax.random.split(key, 8))[:6])
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(key, (6, 17), jnp_uint32())),
        np.asarray(jax.random.bits(key, (8, 17), jnp_uint32()))[:6])
    np.testing.assert_array_equal(
        np.asarray(jax.random.randint(key, (6,), 0, 1000)),
        np.asarray(jax.random.randint(key, (8,), 0, 1000))[:6])


def jnp_uint32():
    import jax.numpy as jnp

    return jnp.uint32


def _sweep_kwargs():
    ps_kwargs = dict(L=64, xlim=1, N=32, rate_diffusion=0.5, rate_active=2.0,
                     init="fixed", scale_rates=False, local_kernel_sigma=0.0,
                     periodic=True, site_capacity=1, minus_anchor=False,
                     anchor_positions=None, k_on=0, k_off=0, k_exit=0,
                     flip_rate_fn=None, crowding_suppresses_rates=False,
                     immobilize_when_anchored=True, anchor_radius=0.003)
    run_kwargs = dict(T=1.0, obs_dt=0.25, record_fft=True, record_var=True)
    return ps_kwargs, run_kwargs


def test_sweep_over_betas_n_devices_bit_equal(tmp_path):
    """the flagship sweep driver runs on an
    8-device mesh FROM THE PUBLIC API with observables matching the
    1-device run bit-for-bit (B=6 pads to 8 — exercises pad_batch)."""
    from hydrolim_tpu.sweeps.beta_sweep import sweep_over_betas

    betas = np.linspace(0.5, 2.5, 3)
    ps_kwargs, run_kwargs = _sweep_kwargs()
    common = dict(n_runs_per_beta=2, ps_kwargs=ps_kwargs,
                  run_kwargs=run_kwargs, seed=3, do_fit=False,
                  plot_result=False, engine="lattice_gas")
    a = sweep_over_betas(betas, npz_path=str(tmp_path / "a.npz"), **common)
    b = sweep_over_betas(betas, npz_path=str(tmp_path / "b.npz"),
                         n_devices=8, **common)
    for k in ("means", "D_means", "m_means", "rho_means", "block_means"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


def test_run_sweep_grid_particle_mesh_bit_equal():
    from hydrolim_tpu.sweeps.beta_sweep import run_sweep_grid

    betas = np.linspace(0.0, 3.0, 3)
    ps_kwargs, run_kwargs = _sweep_kwargs()
    _, base, _ = run_sweep_grid(betas, 2, ps_kwargs, None, run_kwargs,
                                seed=11)
    _, shard, _ = run_sweep_grid(betas, 2, ps_kwargs, None, run_kwargs,
                                 seed=11, n_devices=8)
    np.testing.assert_array_equal(np.asarray(base.frames.m_global),
                                  np.asarray(shard.frames.m_global))
    np.testing.assert_array_equal(np.asarray(base.frames.total),
                                  np.asarray(shard.frames.total))
    np.testing.assert_array_equal(np.asarray(base.frames.pos),
                                  np.asarray(shard.frames.pos))


def test_run_pde_ensemble_n_devices_bit_equal():
    from hydrolim_tpu.core.config import PDEConfig
    from hydrolim_tpu.sweeps.pde_sweeps import run_pde_ensemble

    config = PDEConfig(L=64, T=0.02, dt=1e-3, bc="periodic",
                       active_model="bidirectional", gaussian_kernel=True,
                       kernel_sigma=0.05, snapshot_interval=10,
                       n_tracers=8, fft_kmax=4)
    kw = dict(gamma=0.2, lam=0.6, n_runs=3, seed=5, n_tracers=8)
    a, _ = run_pde_ensemble(config, [0.5, 2.0], **kw)
    b, _ = run_pde_ensemble(config, [0.5, 2.0], n_devices=8, **kw)
    np.testing.assert_array_equal(np.asarray(a.records.m_mean),
                                  np.asarray(b.records.m_mean))
    np.testing.assert_array_equal(np.asarray(a.records.v_eff),
                                  np.asarray(b.records.v_eff))
    np.testing.assert_array_equal(np.asarray(a.rho_p), np.asarray(b.rho_p))


def test_double_sweep_fused_n_devices_close():
    """(N × β × runs) fused grid through the public n_devices= API: the
    blocking estimates of the sharded run match the 1-device run (bitwise
    here — the σ=0 global-m config has no record matmuls to reassociate)."""
    from hydrolim_tpu.sweeps.double_sweep import double_sweep_fused

    kw = dict(n_runs_per_beta=2,
              ps_kwargs=dict(L=64, local_kernel_sigma=0.0,
                             site_capacity=2, periodic=True,
                             rate_diffusion=0.5, rate_active=2.0,
                             minus_anchor=False),
              run_kwargs=dict(T=1.0, obs_dt=0.25), plot_result=False,
              chunk_size=8, seed=4)
    betas = np.linspace(0.5, 2.5, 3)
    Ns = np.array([24.0, 48.0])
    a = double_sweep_fused(betas, Ns, outdir="/tmp/ds_a", **kw)
    b = double_sweep_fused(betas, Ns, outdir="/tmp/ds_b", n_devices=8, **kw)
    for pa, pb in zip(a["per_N"], b["per_N"]):
        np.testing.assert_array_equal(np.asarray(pa["block_means"]),
                                      np.asarray(pb["block_means"]))


def test_graft_dryrun_multichip():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_graft_dryrun_multichip_driver_env():
    """The dryrun must pass in a fresh interpreter with NO XLA_FLAGS /
    JAX_PLATFORMS set — it has to provision its own virtual CPU devices and
    build its mesh from them, never from the default backend."""
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; sys.path.insert(0, %r); "
            "import __graft_entry__; __graft_entry__.dryrun_multichip(8); "
            "print('DRYRUN_OK')" % repo)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "DRYRUN_OK" in out.stdout


def test_misaligned_chunk_mesh_bit_equal(tmp_path):
    """Chunk boundaries (and the per-chunk fold_in keys) must not depend on
    the mesh size: with chunk_size not a multiple of n_devices and
    B > chunk_size, the sharded run pads within each chunk instead of
    rounding the stride up, so results stay bit-identical to 1-device."""
    from hydrolim_tpu.sweeps.beta_sweep import run_sweep_grid
    from hydrolim_tpu.sweeps.double_sweep import double_sweep_fused

    betas = np.linspace(0.0, 3.0, 3)
    ps_kwargs, run_kwargs = _sweep_kwargs()
    _, base, _ = run_sweep_grid(betas, 2, ps_kwargs, None, run_kwargs,
                                seed=7, chunk_size=5)
    _, shard, _ = run_sweep_grid(betas, 2, ps_kwargs, None, run_kwargs,
                                 seed=7, chunk_size=5, n_devices=8)
    np.testing.assert_array_equal(np.asarray(base.frames.m_global),
                                  np.asarray(shard.frames.m_global))
    np.testing.assert_array_equal(np.asarray(base.frames.total),
                                  np.asarray(shard.frames.total))

    kw = dict(n_runs_per_beta=2,
              ps_kwargs=dict(L=64, local_kernel_sigma=0.0,
                             site_capacity=2, periodic=True,
                             rate_diffusion=0.5, rate_active=2.0,
                             minus_anchor=False),
              run_kwargs=dict(T=1.0, obs_dt=0.25), plot_result=False,
              chunk_size=5, seed=4)
    Ns = np.array([24.0, 48.0])
    a = double_sweep_fused(betas, Ns, outdir=str(tmp_path / "a"), **kw)
    b = double_sweep_fused(betas, Ns, outdir=str(tmp_path / "b"),
                           n_devices=8, **kw)
    for pa, pb in zip(a["per_N"], b["per_N"]):
        np.testing.assert_array_equal(np.asarray(pa["block_means"]),
                                      np.asarray(pb["block_means"]))


def test_factor3_space_factor_divides_lattice():
    """dryrun mesh factorization: the 'space' factor must divide the dryrun
    lattice sizes (64/128) for EVERY device count — n=6 used to pick
    space=3 and crash device_put (regression, round-3 review)."""
    import __graft_entry__ as ge

    for n in (1, 2, 3, 4, 5, 6, 7, 8, 12, 16, 24):
        a, b, c = ge._factor3(n)
        assert a * b * c == n
        assert 64 % c == 0, (n, (a, b, c))
