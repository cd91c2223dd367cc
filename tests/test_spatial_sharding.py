"""Lattice-axis spatial sharding: the site-centric engines
run with L sharded 8-way on the virtual CPU mesh, produce observables
identical to the unsharded run, and the compiled step exchanges halos via
collective-permute (no all-gather on the hot path)."""
import numpy as np
import jax
import pytest

from hydrolim_tpu.core.config import ParticleConfig, make_particle_params
from hydrolim_tpu.fields.magnetization import build_mfield_op
from hydrolim_tpu.parallel.spatial import space_mesh, space_sharding
from hydrolim_tpu.particles.lattice_gas import lg_step, run_lattice_gas
from hydrolim_tpu.particles.lattice_gas_k import run_lattice_gas_k
from hydrolim_tpu.sweeps.ensemble import broadcast_params


def _cpu_count():
    try:
        return len(jax.devices("cpu"))
    except RuntimeError:
        return 0


pytestmark = pytest.mark.skipif(_cpu_count() < 8,
                                reason="needs 8 virtual CPU devices")


def _assert_frames_match(base, shard):
    """Bit-identical everywhere except the float lattice-axis REDUCTIONS —
    the matmul-DFT spectrum and the density variance — whose f32 summation
    association legitimately depends on the shard shape (ROADMAP
    'bitwise-identical FLOAT records under resharding').  Integer-count
    sums (m_global, rho normalizations) are exact in any order."""
    for name, a, b in zip(base._fields, base, shard):
        a, b = np.asarray(a), np.asarray(b)
        if name == "fft_amp":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)
        elif name == "var":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_lattice_gas_space_sharded_matches_unsharded():
    config = ParticleConfig(L=256, N=128, init="fixed", scale_rates=False,
                            local_kernel_sigma=0.0, periodic=True,
                            site_capacity=1, active_model="plus_forward")
    params = broadcast_params(config, beta=[1.0, 2.0], rate_diffusion=1.0,
                              rate_active=2.0)
    kw = dict(T=1.0, obs_dt=0.25, dt=5e-3, n_tracers=8)
    base_f, base_o = jax.device_get(run_lattice_gas(
        config, params, jax.random.PRNGKey(0), **kw))
    mesh = space_mesh(8, devices=jax.devices("cpu"))
    shard_f, shard_o = jax.device_get(run_lattice_gas(
        config, params, jax.random.PRNGKey(0), **kw,
        occ_sharding=space_sharding(mesh)))
    _assert_frames_match(base_f, shard_f)
    np.testing.assert_array_equal(np.asarray(base_o), np.asarray(shard_o))


def test_lattice_gas_k_space_sharded_matches_unsharded():
    config = ParticleConfig(L=256, N=192, init="fixed", scale_rates=False,
                            local_kernel_sigma=0.0, periodic=True,
                            site_capacity=3, active_model="plus_forward")
    params = broadcast_params(config, beta=[1.5], rate_diffusion=0.5,
                              rate_active=3.0, n_runs=2)
    kw = dict(T=1.0, obs_dt=0.25, dt=2e-3)
    base_f, base_o = jax.device_get(run_lattice_gas_k(
        config, params, jax.random.PRNGKey(1), **kw))
    mesh = space_mesh(8, devices=jax.devices("cpu"))
    shard_f, shard_o = jax.device_get(run_lattice_gas_k(
        config, params, jax.random.PRNGKey(1), **kw,
        occ_sharding=space_sharding(mesh, slots=True)))
    _assert_frames_match(base_f, shard_f)
    np.testing.assert_array_equal(np.asarray(base_o), np.asarray(shard_o))


def test_grid_mesh_sweep_x_space_matches_unsharded():
    """2-D composition: replica DP ('sweep') × lattice sharding ('space')
    on one (2, 4) grid_mesh — both site-centric engines, trajectories
    bit-identical to the unsharded run (grid_sharding docstring
    contract)."""
    from hydrolim_tpu.parallel.spatial import grid_mesh, grid_sharding

    mesh = grid_mesh(2, 4, devices=jax.devices("cpu"))
    kw = dict(T=1.0, obs_dt=0.25, dt=5e-3)

    config = ParticleConfig(L=256, N=128, init="fixed", scale_rates=False,
                            local_kernel_sigma=0.0, periodic=True,
                            site_capacity=1, active_model="bidirectional")
    params = broadcast_params(config, beta=[0.5, 2.0], rate_diffusion=0.3,
                              rate_active=1.0, n_runs=2)      # B=4 = 2·2
    base_f, base_o = jax.device_get(run_lattice_gas(
        config, params, jax.random.PRNGKey(2), **kw, n_tracers=8))
    grid_f, grid_o = jax.device_get(run_lattice_gas(
        config, params, jax.random.PRNGKey(2), **kw, n_tracers=8,
        occ_sharding=grid_sharding(mesh)))
    _assert_frames_match(base_f, grid_f)
    np.testing.assert_array_equal(np.asarray(base_o), np.asarray(grid_o))

    config_k = ParticleConfig(L=256, N=300, init="fixed", scale_rates=False,
                              local_kernel_sigma=0.0, periodic=True,
                              site_capacity=3, active_model="bidirectional")
    params_k = broadcast_params(config_k, beta=[0.5, 2.0], rate_diffusion=0.3,
                                rate_active=1.0, n_runs=2)
    base_f, base_s = jax.device_get(run_lattice_gas_k(
        config_k, params_k, jax.random.PRNGKey(3), **kw))
    grid_f, grid_s = jax.device_get(run_lattice_gas_k(
        config_k, params_k, jax.random.PRNGKey(3), **kw,
        occ_sharding=grid_sharding(mesh, slots=True)))
    _assert_frames_match(base_f, grid_f)
    np.testing.assert_array_equal(np.asarray(base_s), np.asarray(grid_s))


def test_sharded_step_uses_halo_exchange_not_gather():
    """The ±1-site stencils must lower to collective-permute halo exchanges;
    an all-gather would mean the lattice is materialized per device and the
    'sharding' is fake."""
    config = ParticleConfig(L=256, N=128, init="fixed", scale_rates=False,
                            local_kernel_sigma=0.0, periodic=True,
                            site_capacity=1, active_model="plus_forward")
    params = make_particle_params(config, beta=1.0, rate_diffusion=1.0,
                                  rate_active=2.0)
    op = build_mfield_op(config.L, config.dx, 0.0, True)
    mesh = space_mesh(8, devices=jax.devices("cpu"))
    occ = jax.device_put(jax.numpy.zeros((256,), jax.numpy.int32),
                         space_sharding(mesh, batched=False))
    f = jax.jit(lambda o, k: lg_step(config, params, op, o, k, 5e-3)[0])
    txt = f.lower(occ, jax.random.PRNGKey(0)).compile().as_text()
    assert txt.count("collective-permute") > 0
    assert txt.count("all-gather") == 0
