"""Nothing is rerouted behind the user's back: removed engine names raise
on every public surface, meshes never borrow devices from another
platform, the compile cache lands where it is told, ``chip_smoke.py``
refuses to run without a GPU, and no float matmul of the engines may run
in TF32."""
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import pytest

ROOT = pathlib.Path(__file__).parent.parent

_PARTICLE = dict(L=32, xlim=1, N=16, rate_diffusion=0.5, rate_active=2.0,
                 init="fixed", scale_rates=False, local_kernel_sigma=0.0,
                 periodic=True, site_capacity=1, k_on=0, k_off=0, k_exit=0)


def _particle_system(engine, tmp):
    from hydrolim_tpu import ParticleSystem

    return ParticleSystem(beta=1.0, rng=0, **_PARTICLE).run(
        T=0.2, obs_dt=0.1, engine=engine)


def _particle_system_ckpt(engine, tmp):
    from hydrolim_tpu import ParticleSystem

    return ParticleSystem(beta=1.0, rng=0, **_PARTICLE).run_checkpointed(
        T=0.2, obs_dt=0.1, ckpt_dir=tmp / "ck", engine=engine)


def _beta_sweep(engine, tmp):
    from hydrolim_tpu.sweeps.beta_sweep import sweep_over_betas

    return sweep_over_betas([0.5], 1, ps_kwargs=_PARTICLE,
                            run_kwargs=dict(T=0.2, obs_dt=0.1),
                            npz_path=str(tmp / "s.npz"), outdir=str(tmp),
                            do_fit=False, plot_result=False, engine=engine)


def _sigma_sweep(engine, tmp):
    from hydrolim_tpu.sweeps.sigma_sweep import sweep_over_sigmas

    return sweep_over_sigmas([0.0], [0.5], 1, ps_kwargs=_PARTICLE,
                             run_kwargs=dict(T=0.2, obs_dt=0.1),
                             outdir=str(tmp), engine=engine)


def _double_sweep(engine, tmp):
    from hydrolim_tpu.sweeps.double_sweep import double_sweep_fused

    return double_sweep_fused([0.5], [8.0], 1, ps_kwargs=dict(L=32),
                              run_kwargs=dict(T=0.2, obs_dt=0.1),
                              outdir=str(tmp), plot_result=False,
                              engine=engine)


def _structure_sweep(engine, tmp):
    from hydrolim_tpu.sweeps.local_structure import (
        sweep_betas_for_structures,
    )

    return sweep_betas_for_structures([0.5], 1, ps_kwargs=_PARTICLE,
                                      run_kwargs=dict(T=0.2, obs_dt=0.1),
                                      engine=engine)


def _pde_facade(engine, tmp):
    from hydrolim_tpu import IMEXPDE

    pde = IMEXPDE(L=32, T=0.01, dt=1e-3, seed=0, outdir=str(tmp))
    pde.initialize("homogeneous", n_tracers=4)
    return pde.solve(engine=engine)


def _pde_ensemble(engine, tmp):
    from hydrolim_tpu.core.config import PDEConfig
    from hydrolim_tpu.sweeps.pde_sweeps import run_pde_ensemble

    return run_pde_ensemble(PDEConfig(L=32, T=0.01, dt=1e-3), [0.5],
                            gamma=0.2, lam=0.6, n_runs=1, n_tracers=4,
                            engine=engine)


def _pde_beta_sweep(engine, tmp):
    from hydrolim_tpu.sweeps.pde_sweeps import pde_beta_sweep

    return pde_beta_sweep([0.5], n_runs=1, T=0.01, t_min=0.0, t_max=0.01,
                          L=32, dt=1e-3, n_tracers=4, plot_result=False,
                          engine=engine)


def _pde_sigma_sweep(engine, tmp):
    from hydrolim_tpu.sweeps.pde_sweeps import pde_kernel_sigma_sweep

    return pde_kernel_sigma_sweep([0.05], n_runs=1, L=32, dt=1e-3,
                                  n_tracers=4, plot_result=False,
                                  engine=engine, T=0.01)


SURFACES = {
    "ParticleSystem.run": (_particle_system, "'particle', 'lattice_gas'"),
    "ParticleSystem.run_checkpointed": (_particle_system_ckpt,
                                        "'particle', 'lattice_gas'"),
    "sweep_over_betas": (_beta_sweep, "'particle', 'lattice_gas'"),
    "sweep_over_sigmas": (_sigma_sweep, "'particle', 'lattice_gas'"),
    "double_sweep_fused": (_double_sweep, "'particle', 'lattice_gas'"),
    "sweep_betas_for_structures": (_structure_sweep,
                                   "'particle', 'lattice_gas'"),
    "IMEXPDE.solve": (_pde_facade, "'xla'"),
    "run_pde_ensemble": (_pde_ensemble, "'xla'"),
    "pde_beta_sweep": (_pde_beta_sweep, "'xla'"),
    "pde_kernel_sigma_sweep": (_pde_sigma_sweep, "'xla'"),
}


@pytest.mark.parametrize("name", ["pallas", "auto"])
@pytest.mark.parametrize("surface", list(SURFACES))
def test_removed_engine_names_raise(surface, name, tmp_path):
    """The fused-kernel engines are gone; asking for one raises a
    ValueError naming the engines that exist — never a quiet reroute."""
    fn, engines = SURFACES[surface]
    with pytest.raises(ValueError, match=f"the engines are {engines}$"):
        fn(name, tmp_path)


@pytest.mark.parametrize("build", [
    "select_devices", "make_mesh", "sweep_mesh", "space_mesh", "grid_mesh",
    "explicit_devices", "sweep_over_betas"])
def test_too_few_devices_raises(build, tmp_path):
    """Asking for more devices than the default platform has is an error:
    no mesh falls back to devices of another platform."""
    from hydrolim_tpu.parallel import mesh as pm
    from hydrolim_tpu.parallel import spatial

    n = len(jax.devices()) + 1
    calls = {
        "select_devices": lambda: pm.select_devices(n),
        "make_mesh": lambda: pm.make_mesh(n),
        "sweep_mesh": lambda: pm.sweep_mesh(n),
        "space_mesh": lambda: spatial.space_mesh(n),
        "grid_mesh": lambda: spatial.grid_mesh(n, 1),
        "explicit_devices": lambda: pm.sweep_mesh(
            2, devices=jax.devices()[:1]),
        "sweep_over_betas": lambda: _beta_sweep_on(n, tmp_path),
    }
    with pytest.raises(ValueError, match="need .* devices"):
        calls[build]()


def _beta_sweep_on(n_devices, tmp):
    from hydrolim_tpu.sweeps.beta_sweep import sweep_over_betas

    return sweep_over_betas([0.5], 1, ps_kwargs=_PARTICLE,
                            run_kwargs=dict(T=0.2, obs_dt=0.1),
                            npz_path=str(tmp / "s.npz"), outdir=str(tmp),
                            do_fit=False, plot_result=False,
                            engine="lattice_gas", n_devices=n_devices)


_CACHE_PROBE = """
import jax, jax.numpy as jnp
import hydrolim_tpu
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
jax.jit(lambda x: jnp.sin(x) * 3 + 1)(jnp.ones(17)).block_until_ready()
print(jax.config.jax_compilation_cache_dir)
"""


def _cache_probe(tmp_path, env_cache_dir):
    """Import a copy of the package from a fresh checkout under tmp_path,
    compile one function, and return (checkout, the cache dir JAX used)."""
    checkout = tmp_path / "checkout"
    shutil.copytree(ROOT / "hydrolim_tpu", checkout / "hydrolim_tpu",
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR",
                        "HYDROLIM_NO_COMPILATION_CACHE")}
    env.update(PYTHONPATH=str(checkout), JAX_PLATFORMS="cpu")
    if env_cache_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_cache_dir)
    out = subprocess.run([sys.executable, "-c", _CACHE_PROBE], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-1500:]
    return checkout, out.stdout.strip().splitlines()[-1]


def test_compile_cache_defaults_into_the_checkout(tmp_path):
    checkout, used = _cache_probe(tmp_path, None)
    assert used == str(checkout / ".jax_cache")
    assert any((checkout / ".jax_cache").iterdir())


def test_compile_cache_env_var_is_honoured(tmp_path):
    target = tmp_path / "elsewhere"
    checkout, used = _cache_probe(tmp_path, target)
    assert used == str(target)
    assert any(target.iterdir())
    assert not (checkout / ".jax_cache").exists()


def _chip_smoke(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args],
                          cwd=str(cwd), env=env, capture_output=True,
                          text=True, timeout=120)


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    """On the CPU (and in a directory holding the script and nothing else)
    chip_smoke.py exits non-zero having run no phase and printed no
    result."""
    cwd = ROOT
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    out = _chip_smoke(cwd)
    assert out.returncode != 0
    assert "phase " not in out.stdout and '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_chip_smoke_multi_gpu_selects_only_its_phase():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    assert chip_smoke.select_phases(multi_gpu=True) == ["multi_gpu"]
    single = chip_smoke.select_phases(multi_gpu=False)
    assert "multi_gpu" not in single
    assert set(single) == {"precision", "meanfield", "exclusion_sweep",
                           "resume", "pde_single", "pde_sweep"}
    # the resume phase compares against the straight sweep, so it follows it
    assert single.index("resume") > single.index("exclusion_sweep")


def test_matmul_precision_checker_flags_default_precision():
    import jax.numpy as jnp

    from hydrolim_tpu.utils.debug import matmuls_below_highest

    a = jnp.ones((4, 4))
    assert len(matmuls_below_highest(lambda x: x @ x, a)) == 1
    assert matmuls_below_highest(
        lambda x: jnp.matmul(x, x, precision="highest"), a) == []
    w = jnp.ones((1, 1, 3))
    conv = lambda x, **kw: jax.lax.conv_general_dilated(
        x.reshape(1, 1, -1), w, (1,), "VALID", **kw)
    assert len(matmuls_below_highest(conv, jnp.ones(8))) == 1
    scan = lambda x: jax.lax.scan(lambda c, _: (c @ c, None), x, None,
                                  length=2)[0]
    assert len(matmuls_below_highest(scan, a)) == 1


@pytest.mark.parametrize("engine", ["particle", "lattice_gas", "pde"])
def test_engines_never_ask_for_tf32(engine):
    """Every float matmul and convolution of the three engines — records
    and spectra included — asks for HIGHEST precision, so none can run in
    TF32 on the GPU."""
    from hydrolim_tpu.core.config import (
        ParticleConfig,
        PDEConfig,
        make_pde_params,
    )
    from hydrolim_tpu.utils.debug import matmuls_below_highest

    key = jax.random.PRNGKey(0)
    if engine == "pde":
        from hydrolim_tpu.pde.init import pde_initialize
        from hydrolim_tpu.pde.stepper import build_pde_ops, pde_solve

        bad = []
        for sigma, solver, L in ((0.05, "auto", 64), (2e5, "auto", 64),
                                 (2.0 / 4224, "banded", 4224)):
            pc = PDEConfig(L=L, T=2e-3, dt=1e-3, gaussian_kernel=True,
                           kernel_sigma=sigma, snapshot_interval=1,
                           n_tracers=4, diffusion_solver=solver)
            pp = make_pde_params(gamma=0.2, lam=0.6, beta=2.0)
            ops = build_pde_ops(pc, pp)
            rp, rm, tr = pde_initialize(pc, key, mode="homogeneous",
                                        n_tracers=4)
            bad += matmuls_below_highest(
                lambda k: pde_solve(pc, pp, ops, rp, rm, tr, k), key)
        assert bad == []
        return
    from hydrolim_tpu.sweeps.ensemble import broadcast_params

    config = ParticleConfig(L=64, N=48, n_pad=48, init="fixed",
                            scale_rates=False, local_kernel_sigma=0.05,
                            periodic=True,
                            site_capacity=3 if engine == "lattice_gas"
                            else None, active_model="bidirectional")
    params = broadcast_params(config, beta=[0.5, 2.0], rate_diffusion=0.5,
                              rate_active=2.0)
    if engine == "lattice_gas":
        from hydrolim_tpu.particles.lattice_gas_k import run_lattice_gas_k

        fn = lambda k: run_lattice_gas_k(config, params, k, T=0.2,
                                         obs_dt=0.1, dt=0.01, n_tracers=4)
    else:
        from hydrolim_tpu.sweeps.ensemble import run_particle_ensemble

        fn = lambda k: run_particle_ensemble(config, params, k, T=0.2,
                                             obs_dt=0.1, dt=0.01)
    assert matmuls_below_highest(fn, key) == []
