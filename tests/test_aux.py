"""Aux subsystems: profiling, debug checks, config-hash checkpointing,
structure figure inventory."""
import numpy as np
import jax
import pytest

from hydrolim_tpu.core.config import ParticleConfig, make_particle_params
from hydrolim_tpu.particles.init import init_particles
from hydrolim_tpu.sweeps.persistence import cached_run, config_hash, load_result, save_result
from hydrolim_tpu.utils.debug import check_density_invariants, check_particle_invariants
from hydrolim_tpu.utils.profiling import PhaseTimer, throughput


def test_phase_timer_and_throughput():
    timer = PhaseTimer()
    with timer("a"):
        sum(range(1000))
    with timer("a"):
        pass
    assert timer.counts["a"] == 2
    assert "a" in timer.summary()
    r = throughput(lambda: None, items_per_call=100, warmup=0, reps=2)
    assert r["items_per_sec"] > 0


def test_debug_invariants_pass_and_fail():
    config = ParticleConfig(L=16, N=8, init="fixed", site_capacity=1)
    state = init_particles(config, jax.random.PRNGKey(0))
    check_particle_invariants(config, state)
    bad = state._replace(pos=state.pos.at[0].set(99))
    with pytest.raises(AssertionError):
        check_particle_invariants(config, bad)
    check_density_invariants(np.ones(4), np.zeros(4))
    with pytest.raises(AssertionError):
        check_density_invariants(np.array([1.0, -0.1]), np.zeros(2))


def test_config_hash_stability_and_cached_run(tmp_path):
    cfg = {"L": 100, "beta": np.linspace(0, 1, 3), "fn": np.mean,
           "nested": {"a": 1}}
    assert config_hash(cfg) == config_hash(dict(cfg))
    assert config_hash(cfg) != config_hash({**cfg, "L": 101})

    calls = {"n": 0}

    def expensive():
        calls["n"] += 1
        return {"x": np.arange(3), "scalar": 1.5}

    r1 = cached_run(expensive, config=cfg, cache_dir=tmp_path, tag="t")
    r2 = cached_run(expensive, config=cfg, cache_dir=tmp_path, tag="t")
    assert calls["n"] == 1          # second call hit the checkpoint
    np.testing.assert_array_equal(r1["x"], r2["x"])
    r3 = cached_run(expensive, config={**cfg, "L": 7}, cache_dir=tmp_path,
                    tag="t")
    assert calls["n"] == 2          # different config -> re-run


def test_save_load_roundtrip(tmp_path):
    res = {"a": np.eye(2), "meta": {"k": 3}}
    save_result(res, tmp_path / "r.npz", config={"c": 1})
    back = load_result(tmp_path / "r.npz")
    np.testing.assert_array_equal(back["a"], res["a"])
    assert back["meta"]["k"] == 3


def test_structure_run_all_plots(tmp_path):
    from hydrolim_tpu.sweeps.local_structure import sweep_betas_for_structures
    from hydrolim_tpu.viz.structure_plots import run_all_plots

    res = sweep_betas_for_structures(
        np.array([0.5, 2.0]), 2,
        ps_kwargs=dict(L=64, N=48, periodic=True),
        run_kwargs=dict(T=1.5, obs_dt=0.25), seed=0, keep_outs=True)
    run_all_plots(res, outdir=str(tmp_path), L=64)
    produced = {p.name for p in tmp_path.glob("*.png")}
    expected = {"lowk_power_vs_beta.png", "variance_vs_beta.png",
                "m_local_var_vs_beta.png", "dominant_wavelength_vs_beta.png",
                "fft_spectrum_heatmap.png", "lowk_modes_vs_beta.png",
                "dominant_mode_amplitude_vs_beta.png",
                "spectral_entropy_vs_beta.png",
                "mode_competition_vs_beta.png",
                "time_to_pattern_vs_beta.png", "lowk_variance_time.png",
                "mode_1_growth_time.png", "growth_rate_vs_beta.png",
                "autocorrelation_vs_beta.png"}
    assert expected <= produced, expected - produced


def test_orbax_pytree_roundtrip(tmp_path):
    from hydrolim_tpu.sweeps.persistence import load_pytree, save_pytree

    tree = {"a": np.arange(5.0), "nested": {"b": np.eye(2)}}
    save_pytree(tree, tmp_path / "ckpt")
    back = load_pytree(tmp_path / "ckpt")
    np.testing.assert_array_equal(back["a"], tree["a"])
    np.testing.assert_array_equal(back["nested"]["b"], tree["nested"]["b"])


def test_bench_module_importable():
    """bench.py must stay importable; check the entry points exist without
    executing device work."""
    import importlib.util
    import pathlib

    import jax

    path = pathlib.Path(__file__).parent.parent / "bench.py"
    prior_cache = jax.config.jax_compilation_cache_dir
    spec = importlib.util.spec_from_file_location("bench", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for fn in ("bench_particle_steps", "bench_k3_flagship",
               "bench_lattice_gas", "bench_pde_steps",
               "bench_pde_banded_large_L", "main"):
        assert callable(getattr(mod, fn))
    # the exec above must NOT have re-enabled the persistent compilation
    # cache for the rest of the suite
    assert jax.config.jax_compilation_cache_dir == prior_cache
    assert jax.config.jax_compilation_cache_dir is None


def _run_bench(env_extra, timeout=300):
    """bench.py through its watchdog with ``env_extra``; returns the process
    and the parsed stdout lines (the contract: exactly one JSON line)."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    path = pathlib.Path(__file__).parent.parent / "bench.py"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("HYDROLIM_NO_COMPILATION_CACHE", None)
    env.update(env_extra)
    out = subprocess.run([sys.executable, str(path)], env=env,
                         capture_output=True, text=True, timeout=timeout,
                         cwd=str(path.parent))
    assert out.returncode == 0, out.stderr[-1000:]
    lines = [l for l in out.stdout.strip().splitlines() if l]
    assert len(lines) == 1, out.stdout
    return out, json.loads(lines[0])


def test_bench_outage_emits_one_json_line():
    """Without a GPU the bench times nothing: it exits 0 with exactly ONE
    parseable JSON error record naming the device it found."""
    _, rec = _run_bench({"HYDROLIM_NO_COMPILATION_CACHE": "1"})
    assert rec["error"] == "no GPU"
    assert rec["device"]["platform"] == "cpu"
    assert rec["value"] is None and rec["vs_baseline"] is None
    # schema uniform with success records (machine-diffable either way)
    assert rec["engines"] == {} and rec["timing"] == "pipelined-mean"


def test_bench_watchdog_kills_midrun_hang():
    """A hung device call blocks inside backend C++ holding the GIL, so
    bench.py runs its body in a child under a parent deadline.  Simulate the
    hang with a child that stops itself (SIGSTOP) and a 2 s deadline: the
    parent must kill the child and still emit exactly one parseable JSON
    error line, rc 0."""
    _, rec = _run_bench({"HYDROLIM_BENCH_TEST_SIGNAL": "19",
                         "HYDROLIM_BENCH_DEADLINE": "2"})
    assert rec["error"] == "bench timed out mid-run"
    assert rec["value"] is None and rec["engines"] == {}


def test_graft_entry_importable():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).parent.parent / "__graft_entry__.py"
    spec = importlib.util.spec_from_file_location("graft", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    assert callable(fn) and len(args) == 2


def test_structure_observables_golden():
    """the array-first structure-observable core must be
    numerically identical to the transcribed original (values frozen
    2026-08-18 from the pre-refactor implementation on a seeded random
    out dict)."""
    from hydrolim_tpu.observables.structure import (
        extract_structure_observables_from_out,
    )

    rng = np.random.default_rng(42)
    T, L = 40, 64
    out = {
        "times_obs": np.linspace(0, 10, T),
        "var_list": rng.random(T),
        "fft_amp_list": rng.random((T, L)),
        "m_local_list": rng.random((T, L)),
        "total_list": rng.random((T, L)),
    }
    obs = extract_structure_observables_from_out(out)
    np.testing.assert_allclose(obs["var_mean"], 0.4933626085926138, rtol=1e-13)
    np.testing.assert_allclose(obs["var_std"], 0.2955716730356283, rtol=1e-13)
    np.testing.assert_allclose(
        obs["fft_mean"][:4],
        [0.58096115, 0.48804449, 0.51914759, 0.50094049], rtol=1e-7)
    np.testing.assert_allclose(np.sum(obs["fft_mean"]), 32.03036639781793,
                               rtol=1e-13)
    np.testing.assert_allclose(np.sum(obs["fft_std"]), 18.662809545174056,
                               rtol=1e-13)
    assert obs["dominant_k"] == 51
    np.testing.assert_allclose(obs["low_k_power"], 11.740632802594671,
                               rtol=1e-13)
    np.testing.assert_allclose(obs["m_local_var"], 0.07951160879050322,
                               rtol=1e-13)
    np.testing.assert_allclose(obs["lowk_variance"], 7.798250552556494,
                               rtol=1e-13)
    # k_max truncation flows through to every k-space statistic
    obs8 = extract_structure_observables_from_out(out, k_max=8)
    assert obs8["fft_mean"].shape == (8,)
    assert obs8["dominant_k"] < 8


def test_every_experiment_driver_cli_wires_up():
    """Each experiments/run_*.py must at least parse --help: the underlying
    sweep/fit functions are covered elsewhere, but a broken CLI wrapper
    (bad import, argparse typo) would otherwise only surface when a user
    runs it."""
    import pathlib
    import subprocess
    import sys

    drivers = sorted((pathlib.Path(__file__).parent.parent /
                      "experiments").glob("run_*.py"))
    assert len(drivers) >= 12
    for d in drivers:
        out = subprocess.run([sys.executable, str(d), "--help"],
                             capture_output=True, text=True, timeout=120,
                             cwd=str(d.parent.parent))
        assert out.returncode == 0, (d.name, out.stderr[-500:])


def test_bench_watchdog_retries_signal_death_without_cache():
    """A child that dies on a signal is retried ONCE with the compilation
    cache disabled; the retry's record is relayed as the single JSON line,
    rc=0."""
    out, rec = _run_bench({"HYDROLIM_BENCH_TEST_SIGNAL": "11"}, timeout=240)
    assert rec["error"] == "no GPU" and rec["value"] is None
    assert "retrying once with the compilation cache disabled" in out.stderr


def test_package_cli_launcher():
    """python -m hydrolim_tpu: help lists every command, unknown commands
    exit 2, and a real driver runs through the dispatcher."""
    import os
    import subprocess
    import sys

    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    env["JAX_PLATFORMS"] = "cpu"
    env["HYDROLIM_NO_COMPILATION_CACHE"] = "1"
    out = subprocess.run([sys.executable, "-m", "hydrolim_tpu", "--help"],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0
    from hydrolim_tpu.__main__ import _COMMANDS, _experiments_dir

    for cmd, (module_name, _) in _COMMANDS.items():
        assert cmd in out.stdout
        assert os.path.exists(
            os.path.join(_experiments_dir(), module_name + ".py")), cmd
    bad = subprocess.run([sys.executable, "-m", "hydrolim_tpu", "nope"],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert bad.returncode == 2 and "unknown command" in bad.stderr
    # the dispatcher must hand sys.argv through to the driver's own parser
    helped = subprocess.run(
        [sys.executable, "-m", "hydrolim_tpu", "beta-sweep", "--help"],
        env=env, capture_output=True, text=True, timeout=300)
    assert helped.returncode == 0 and "--ckpt-dir" in helped.stdout
