"""Mid-run checkpoint/resume (utils/checkpoint.py): a chunked run must be
bit-identical to the unsplit scan, survive a simulated preemption, and
refuse to stitch incompatible physics."""
import numpy as np
import jax
import pytest

from hydrolim_tpu import ParticleSystem
from hydrolim_tpu.particles.run import run_particles
from hydrolim_tpu.utils.checkpoint import run_particles_checkpointed


def _sys(**over):
    kw = dict(L=64, xlim=1.0, rate_diffusion=0.5, rate_active=2.0, beta=1.2,
              init="fixed", N=48, scale_rates=False, local_kernel_sigma=0.0,
              periodic=True, site_capacity=1, k_on=0, k_off=0, k_exit=0,
              rng=11)
    kw.update(over)
    return ParticleSystem(**kw)


def _straight_and_state0(ps, T, obs_dt):
    state0 = ps.init_particles()
    straight = jax.device_get(run_particles(
        ps.config, ps.params, state0, T=T, obs_dt=obs_dt, dt=ps.dt,
        record_pos=True, record_fft=True))
    return straight, state0


def _assert_results_equal(a, b):
    for field in a.frames._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(a.frames, field)),
            np.asarray(getattr(b.frames, field)), err_msg=field)
    for field in a.final_state._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(a.final_state, field)),
            np.asarray(getattr(b.final_state, field)),
            err_msg=f"final_state.{field}")


def test_chunked_bit_identical_to_straight(tmp_path):
    ps = _sys()
    T, obs_dt = 1.2, 0.1  # 12 frames, 3 chunks of 5/5/2
    straight, state0 = _straight_and_state0(ps, T, obs_dt)
    chunked = run_particles_checkpointed(
        ps.config, ps.params, state0, T=T, obs_dt=obs_dt, dt=ps.dt,
        ckpt_dir=tmp_path / "ck", chunk_frames=5, record_pos=True,
        record_fft=True)
    _assert_results_equal(chunked, straight)


def test_resume_after_simulated_preemption(tmp_path):
    ps = _sys()
    T, obs_dt = 1.2, 0.1
    straight, state0 = _straight_and_state0(ps, T, obs_dt)
    ck = tmp_path / "ck"
    # preempted after 1 of 3 chunks
    partial = run_particles_checkpointed(
        ps.config, ps.params, state0, T=T, obs_dt=obs_dt, dt=ps.dt,
        ckpt_dir=ck, chunk_frames=5, record_pos=True, record_fft=True,
        stop_after_chunks=1)
    assert partial is None
    assert (ck / "chunk_00000.npz").exists()
    assert not (ck / "chunk_00001.npz").exists()
    # resume runs only the missing chunks and stitches the full result
    resumed = run_particles_checkpointed(
        ps.config, ps.params, state0, T=T, obs_dt=obs_dt, dt=ps.dt,
        ckpt_dir=ck, chunk_frames=5, record_pos=True, record_fft=True)
    _assert_results_equal(resumed, straight)


def test_resume_ignores_state0_and_reloads_carry(tmp_path):
    """Once every chunk exists, a resume call must not re-run anything —
    even a different state0 yields the stored trajectory (the carry on
    disk is authoritative)."""
    ps = _sys()
    T, obs_dt = 0.6, 0.1
    straight, state0 = _straight_and_state0(ps, T, obs_dt)
    ck = tmp_path / "ck"
    first = run_particles_checkpointed(
        ps.config, ps.params, state0, T=T, obs_dt=obs_dt, dt=ps.dt,
        ckpt_dir=ck, chunk_frames=2, record_pos=True, record_fft=True)
    other_state = ps.init_particles()  # different key split
    second = run_particles_checkpointed(
        ps.config, ps.params, other_state, T=T, obs_dt=obs_dt, dt=ps.dt,
        ckpt_dir=ck, chunk_frames=2, record_pos=True, record_fft=True,
        stop_after_chunks=0)  # would return None if any chunk had to run
    assert second is not None
    _assert_results_equal(second, first)


def test_mismatched_run_raises(tmp_path):
    ps = _sys()
    state0 = ps.init_particles()
    ck = tmp_path / "ck"
    run_particles_checkpointed(
        ps.config, ps.params, state0, T=0.3, obs_dt=0.1, dt=ps.dt,
        ckpt_dir=ck, chunk_frames=2, record_pos=True, record_fft=True)
    ps2 = _sys(beta=2.5)
    with pytest.raises(ValueError, match="different run"):
        run_particles_checkpointed(
            ps2.config, ps2.params, state0, T=0.3, obs_dt=0.1, dt=ps2.dt,
            ckpt_dir=ck, chunk_frames=2, record_pos=True, record_fft=True)
    # resume=False overwrites instead
    res = run_particles_checkpointed(
        ps2.config, ps2.params, state0, T=0.3, obs_dt=0.1, dt=ps2.dt,
        ckpt_dir=ck, chunk_frames=2, record_pos=True, record_fft=True,
        resume=False)
    assert res is not None


def test_single_chunk_and_facade_out_schema(tmp_path):
    """chunk_frames >= n_frames degenerates to one checkpointed chunk, and
    the facade method returns the reference out-dict schema matching
    ps.run."""
    ps = _sys(rng=21)
    out_ck = ps.run_checkpointed(T=0.5, obs_dt=0.1, ckpt_dir=tmp_path / "ck",
                                 chunk_frames=100, record_fft=True,
                                 record_var=True)
    ps2 = _sys(rng=21)
    out = ps2.run(T=0.5, obs_dt=0.1, record_fft=True, record_var=True)
    np.testing.assert_array_equal(out_ck["total_list"], out["total_list"])
    np.testing.assert_array_equal(out_ck["m_global"], out["m_global"])
    np.testing.assert_array_equal(out_ck["pos_frames"], out["pos_frames"])
    assert out_ck["particle_count_list"] == out["particle_count_list"]
    np.testing.assert_array_equal(out_ck["var_list"], out["var_list"])


def test_checkpoint_with_anchors_and_exits(tmp_path):
    """The exit log and bind state live in the carry; a chunked anchored
    run must reproduce the unsplit exit records exactly."""
    ps = _sys(anchor_positions=[0.25, 0.75], k_on=5.0, k_off=0.5,
              k_exit=2.0, N=32, rng=5)
    T, obs_dt = 1.0, 0.1
    straight, state0 = _straight_and_state0(ps, T, obs_dt)
    chunked = run_particles_checkpointed(
        ps.config, ps.params, state0, T=T, obs_dt=obs_dt, dt=ps.dt,
        ckpt_dir=tmp_path / "ck", chunk_frames=3, record_pos=True,
        record_fft=True)
    _assert_results_equal(chunked, straight)


# ---------------------------------------------------------------------------
# PDE engine
# ---------------------------------------------------------------------------

def _pde_parts(seed=7, L=64, T=0.05, dt=1e-3, interval=10, n_tracers=40):
    from hydrolim_tpu import IMEXPDE

    pde = IMEXPDE(L=L, T=T, dt=dt, seed=seed, snapshot_interval=interval,
                  outdir="unused")
    pde.initialize("homogeneous", noise=0.2, n_tracers=n_tracers)
    return pde


def _assert_pde_results_equal(a, b):
    for field in ("rho_p", "rho_m", "snapshots", "m_snapshots",
                  "snap_times"):
        np.testing.assert_array_equal(
            np.asarray(getattr(a, field)), np.asarray(getattr(b, field)),
            err_msg=field)
    for field in a.records._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(a.records, field)),
            np.asarray(getattr(b.records, field)),
            err_msg=f"records.{field}")


def test_pde_chunked_bit_identical_and_resumes(tmp_path):
    from hydrolim_tpu.pde.stepper import pde_solve
    from hydrolim_tpu.utils.checkpoint import pde_solve_checkpointed

    pde = _pde_parts()          # nsteps=50, interval=10 -> 6 blocks
    key = jax.random.PRNGKey(123)
    straight = jax.device_get(pde_solve(
        pde.config, pde.params, pde.ops, pde.rho_p, pde.rho_m, pde.tracers,
        key))
    ck = tmp_path / "ck"
    partial = pde_solve_checkpointed(
        pde.config, pde.params, pde.ops, pde.rho_p, pde.rho_m, pde.tracers,
        key, ckpt_dir=ck, chunk_blocks=2, stop_after_chunks=1)
    assert partial is None and (ck / "chunk_00000.npz").exists()
    resumed = pde_solve_checkpointed(
        pde.config, pde.params, pde.ops, pde.rho_p, pde.rho_m, pde.tracers,
        key, ckpt_dir=ck, chunk_blocks=2)
    _assert_pde_results_equal(resumed, straight)


def test_pde_checkpoint_mismatch_guard(tmp_path):
    from hydrolim_tpu.utils.checkpoint import pde_solve_checkpointed

    pde = _pde_parts()
    key = jax.random.PRNGKey(3)
    ck = tmp_path / "ck"
    pde_solve_checkpointed(pde.config, pde.params, pde.ops, pde.rho_p,
                           pde.rho_m, pde.tracers, key, ckpt_dir=ck,
                           chunk_blocks=3)
    pde2 = _pde_parts(seed=7)
    pde2.params = pde2.params._replace(beta=np.float32(3.0))
    with pytest.raises(ValueError, match="different PDE solve"):
        pde_solve_checkpointed(pde2.config, pde2.params, pde2.ops,
                               pde2.rho_p, pde2.rho_m, pde2.tracers, key,
                               ckpt_dir=ck, chunk_blocks=3)


def test_pde_facade_checkpointed_output_schema(tmp_path):
    pde = _pde_parts(seed=11)
    pde.solve()
    out = pde.get_output()
    pde2 = _pde_parts(seed=11)
    pde2.solve_checkpointed(ckpt_dir=tmp_path / "ck", chunk_blocks=2)
    out_ck = pde2.get_output()
    for k in out:
        np.testing.assert_array_equal(np.asarray(out[k]),
                                      np.asarray(out_ck[k]), err_msg=k)


def test_resume_adopts_stored_chunk_layout(tmp_path):
    """The chunk size is an I/O knob, not physics: a resume with a
    different chunk_frames must keep the completed prefix (the manifest's
    stored layout wins) instead of raising or discarding work."""
    ps = _sys()
    T, obs_dt = 1.2, 0.1
    straight, state0 = _straight_and_state0(ps, T, obs_dt)
    ck = tmp_path / "ck"
    partial = run_particles_checkpointed(
        ps.config, ps.params, state0, T=T, obs_dt=obs_dt, dt=ps.dt,
        ckpt_dir=ck, chunk_frames=5, record_pos=True, record_fft=True,
        stop_after_chunks=1)
    assert partial is None
    resumed = run_particles_checkpointed(
        ps.config, ps.params, state0, T=T, obs_dt=obs_dt, dt=ps.dt,
        ckpt_dir=ck, chunk_frames=3,  # different knob; stored 5 wins
        record_pos=True, record_fft=True)
    _assert_results_equal(resumed, straight)
    assert (ck / "chunk_00002.npz").exists()   # 12 frames / stored 5 -> 3
    assert not (ck / "chunk_00003.npz").exists()


def test_unreadable_manifest_refuses_resume_but_overwrites(tmp_path):
    ps = _sys()
    state0 = ps.init_particles()
    ck = tmp_path / "ck"
    run_particles_checkpointed(
        ps.config, ps.params, state0, T=0.3, obs_dt=0.1, dt=ps.dt,
        ckpt_dir=ck, chunk_frames=2, record_pos=True, record_fft=True)
    (ck / "manifest.json").write_text('{"run_hash": "trunc')  # crash relic
    with pytest.raises(ValueError, match="unreadable manifest"):
        run_particles_checkpointed(
            ps.config, ps.params, state0, T=0.3, obs_dt=0.1, dt=ps.dt,
            ckpt_dir=ck, chunk_frames=2, record_pos=True, record_fft=True)
    res = run_particles_checkpointed(
        ps.config, ps.params, state0, T=0.3, obs_dt=0.1, dt=ps.dt,
        ckpt_dir=ck, chunk_frames=2, record_pos=True, record_fft=True,
        resume=False)
    assert res is not None


def test_interior_chunks_share_one_compiled_program(tmp_path):
    """The chunk start index is traced (only the length is static), so a
    checkpointed run's interior chunks must NOT each compile a fresh
    program — a large scan's compile costs far more than its chunk."""
    from hydrolim_tpu.particles.run import _run_scan_range

    if not hasattr(_run_scan_range, "_cache_size"):
        pytest.skip("jit cache introspection unavailable")
    ps = _sys(rng=31)
    state0 = ps.init_particles()
    before = _run_scan_range._cache_size()
    # 21 frames, chunk 4 -> 6 chunks, scan lengths 3 (chunk 0), 4×4, 1:
    # only 3 DISTINCT lengths, so at most 3 new cache entries (earlier
    # tests may have already compiled some of these lengths)
    run_particles_checkpointed(
        ps.config, ps.params, state0, T=2.1, obs_dt=0.1, dt=ps.dt,
        ckpt_dir=tmp_path / "ck", chunk_frames=4, record_pos=True,
        record_fft=True)
    assert _run_scan_range._cache_size() - before <= 3
    # a second identical run (fresh dir, same shapes) compiles NOTHING
    mid = _run_scan_range._cache_size()
    run_particles_checkpointed(
        ps.config, ps.params, state0, T=2.1, obs_dt=0.1, dt=ps.dt,
        ckpt_dir=tmp_path / "ck2", chunk_frames=4, record_pos=True,
        record_fft=True)
    assert _run_scan_range._cache_size() == mid


# ---------------------------------------------------------------------------
# lattice-gas slot engine
# ---------------------------------------------------------------------------

def _lgk_parts(K=3, B=2, L=48, N=60):
    from hydrolim_tpu.core.config import ParticleConfig, make_particle_params

    config = ParticleConfig(L=L, N=N, init="fixed", scale_rates=False,
                            local_kernel_sigma=0.02, periodic=True,
                            site_capacity=K)
    params = make_particle_params(config, beta=1.0, rate_diffusion=0.5,
                                  rate_active=2.0, k_on=0.0, k_off=0.0,
                                  k_exit=0.0)
    params_b = jax.tree.map(
        lambda x: np.broadcast_to(np.asarray(x, np.float32), (B,)), params)
    params_b = params_b._replace(beta=np.asarray([0.8, 2.0], np.float32))
    return config, params_b


def test_lgk_chunked_bit_identical_and_resumes(tmp_path):
    from hydrolim_tpu.particles.lattice_gas_k import run_lattice_gas_k
    from hydrolim_tpu.utils.checkpoint import run_lattice_gas_k_checkpointed

    config, params = _lgk_parts()
    key = jax.random.PRNGKey(44)
    T, obs_dt, dt = 1.1, 0.1, 0.02
    straight_frames, straight_slots = jax.tree.map(np.asarray,
        run_lattice_gas_k(config, params, key, T=T, obs_dt=obs_dt, dt=dt,
                          n_tracers=16))
    ck = tmp_path / "ck"
    partial = run_lattice_gas_k_checkpointed(
        config, params, key, T=T, obs_dt=obs_dt, dt=dt, n_tracers=16,
        ckpt_dir=ck, chunk_frames=4, stop_after_chunks=1)
    assert partial is None and (ck / "chunk_00000.npz").exists()
    frames, slots = run_lattice_gas_k_checkpointed(
        config, params, key, T=T, obs_dt=obs_dt, dt=dt, n_tracers=16,
        ckpt_dir=ck, chunk_frames=4)
    for field in straight_frames._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(frames, field)),
            np.asarray(getattr(straight_frames, field)), err_msg=field)
    np.testing.assert_array_equal(np.asarray(slots), straight_slots)


def test_lgk_checkpoint_hash_guard(tmp_path):
    from hydrolim_tpu.utils.checkpoint import run_lattice_gas_k_checkpointed

    config, params = _lgk_parts()
    key = jax.random.PRNGKey(1)
    ck = tmp_path / "ck"
    run_lattice_gas_k_checkpointed(config, params, key, T=0.3, obs_dt=0.1,
                                   dt=0.02, ckpt_dir=ck, chunk_frames=2)
    params2 = params._replace(beta=np.asarray([0.8, 2.5], np.float32))
    with pytest.raises(ValueError, match="different"):
        run_lattice_gas_k_checkpointed(config, params2, key, T=0.3,
                                       obs_dt=0.1, dt=0.02, ckpt_dir=ck,
                                       chunk_frames=2)


def test_facade_lattice_gas_checkpointed_matches_run(tmp_path):
    ps_kw = dict(L=48, xlim=1.0, rate_diffusion=0.5, rate_active=2.0,
                 beta=1.5, init="fixed", N=60, scale_rates=False,
                 local_kernel_sigma=0.02, periodic=True, site_capacity=3,
                 k_on=0, k_off=0, k_exit=0, rng=9)
    out = ParticleSystem(**ps_kw).run(T=0.6, obs_dt=0.1,
                                      engine="lattice_gas")
    out_ck = ParticleSystem(**ps_kw).run_checkpointed(
        T=0.6, obs_dt=0.1, ckpt_dir=tmp_path / "ck", chunk_frames=2,
        engine="lattice_gas")
    np.testing.assert_array_equal(out_ck["total_list"], out["total_list"])
    np.testing.assert_array_equal(out_ck["m_global"], out["m_global"])
    np.testing.assert_array_equal(out_ck["pos_frames"], out["pos_frames"])


def test_sweep_over_betas_ckpt_dir_matches_uncheckpointed(tmp_path):
    """A β-sweep's single in-flight grid program is preemption-safe via
    ckpt_dir — results identical to the uncheckpointed sweep."""
    from hydrolim_tpu.sweeps.beta_sweep import sweep_over_betas

    kw = dict(
        beta_values=np.linspace(0.5, 2.0, 3), n_runs_per_beta=2,
        ps_kwargs=dict(L=48, xlim=1, rate_diffusion=0.5, rate_active=2.0,
                       N=60, init="fixed", scale_rates=False,
                       local_kernel_sigma=0.0, periodic=True,
                       site_capacity=3, k_on=0, k_off=0, k_exit=0),
        run_kwargs=dict(T=0.5, obs_dt=0.1), outdir=str(tmp_path),
        seed=5, engine="lattice_gas", plot_result=False, do_fit=False)
    a = sweep_over_betas(npz_path=str(tmp_path / "a.npz"), **kw)
    b = sweep_over_betas(npz_path=str(tmp_path / "b.npz"),
                         ckpt_dir=tmp_path / "ck", **kw)
    np.testing.assert_array_equal(a["means"], b["means"])
    np.testing.assert_array_equal(a["m_means"], b["m_means"])
    np.testing.assert_array_equal(a["D_means"], b["D_means"])
    assert (tmp_path / "ck" / "manifest.json").exists()


def test_lg1_chunked_bit_identical_and_resumes(tmp_path):
    """K=1 site-centric engine: same checkpoint contract as the slot
    engine (the reference flagship sweeps are K=1, so this is the route
    sweep_over_betas(ckpt_dir=) takes at site_capacity=1)."""
    from hydrolim_tpu.particles.lattice_gas import run_lattice_gas
    from hydrolim_tpu.utils.checkpoint import run_lattice_gas_checkpointed

    config, params = _lgk_parts(K=1, N=30)
    key = jax.random.PRNGKey(77)
    T, obs_dt, dt = 1.1, 0.1, 0.02
    straight_frames, straight_occ = jax.tree.map(np.asarray,
        run_lattice_gas(config, params, key, T=T, obs_dt=obs_dt, dt=dt,
                        n_tracers=12))
    ck = tmp_path / "ck"
    partial = run_lattice_gas_checkpointed(
        config, params, key, T=T, obs_dt=obs_dt, dt=dt, n_tracers=12,
        ckpt_dir=ck, chunk_frames=4, stop_after_chunks=1)
    assert partial is None
    frames, occ = run_lattice_gas_checkpointed(
        config, params, key, T=T, obs_dt=obs_dt, dt=dt, n_tracers=12,
        ckpt_dir=ck, chunk_frames=4)
    for field in straight_frames._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(frames, field)),
            np.asarray(getattr(straight_frames, field)), err_msg=field)
    np.testing.assert_array_equal(np.asarray(occ), straight_occ)


def test_sweep_ckpt_dir_k1_route(tmp_path):
    from hydrolim_tpu.sweeps.beta_sweep import sweep_over_betas

    kw = dict(
        beta_values=np.linspace(0.5, 2.0, 2), n_runs_per_beta=2,
        ps_kwargs=dict(L=48, xlim=1, rate_diffusion=0.5, rate_active=2.0,
                       N=24, init="fixed", scale_rates=False,
                       local_kernel_sigma=0.0, periodic=True,
                       site_capacity=1, k_on=0, k_off=0, k_exit=0),
        run_kwargs=dict(T=0.4, obs_dt=0.1), outdir=str(tmp_path),
        seed=2, engine="lattice_gas", plot_result=False, do_fit=False)
    a = sweep_over_betas(npz_path=str(tmp_path / "a.npz"), **kw)
    b = sweep_over_betas(npz_path=str(tmp_path / "b.npz"),
                         ckpt_dir=tmp_path / "ck", **kw)
    np.testing.assert_array_equal(a["means"], b["means"])
    np.testing.assert_array_equal(a["m_means"], b["m_means"])


# ---------------------------------------------------------------------------
# sweep surfaces: σ-sweep, (N,β) double-sweep ledger, structure sweep
# ---------------------------------------------------------------------------

_DS_KW = dict(
    n_runs_per_beta=2, engine="lattice_gas", plot_result=False,
    ps_kwargs=dict(L=48, N=24, rate_diffusion=0.5, rate_active=2.0,
                   local_kernel_sigma=0.0, site_capacity=2),
    run_kwargs=dict(T=0.6, obs_dt=0.1), chunk_size=5, seed=3)


def test_double_sweep_ledger_bit_identical_and_resumes(tmp_path):
    """The (N,β) grid's chunk ledger: a run preempted mid-grid resumes by
    re-executing only the missing replica chunks (independent fold_in keys
    per chunk), and the fitted constants equal the uninterrupted run's
    exactly."""
    from hydrolim_tpu.sweeps.double_sweep import double_sweep_fused

    betas = np.linspace(0.5, 2.0, 3)
    Ns = [16.0, 24.0]                       # B = 2*3*2 = 12 -> 3 chunks of 5/5/2
    plain = double_sweep_fused(betas, Ns, outdir=str(tmp_path / "a"),
                               **_DS_KW)
    ck = tmp_path / "ck"
    partial = double_sweep_fused(betas, Ns, outdir=str(tmp_path / "b"),
                                 ckpt_dir=ck, stop_after_chunks=1, **_DS_KW)
    assert partial is None
    assert (ck / "chunk_0000000.npz").exists()
    assert not (ck / "chunk_0000005.npz").exists()
    resumed = double_sweep_fused(betas, Ns, outdir=str(tmp_path / "b"),
                                 ckpt_dir=ck, **_DS_KW)
    for k in ("C0", "C1", "C2", "f_fit", "g_fit"):
        np.testing.assert_array_equal(np.asarray(plain[k]),
                                      np.asarray(resumed[k]), err_msg=k)
    for pn_a, pn_b in zip(plain["per_N"], resumed["per_N"]):
        np.testing.assert_array_equal(pn_a["block_means"],
                                      pn_b["block_means"])


def test_double_sweep_ledger_hash_guard(tmp_path):
    """chunk_size IS physics for the ledger (it sets the fold_in key
    schedule), and any grid/seed change refuses to stitch."""
    import pytest

    from hydrolim_tpu.sweeps.double_sweep import double_sweep_fused

    betas = np.linspace(0.5, 2.0, 2)
    Ns = [16.0, 24.0]
    ck = tmp_path / "ck"
    double_sweep_fused(betas, Ns, outdir=str(tmp_path / "a"), ckpt_dir=ck,
                       **_DS_KW)
    with pytest.raises(ValueError, match="different double sweep"):
        double_sweep_fused(betas, Ns, outdir=str(tmp_path / "a"),
                           ckpt_dir=ck, **dict(_DS_KW, seed=4))
    with pytest.raises(ValueError, match="different double sweep"):
        double_sweep_fused(betas, Ns, outdir=str(tmp_path / "a"),
                           ckpt_dir=ck, **dict(_DS_KW, chunk_size=3))
    # resume=False starts the ledger over instead
    res = double_sweep_fused(betas, Ns, outdir=str(tmp_path / "a"),
                             ckpt_dir=ck, resume=False,
                             **dict(_DS_KW, seed=4))
    assert res is not None


def test_sigma_sweep_ckpt_dir_matches_plain(tmp_path):
    """Each σ's in-flight grid program runs through the checkpointed slot
    engine under its own subdirectory; results equal the plain sweep."""
    from hydrolim_tpu.sweeps.sigma_sweep import sweep_over_sigmas

    kw = dict(sigma_values=[0.05, 0.0], beta_values=np.linspace(0.5, 2, 2),
              n_runs_per_beta=2, engine="lattice_gas", seed=6,
              ps_kwargs=dict(L=48, N=24, site_capacity=1),
              run_kwargs=dict(T=0.5, obs_dt=0.1))
    a = sweep_over_sigmas(outdir=str(tmp_path / "a"), **kw)
    b = sweep_over_sigmas(outdir=str(tmp_path / "b"),
                          ckpt_dir=tmp_path / "ck", **kw)
    for s in a:
        np.testing.assert_array_equal(a[s]["v_mean"], b[s]["v_mean"],
                                      err_msg=f"sigma={s}")
        np.testing.assert_array_equal(a[s]["D_mean"], b[s]["D_mean"],
                                      err_msg=f"sigma={s}")
    assert (tmp_path / "ck" / "sigma_0.05" / "manifest.json").exists()
    assert (tmp_path / "ck" / "sigma_0" / "manifest.json").exists()


def test_structure_sweep_ckpt_dir_matches_plain(tmp_path):
    """The structure β-sweep routes its lattice-gas grid through the
    checkpointed runner when ckpt_dir is given."""
    from hydrolim_tpu.sweeps.local_structure import sweep_betas_for_structures

    kw = dict(beta_values=np.linspace(0.5, 2.0, 2), n_runs_per_beta=2,
              ps_kwargs=dict(L=64, N=40, periodic=True, site_capacity=1,
                             minus_anchor=False,
                             immobilize_when_anchored=False),
              run_kwargs=dict(T=1.0, obs_dt=0.2), seed=8,
              engine="lattice_gas", keep_outs=False)
    a = sweep_betas_for_structures(**kw)
    b = sweep_betas_for_structures(ckpt_dir=tmp_path / "ck", **kw)
    for beta in a:
        for field in ("var_mean", "low_k_power_mean", "m_local_var_mean",
                      "lowk_var_mean"):
            np.testing.assert_array_equal(a[beta][field], b[beta][field],
                                          err_msg=f"{beta}:{field}")
        np.testing.assert_array_equal(a[beta]["fft_mean_mean"],
                                      b[beta]["fft_mean_mean"])
    assert (tmp_path / "ck" / "manifest.json").exists()


# ---------------------------------------------------------------------------
# PDE ensemble (vmapped sweep grid)
# ---------------------------------------------------------------------------

def _pde_ens_kw(seed=21):
    from hydrolim_tpu.core.config import PDEConfig

    # nsteps=150, interval=10 -> 16 blocks -> 2 chunks at chunk_blocks=8
    config = PDEConfig(L=64, T=0.15, dt=1e-3, bc="periodic",
                       active_model="bidirectional", gaussian_kernel=True,
                       kernel_sigma=1e5 - 10, snapshot_interval=10,
                       fft_kmax=8)
    return config, dict(gamma=0.2, lam=0.6, n_runs=2, seed=seed,
                        n_tracers=30, fetch_snapshots=True)


def test_pde_ensemble_ckpt_bit_identical_and_resumes(tmp_path):
    """The whole vmapped (β × runs) PDE grid checkpoints mid-program and a
    resume (simulated by deleting the newest chunk) recomputes only the
    missing chunk — stitched batched result identical to the plain vmapped
    solve."""
    from hydrolim_tpu.sweeps.pde_sweeps import run_pde_ensemble

    config, kw = _pde_ens_kw()
    betas = np.asarray([0.5, 2.0])
    plain, flat_beta = run_pde_ensemble(config, betas, **kw)
    ck = tmp_path / "ck"
    ckres, _ = run_pde_ensemble(config, betas, ckpt_dir=ck, **kw)
    assert (ck / "chunk_00001.npz").exists()   # 16 blocks -> 2 chunks
    _assert_pde_results_equal(ckres, plain)
    # simulate a preemption that lost the newest chunk; resume recomputes
    # just that chunk from the stored carry and stitches the same result
    (ck / "chunk_00001.npz").unlink()
    resumed, _ = run_pde_ensemble(config, betas, ckpt_dir=ck, **kw)
    _assert_pde_results_equal(resumed, plain)


def test_pde_ensemble_ckpt_hash_guard(tmp_path):
    from hydrolim_tpu.sweeps.pde_sweeps import run_pde_ensemble

    config, kw = _pde_ens_kw()
    betas = np.asarray([0.5, 2.0])
    ck = tmp_path / "ck"
    run_pde_ensemble(config, betas, ckpt_dir=ck, **kw)
    with pytest.raises(ValueError, match="different PDE ensemble"):
        run_pde_ensemble(config, betas, ckpt_dir=ck,
                         **dict(kw, seed=99))


def test_pde_beta_sweep_ckpt_dir_matches_plain(tmp_path):
    """Facade plumbing: pde_beta_sweep(ckpt_dir=) returns the same sweep
    statistics as the plain run."""
    from hydrolim_tpu.sweeps.pde_sweeps import pde_beta_sweep

    kw = dict(beta_values=np.linspace(0.5, 2.0, 2), n_runs=2, T=0.2,
              t_min=0.1, t_max=0.2, L=64, dt=1e-3, n_tracers=30,
              plot_result=False, seed=13)
    a = pde_beta_sweep(outdir=str(tmp_path / "a"), **kw)
    b = pde_beta_sweep(outdir=str(tmp_path / "b"),
                       ckpt_dir=tmp_path / "ck", **kw)
    np.testing.assert_array_equal(a["v_mean"], b["v_mean"])
    np.testing.assert_array_equal(a["D_mean"], b["D_mean"])
    assert (tmp_path / "ck" / "manifest.json").exists()


# ---------------------------------------------------------------------------
# review-pass regressions (round 4, session 6)
# ---------------------------------------------------------------------------

def test_double_sweep_unvouched_chunks_never_stitch(tmp_path):
    """A ledger whose manifest is gone (user deleted it after a crash)
    must NOT trust the surviving chunk files: a different grid re-using
    the dir recomputes from scratch instead of stitching stale values."""
    from hydrolim_tpu.sweeps.double_sweep import double_sweep_fused

    betas = np.linspace(0.5, 2.0, 2)
    Ns = [16.0, 24.0]
    ck = tmp_path / "ck"
    double_sweep_fused(betas, Ns, outdir=str(tmp_path / "a"), ckpt_dir=ck,
                       **_DS_KW)
    (ck / "manifest.json").unlink()
    plain_s4 = double_sweep_fused(betas, Ns, outdir=str(tmp_path / "b"),
                                  **dict(_DS_KW, seed=4))
    relic = double_sweep_fused(betas, Ns, outdir=str(tmp_path / "c"),
                               ckpt_dir=ck, **dict(_DS_KW, seed=4))
    for pn_a, pn_b in zip(plain_s4["per_N"], relic["per_N"]):
        np.testing.assert_array_equal(pn_a["block_means"],
                                      pn_b["block_means"])


def test_double_sweep_stop_after_chunks_without_ledger(tmp_path):
    """The chunk budget is honored even without a ledger (the docstring
    contract: at most k chunks execute, None when incomplete)."""
    from hydrolim_tpu.sweeps.double_sweep import double_sweep_fused

    res = double_sweep_fused(np.linspace(0.5, 2.0, 3), [16.0, 24.0],
                             outdir=str(tmp_path), stop_after_chunks=1,
                             **_DS_KW)
    assert res is None


def test_pde_ensemble_ckpt_discards_snapshots_when_unfetched(tmp_path):
    """pde_beta_sweep(ckpt_dir=) passes fetch_snapshots=False; the chunk
    files must then store zero-width snapshot stacks instead of the full
    per-interval ρ blocks (they dominate disk/transfer at scale)."""
    from hydrolim_tpu.sweeps.pde_sweeps import pde_beta_sweep

    pde_beta_sweep(beta_values=np.asarray([1.0]), n_runs=2, T=0.2,
                   t_min=0.1, t_max=0.2, L=64, dt=1e-3, n_tracers=20,
                   plot_result=False, seed=5, outdir=str(tmp_path / "o"),
                   ckpt_dir=tmp_path / "ck")
    with np.load(tmp_path / "ck" / "chunk_00000.npz") as z:
        assert z["snaps"].shape[1] == 0
        assert z["m_snaps"].shape[1] == 0
        assert z["recs__m_mean"].shape[1] > 0   # records still present


_KILL_CHILD = r"""
import sys
import numpy as np
from hydrolim_tpu import ParticleSystem
from hydrolim_tpu.utils.checkpoint import run_particles_checkpointed

ckpt_dir = sys.argv[1]
kw = dict(L=64, xlim=1.0, rate_diffusion=0.5, rate_active=2.0, beta=1.2,
          init="fixed", N=48, scale_rates=False, local_kernel_sigma=0.0,
          periodic=True, site_capacity=1, k_on=0, k_off=0, k_exit=0, rng=11)
ps = ParticleSystem(**kw)
state0 = ps.init_particles()
print("READY", flush=True)
run_particles_checkpointed(ps.config, ps.params, state0, T=6.0, obs_dt=0.1,
                           dt=ps.dt, ckpt_dir=ckpt_dir, chunk_frames=3,
                           record_pos=True, record_fft=True)
print("DONE", flush=True)
"""


@pytest.mark.parametrize("kill_after", [0.2, 1.5])
def test_sigkill_mid_run_resumes_bit_identical(tmp_path, kill_after):
    """A real SIGKILL at an arbitrary moment (possibly mid-npz-write) must
    leave a consistent checkpoint prefix: the resume completes the run and
    the stitched result equals the uninterrupted scan bit-for-bit.  This
    exercises the tmp+os.replace atomicity the stop_after_chunks hook
    cannot (the hook always stops BETWEEN chunk writes)."""
    import os
    import signal
    import subprocess
    import sys
    import time

    ck = tmp_path / "ck"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    env["JAX_PLATFORMS"] = "cpu"
    env["HYDROLIM_NO_COMPILATION_CACHE"] = "1"
    child = subprocess.Popen(
        [sys.executable, "-c", _KILL_CHILD, str(ck)], env=env,
        stdout=subprocess.PIPE, text=True)
    try:
        assert child.stdout.readline().strip() == "READY"
        time.sleep(kill_after)  # land somewhere inside the 60-frame run
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
    # resume in-process from whatever prefix survived the kill
    ps = _sys(rng=11, L=64, N=48)
    straight, state0 = _straight_and_state0(ps, 6.0, 0.1)
    resumed = run_particles_checkpointed(
        ps.config, ps.params, state0, T=6.0, obs_dt=0.1, dt=ps.dt,
        ckpt_dir=ck, chunk_frames=3, record_pos=True, record_fft=True)
    _assert_results_equal(resumed, straight)


def test_cleanup_ckpt_dir(tmp_path):
    ps = _sys()
    state0 = ps.init_particles()
    ck = tmp_path / "ck"
    from hydrolim_tpu.utils.checkpoint import cleanup_ckpt_dir

    run_particles_checkpointed(
        ps.config, ps.params, state0, T=0.3, obs_dt=0.1, dt=ps.dt,
        ckpt_dir=ck, chunk_frames=2, record_pos=True, record_fft=True)
    (ck / "chunk_00099.tmp.npz").write_bytes(b"relic")   # kill-time relic
    assert cleanup_ckpt_dir(ck) >= 3
    assert not ck.exists()
    assert cleanup_ckpt_dir(ck) == 0                     # idempotent


# ---------------------------------------------------------------------------
# particle ensemble (vmapped τ-leap grid)
# ---------------------------------------------------------------------------

def test_particle_ensemble_ckpt_bit_identical_and_resumes(tmp_path):
    """The batched τ-leap grid checkpoints on the time axis; a simulated
    preemption resumes mid-scan and the stitched batched result equals the
    plain vmapped run bit-for-bit."""
    from hydrolim_tpu.core.config import ParticleConfig
    from hydrolim_tpu.particles.init import init_particles
    from hydrolim_tpu.sweeps.ensemble import (
        broadcast_params,
        run_particle_ensemble,
    )
    from hydrolim_tpu.utils.checkpoint import (
        run_particle_ensemble_checkpointed,
    )

    config = ParticleConfig(L=48, N=24, init="fixed", scale_rates=False,
                            local_kernel_sigma=0.0, periodic=True,
                            site_capacity=1)
    params = broadcast_params(config, beta=[0.8, 2.0], n_runs=2,
                              rate_diffusion=0.5, rate_active=2.0)
    key = jax.random.PRNGKey(17)
    T, obs_dt, dt = 1.1, 0.1, 0.02
    plain = jax.device_get(run_particle_ensemble(
        config, params, key, T=T, obs_dt=obs_dt, dt=dt))
    keys = jax.random.split(key, 4)
    states = jax.vmap(lambda k: init_particles(config, k, None, None))(keys)
    ck = tmp_path / "ck"
    partial = run_particle_ensemble_checkpointed(
        config, params, states, T=T, obs_dt=obs_dt, dt=dt, ckpt_dir=ck,
        chunk_frames=4, stop_after_chunks=1)
    assert partial is None and (ck / "chunk_00000.npz").exists()
    resumed = run_particle_ensemble_checkpointed(
        config, params, states, T=T, obs_dt=obs_dt, dt=dt, ckpt_dir=ck,
        chunk_frames=4)
    _assert_results_equal(resumed, plain)


def test_sweep_over_betas_particle_engine_ckpt_matches_plain(tmp_path):
    """The facade accepts ckpt_dir with the particle engine now — results
    equal the uncheckpointed sweep, one subdir per replica chunk."""
    from hydrolim_tpu.sweeps.beta_sweep import sweep_over_betas

    kw = dict(
        beta_values=np.linspace(0.5, 2.0, 2), n_runs_per_beta=2,
        ps_kwargs=dict(L=48, xlim=1, rate_diffusion=0.5, rate_active=2.0,
                       N=24, init="fixed", scale_rates=False,
                       local_kernel_sigma=0.0, periodic=True,
                       site_capacity=1, k_on=0, k_off=0, k_exit=0),
        run_kwargs=dict(T=0.4, obs_dt=0.1), outdir=str(tmp_path),
        seed=2, engine="particle", plot_result=False, do_fit=False)
    a = sweep_over_betas(npz_path=str(tmp_path / "a.npz"), **kw)
    b = sweep_over_betas(npz_path=str(tmp_path / "b.npz"),
                         ckpt_dir=tmp_path / "ck", **kw)
    np.testing.assert_array_equal(a["means"], b["means"])
    np.testing.assert_array_equal(a["m_means"], b["m_means"])
    np.testing.assert_array_equal(a["D_means"], b["D_means"])
    assert (tmp_path / "ck" / "replicas_00000" / "manifest.json").exists()


# ---------------------------------------------------------------------------
# checkpointing composed with a sweep mesh
# ---------------------------------------------------------------------------

def _need_cpu_devices(n):
    if len(jax.devices("cpu")) < n:
        pytest.skip(f"needs {n} virtual CPU devices")


def _assert_frames_match_resharded(frames, ref_frames):
    """Bit-equality, except the matmul-derived records (m_local, fft_amp)
    which reassociate at different shard-local batch shapes (~1 ulp —
    the documented resharding caveat, docs/ROADMAP.md)."""
    for field in ref_frames._fields:
        a = np.asarray(getattr(frames, field))
        b = np.asarray(getattr(ref_frames, field))
        if field in ("fft_amp", "m_local"):
            np.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-5,
                                       err_msg=field)
        else:
            np.testing.assert_array_equal(a, b, err_msg=field)


def test_sweep_ckpt_mesh_matches_unsharded_and_uncheckpointed(tmp_path):
    """sweep_over_betas(ckpt_dir=, n_devices=8)
    equals the unsharded-checkpointed AND the sharded-uncheckpointed runs
    bit-for-bit (B=6 pads to 8 — exercises resume under padding too)."""
    from hydrolim_tpu.sweeps.beta_sweep import sweep_over_betas

    _need_cpu_devices(8)
    kw = dict(
        beta_values=np.linspace(0.5, 2.0, 3), n_runs_per_beta=2,
        ps_kwargs=dict(L=48, xlim=1, rate_diffusion=0.5, rate_active=2.0,
                       N=60, init="fixed", scale_rates=False,
                       local_kernel_sigma=0.0, periodic=True,
                       site_capacity=3, k_on=0, k_off=0, k_exit=0),
        run_kwargs=dict(T=0.5, obs_dt=0.1), outdir=str(tmp_path),
        seed=5, engine="lattice_gas", plot_result=False, do_fit=False)
    base = sweep_over_betas(npz_path=str(tmp_path / "a.npz"),
                            ckpt_dir=tmp_path / "ck_a", **kw)
    shard = sweep_over_betas(npz_path=str(tmp_path / "b.npz"),
                             ckpt_dir=tmp_path / "ck_b", n_devices=8, **kw)
    plain = sweep_over_betas(npz_path=str(tmp_path / "c.npz"),
                             n_devices=8, **kw)
    for k in ("means", "m_means", "D_means", "rho_means", "block_means"):
        np.testing.assert_array_equal(np.asarray(base[k]),
                                      np.asarray(shard[k]), err_msg=k)
        np.testing.assert_array_equal(np.asarray(plain[k]),
                                      np.asarray(shard[k]), err_msg=k)
    assert (tmp_path / "ck_b" / "manifest.json").exists()


def test_lgk_ckpt_mesh_resume_bit_identical(tmp_path):
    """Engine-level resume on a mesh: a sharded chunked run preempted
    after one chunk resumes (restored carry re-placed on the mesh) to the
    unsharded straight trajectory bit-for-bit."""
    from hydrolim_tpu.parallel.mesh import sweep_mesh
    from hydrolim_tpu.particles.lattice_gas_k import run_lattice_gas_k
    from hydrolim_tpu.utils.checkpoint import run_lattice_gas_k_checkpointed

    _need_cpu_devices(2)
    config, params = _lgk_parts()
    key = jax.random.PRNGKey(44)
    T, obs_dt, dt = 1.1, 0.1, 0.02
    straight_frames, straight_slots = jax.tree.map(np.asarray,
        run_lattice_gas_k(config, params, key, T=T, obs_dt=obs_dt, dt=dt,
                          n_tracers=16))
    ck = tmp_path / "ck"
    mesh = sweep_mesh(2)
    partial = run_lattice_gas_k_checkpointed(
        config, params, key, T=T, obs_dt=obs_dt, dt=dt, n_tracers=16,
        ckpt_dir=ck, chunk_frames=4, stop_after_chunks=1, mesh=mesh)
    assert partial is None and (ck / "chunk_00000.npz").exists()
    frames, slots = run_lattice_gas_k_checkpointed(
        config, params, key, T=T, obs_dt=obs_dt, dt=dt, n_tracers=16,
        ckpt_dir=ck, chunk_frames=4, mesh=mesh)
    _assert_frames_match_resharded(frames, straight_frames)
    np.testing.assert_array_equal(np.asarray(slots), straight_slots)


def test_pde_ensemble_ckpt_mesh_matches_plain(tmp_path):
    """PDE-ensemble surface: ckpt_dir × n_devices composes and matches
    the unsharded uncheckpointed grid bit-for-bit."""
    from hydrolim_tpu.core.config import PDEConfig
    from hydrolim_tpu.sweeps.pde_sweeps import run_pde_ensemble

    _need_cpu_devices(8)
    config = PDEConfig(L=64, T=0.02, dt=1e-3, bc="periodic",
                       active_model="bidirectional", gaussian_kernel=True,
                       kernel_sigma=0.05, snapshot_interval=10,
                       n_tracers=8, fft_kmax=4)
    kw = dict(gamma=0.2, lam=0.6, n_runs=3, seed=5, n_tracers=8,
              engine="xla")
    betas = np.asarray([0.5, 2.0])
    plain, _ = run_pde_ensemble(config, betas, **kw)
    ck = tmp_path / "ck"
    shard, _ = run_pde_ensemble(config, betas, ckpt_dir=ck, n_devices=8,
                                **kw)
    np.testing.assert_array_equal(np.asarray(plain.records.m_mean),
                                  np.asarray(shard.records.m_mean))
    np.testing.assert_array_equal(np.asarray(plain.records.v_eff),
                                  np.asarray(shard.records.v_eff))
    np.testing.assert_array_equal(np.asarray(plain.rho_p),
                                  np.asarray(shard.rho_p))
    assert (ck / "manifest.json").exists()


def test_particle_ensemble_ckpt_mesh_matches_plain(tmp_path):
    """τ-leap particle-grid surface: run_sweep_grid(ckpt_dir=, n_devices=8)
    equals the unsharded uncheckpointed grid bit-for-bit."""
    from hydrolim_tpu.sweeps.beta_sweep import run_sweep_grid

    _need_cpu_devices(8)
    betas = np.linspace(0.0, 3.0, 3)
    ps_kwargs = dict(L=64, xlim=1.0, rate_diffusion=0.5, rate_active=2.0,
                     N=48, init="fixed", scale_rates=False,
                     local_kernel_sigma=0.0, periodic=True,
                     site_capacity=1, k_on=0, k_off=0, k_exit=0)
    run_kwargs = dict(T=0.5, obs_dt=0.1)
    _, base, _ = run_sweep_grid(betas, 2, ps_kwargs, None, run_kwargs,
                                seed=11)
    _, shard, _ = run_sweep_grid(betas, 2, ps_kwargs, None, run_kwargs,
                                 seed=11, n_devices=8,
                                 ckpt_dir=tmp_path / "ck")
    np.testing.assert_array_equal(np.asarray(base.frames.m_global),
                                  np.asarray(shard.frames.m_global))
    np.testing.assert_array_equal(np.asarray(base.frames.total),
                                  np.asarray(shard.frames.total))
    np.testing.assert_array_equal(np.asarray(base.frames.pos),
                                  np.asarray(shard.frames.pos))


_KILL_CHILD_MESH = r"""
import sys
import numpy as np
import jax
from hydrolim_tpu.core.config import ParticleConfig, make_particle_params
from hydrolim_tpu.parallel.mesh import sweep_mesh
from hydrolim_tpu.utils.checkpoint import run_lattice_gas_k_checkpointed

ckpt_dir = sys.argv[1]
config = ParticleConfig(L=48, N=60, init="fixed", scale_rates=False,
                        local_kernel_sigma=0.02, periodic=True,
                        site_capacity=3)
params = make_particle_params(config, beta=1.0, rate_diffusion=0.5,
                              rate_active=2.0, k_on=0.0, k_off=0.0,
                              k_exit=0.0)
params_b = jax.tree.map(
    lambda x: np.broadcast_to(np.asarray(x, np.float32), (8,)), params)
params_b = params_b._replace(
    beta=np.linspace(0.5, 2.5, 8).astype(np.float32))
print("READY", flush=True)
run_lattice_gas_k_checkpointed(
    config, params_b, jax.random.PRNGKey(3), T=6.0, obs_dt=0.1, dt=0.02,
    n_tracers=8, ckpt_dir=ckpt_dir, chunk_frames=3, mesh=sweep_mesh(8))
print("DONE", flush=True)
"""


@pytest.mark.parametrize("kill_after", [0.3, 2.0])
def test_sigkill_mid_mesh_run_resumes_bit_identical(tmp_path, kill_after):
    """SIGKILL torture ON THE 8-DEVICE MESH:
    a sharded checkpointed run killed mid-flight leaves a consistent
    prefix; the sharded resume completes to the unsharded straight run's
    trajectory bit-for-bit."""
    import os
    import signal
    import subprocess
    import sys
    import time

    from hydrolim_tpu.core.config import ParticleConfig, make_particle_params
    from hydrolim_tpu.parallel.mesh import sweep_mesh
    from hydrolim_tpu.particles.lattice_gas_k import run_lattice_gas_k
    from hydrolim_tpu.utils.checkpoint import run_lattice_gas_k_checkpointed

    _need_cpu_devices(8)
    ck = tmp_path / "ck"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    env["JAX_PLATFORMS"] = "cpu"
    env["HYDROLIM_NO_COMPILATION_CACHE"] = "1"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        " --xla_force_host_platform_device_count=8").strip()
    child = subprocess.Popen(
        [sys.executable, "-c", _KILL_CHILD_MESH, str(ck)], env=env,
        stdout=subprocess.PIPE, text=True)
    try:
        assert child.stdout.readline().strip() == "READY"
        time.sleep(kill_after)
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()

    config = ParticleConfig(L=48, N=60, init="fixed", scale_rates=False,
                            local_kernel_sigma=0.02, periodic=True,
                            site_capacity=3)
    params = make_particle_params(config, beta=1.0, rate_diffusion=0.5,
                                  rate_active=2.0, k_on=0.0, k_off=0.0,
                                  k_exit=0.0)
    params_b = jax.tree.map(
        lambda x: np.broadcast_to(np.asarray(x, np.float32), (8,)), params)
    params_b = params_b._replace(
        beta=np.linspace(0.5, 2.5, 8).astype(np.float32))
    key = jax.random.PRNGKey(3)
    kw = dict(T=6.0, obs_dt=0.1, dt=0.02, n_tracers=8)
    straight_frames, straight_slots = jax.tree.map(np.asarray,
        run_lattice_gas_k(config, params_b, key, **kw))
    frames, slots = run_lattice_gas_k_checkpointed(
        config, params_b, key, ckpt_dir=ck, chunk_frames=3,
        mesh=sweep_mesh(8), **kw)
    _assert_frames_match_resharded(frames, straight_frames)
    np.testing.assert_array_equal(np.asarray(slots), straight_slots)
