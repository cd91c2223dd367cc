"""β-sweep driver: end-to-end tiny sweep with fit + persistence round-trip."""
import numpy as np
import pytest

from hydrolim_tpu.sweeps.beta_sweep import (
    make_exp_gradient,
    sweep_beta_ensemble,
    sweep_over_betas,
)


TINY_PS = dict(L=100, xlim=1, rate_diffusion=0.02, rate_active=5, N=60,
               init="poisson", scale_rates=False, local_kernel_sigma=0.005,
               periodic=False, site_capacity=1, k_on=0, k_off=0, k_exit=0)
TINY_RUN = dict(T=2.0, obs_dt=0.2, record_fft=True, record_var=True)


def _init_kwargs(L=100, N=60):
    g = make_exp_gradient(L=L, N=N, frac_plus=0.75, decay_length=0.35,
                          anchor_positions=None)
    return dict(rho0_plus=g[0], rho0_minus=g[1])


def test_make_exp_gradient_mass_split():
    fp, fm, rp, rm = make_exp_gradient(L=200, N=100, frac_plus=0.7,
                                       decay_length=0.3,
                                       anchor_positions=(0.25, 0.6))
    assert abs(rp.sum() - 70.0) < 1e-6
    assert abs(rm.sum() - 30.0) < 1e-6
    assert fp(0.0) == rp[0]
    assert fm(0.5) == rm[100]


def test_sweep_beta_ensemble_returns_reference_tuple():
    out = sweep_beta_ensemble(1.0, n_runs=2, ps_kwargs=TINY_PS,
                              init_kwargs=_init_kwargs(),
                              run_kwargs=TINY_RUN, seed=0)
    assert len(out) == 14
    mean, std, se, v_array, out_list, *_rest = out
    assert np.isfinite(mean)
    assert v_array.shape == (2,)
    assert len(out_list) == 2
    assert out_list[0]["total_list"].shape == (10, 100)


def test_sweep_over_betas_end_to_end(tmp_path):
    betas = np.linspace(0.0, 2.0, 3)
    npz = str(tmp_path / "sweep.npz")
    save = sweep_over_betas(betas, n_runs_per_beta=2, ps_kwargs=TINY_PS,
                            init_kwargs=_init_kwargs(), run_kwargs=TINY_RUN,
                            npz_path=npz, outdir=str(tmp_path), seed=1)
    assert save["means"].shape == (3,)
    assert np.all(np.isfinite(save["means"]))
    assert np.all(np.isfinite(save["D_means"]))
    assert "popt" in save
    assert (tmp_path / "v_eff_beta_plot_theory.png").exists()
    assert (tmp_path / "D_eff_beta.png").exists()
    # run=False reload path (re-plot without re-simulating)
    save2 = sweep_over_betas(betas, run=False, npz_path=npz,
                             outdir=str(tmp_path))
    np.testing.assert_allclose(save2["means"], save["means"])


def test_plot_outs_exits_per_anchor(tmp_path):
    """Exit-dynamics sweep with anchors + binding + exits through the
    plot_outs figure pipeline (`..._sweep_beta.py:660-825`)."""
    from hydrolim_tpu.sweeps.beta_sweep import sweep_over_betas
    from hydrolim_tpu.viz.exit_plots import plot_outs

    ps = dict(L=100, xlim=1, rate_diffusion=0.3, rate_active=2, N=60,
              init="poisson", scale_rates=False, local_kernel_sigma=0.0,
              periodic=False, site_capacity=3,
              anchor_positions=[0.3, 0.7], anchor_radius=0.03,
              k_on=10.0, k_off=1.0, k_exit=5.0)
    rk = dict(T=2.0, obs_dt=0.25)
    betas = np.linspace(0.0, 2.0, 3)
    save = sweep_over_betas(betas, n_runs_per_beta=2, ps_kwargs=ps,
                            init_kwargs=_init_kwargs(), run_kwargs=rk,
                            npz_path=str(tmp_path / "s.npz"),
                            outdir=str(tmp_path), seed=5, keep_outs=True,
                            do_fit=False, plot_result=False)
    outs = save["outs"]
    # at least some exits happened somewhere in the grid
    n_exits = sum(len([t for t in out["exit_times"] if np.isfinite(t)])
                  for per_beta in outs for out in per_beta)
    assert n_exits > 0
    total_mean, total_std, region_mean, region_std = plot_outs(
        betas, 2, ps, rk, outs, outdir=str(tmp_path))
    assert total_mean.shape == (3,)
    assert region_mean.shape == (3, 2)
    assert (tmp_path / "exits_vs_beta.png").exists()


def test_double_sweep_fused_matches_loop_shapes(tmp_path):
    """Fused (N,β) grid: single-program pipeline produces per-N (f,g) fits
    and the C0/C1/C2 meta-fit."""
    from hydrolim_tpu.sweeps.double_sweep import double_sweep_fused

    res = double_sweep_fused(
        np.linspace(0, 2, 3), np.linspace(40, 120, 3), n_runs_per_beta=2,
        ps_kwargs=dict(L=150), run_kwargs=dict(T=2.0, obs_dt=0.25),
        outdir=str(tmp_path), seed=3, plot_result=False)
    assert res["f_fit"].shape == (3,)
    assert res["g_fit"].shape == (3,)
    assert np.all(np.isfinite(res["f_fit"]))
    assert np.isfinite(res["C0"]) and np.isfinite(res["C2"])
    # f decreases with density (exclusion correction weakens), like the
    # frozen reference series
    assert res["f_fit"][0] >= res["f_fit"][-1] - 0.5


def test_double_sweep_lattice_gas_engine(tmp_path):
    """The (N, β) double sweep runs on the slot engine with per-replica
    Poisson profiles (N varies only through intensities) and produces
    finite (f, g) fits."""
    import numpy as np

    from hydrolim_tpu.sweeps.double_sweep import double_sweep_fused

    r = double_sweep_fused(
        beta_values=np.linspace(0, 2, 3), list_N_part=np.array([20., 40.]),
        n_runs_per_beta=2,
        ps_kwargs=dict(L=64, N=40, rate_diffusion=0.02, rate_active=5,
                       init="poisson", scale_rates=False,
                       local_kernel_sigma=1e5 - 10, periodic=False,
                       site_capacity=1),
        run_kwargs=dict(T=1.5, obs_dt=0.25), outdir=str(tmp_path),
        plot_result=False, chunk_size=8, seed=1, engine="lattice_gas")
    assert np.isfinite([r["C0"], r["C1"], r["C2"]]).all()


def test_record_fft_flag_reaches_the_runners():
    """run_kwargs record_fft=False must actually suppress the spectra
    frames on both grid drivers (regression, round-3 review: the flag was
    declared in DEFAULT_RUN_KWARGS but never forwarded)."""
    from hydrolim_tpu.sweeps.beta_sweep import (
        run_sweep_grid,
        run_sweep_grid_lattice_gas,
    )

    rk = dict(TINY_RUN, T=0.4, record_fft=False)
    _, res, _ = run_sweep_grid(np.asarray([0.5]), 2, TINY_PS,
                               _init_kwargs(), rk, seed=0)
    assert res.frames.fft_amp.shape[-1] == 0
    _, out_for, _, frames = run_sweep_grid_lattice_gas(
        np.asarray([0.5]), 2, TINY_PS, _init_kwargs(), rk, seed=0)
    assert frames.fft_amp.shape[-1] == 0
    assert out_for(0)["fft_amp_list"] is None
    # record_pos=False drops the per-frame position block on the particle
    # engine (the (B, M, n_buf) frames dominate memory at big grids)
    rk2 = dict(TINY_RUN, T=0.4, record_pos=False)
    _, res2, _ = run_sweep_grid(np.asarray([0.5]), 2, TINY_PS,
                                _init_kwargs(), rk2, seed=0)
    assert res2.frames.pos.shape[-1] == 0


def test_double_sweep_fused_plot_result_writes_fg_figures(tmp_path):
    """plot_result=True on the fused driver writes the same f_fit/g_fit
    meta-fit figures as the loop driver (regression, round-3 review: the
    kwarg was accepted and ignored)."""
    from hydrolim_tpu.sweeps.double_sweep import double_sweep_fused

    double_sweep_fused(
        np.linspace(0, 2, 3), np.array([30., 60.]), n_runs_per_beta=2,
        ps_kwargs=dict(L=100), run_kwargs=dict(T=1.0, obs_dt=0.25),
        outdir=str(tmp_path), seed=3, plot_result=True)
    assert (tmp_path / "f_fit.png").exists()
    assert (tmp_path / "g_fit.png").exists()


def test_make_exp_gradient_golden():
    """the vectorized IC factory must be numerically
    identical to the transcribed original (values frozen 2026-08-18 from
    the pre-refactor implementation; f64 ulp tolerance covers the
    reassociated anchor-peak sum)."""
    from hydrolim_tpu.sweeps.beta_sweep import make_exp_gradient

    g = make_exp_gradient(L=1000, N=500, frac_plus=0.75, decay_length=0.35,
                          anchor_positions=(0.25, 0.60),
                          anchor_peak_width=0.01, anchor_peak_mass=0.03)
    rp, rm = g[2], g[3]
    np.testing.assert_allclose(
        rp[::250], [1.1350906447002889, 0.5556741579541512,
                    0.27202564945778773, 0.1331678878776234], rtol=1e-13)
    np.testing.assert_allclose(
        rm[::250], [0.12134985234779269, 0.1941597637564683,
                    0.12134985234779269, 0.12134985234779269], rtol=1e-13)
    np.testing.assert_allclose([rp.sum(), rm.sum()], [375.0, 125.0],
                               rtol=1e-12)
    # callable contract: scalar -> float (nearest site), arrays vectorize
    np.testing.assert_allclose(g[0](0.3337), 0.43710877432143214, rtol=1e-13)
    np.testing.assert_allclose(g[1](0.6004), 0.1941597637564683, rtol=1e-13)
    np.testing.assert_allclose(g[0](0.0), rp[0], rtol=0)
    np.testing.assert_allclose(g[1](1.0), rm[-1], rtol=0)
    arr = g[0](np.array([0.0, 0.3337]))
    assert arr.shape == (2,)
    np.testing.assert_allclose(arr, [rp[0], 0.43710877432143214], rtol=1e-13)
    # no anchors: flat minus profile
    g2 = make_exp_gradient(L=100, N=10, frac_plus=0.5, decay_length=0.2,
                           anchor_positions=None)
    assert np.ptp(g2[3]) == 0.0
