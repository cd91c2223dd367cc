"""CI-time smoke of the large-lattice spatial-sharding driver: the --small
mode must run end-to-end on a virtual CPU 'space' mesh,
pass its built-in physics asserts (exact particle conservation, m(β) vs
the tanh fixed point, PDE mass conservation and CW reaction-rate law), and
produce the figure + wall-time record."""
import json
import os
import pathlib
import subprocess
import sys


def test_run_large_lattice_small(tmp_path):
    _run_driver(tmp_path, grid=False)


def test_run_large_lattice_small_grid_mesh(tmp_path):
    """--grid composes replica DP ('sweep' of 2) with lattice sharding
    ('space' of 4) on one 2-D grid_mesh; same physics asserts."""
    _run_driver(tmp_path, grid=True)


def _run_driver(tmp_path, *, grid: bool):
    driver = pathlib.Path(__file__).parent.parent / "experiments" / \
        "run_large_lattice.py"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, str(driver), "--small", "--n-devices", "8",
         "--outdir", str(tmp_path)] + (["--grid"] if grid else []),
        capture_output=True, text=True, timeout=560, env=env,
        cwd=str(driver.parent.parent))
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads((tmp_path / "wall_time.json").read_text())
    assert rec["n_devices"] == 8
    assert rec["particle_mesh"] == ("2d-grid" if grid else "1d-space")
    assert (tmp_path / "large_lattice_overview.png").stat().st_size > 10_000
    # the driver's own asserts already enforce the physics; re-check the
    # headline numbers made it into the record
    assert abs(rec["particle"]["m_super"] - rec["particle"]["m_theory"]) < 0.05
    for r in rec["pde"]["rates"].values():
        assert abs(r["measured"] - r["theory"]) < 0.15 * abs(r["theory"]) + 1e-3
