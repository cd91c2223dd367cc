"""CI-time smokes of the two (β × σ) phase-diagram drivers: --small runs a
tiny grid on CPU; the particle driver's own check_physics asserts the
ordered/disordered phases and the mean-field β_c bracket (the PDE driver
defers its pins to the full grid), and the tests re-assert the mean-field
row endpoints from the saved JSON."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).parent.parent


def _run(driver, tmp_path, extra=()):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, str(ROOT / "experiments" / driver), "--small",
         "--outdir", str(tmp_path), *extra],
        capture_output=True, text=True, timeout=560, env=env, cwd=str(ROOT))
    assert out.returncode == 0, (out.stdout[-1500:], out.stderr[-2000:])
    return out


def test_run_particle_phase_diagram_small(tmp_path):
    _run("run_particle_phase_diagram.py", tmp_path)
    rec = json.loads((tmp_path / "particle_phase_diagram.json").read_text())
    m = np.asarray(rec["m"])
    assert m.shape == (3, 6)
    # mean-field (global-m) row: disordered at beta=0, ordered at beta=3
    assert m[-1, 0] < 0.3 and m[-1, -1] > 0.7
    assert (tmp_path / "particle_phase_diagram.png").stat().st_size > 10_000
    # the record holds physics only: no engine routing, no device rates
    assert not {"engine", "engines_used"} & set(rec)


def test_run_pde_phase_diagram_small(tmp_path):
    """Structural smoke only: the --small grid (T=0.5, 500 steps) is too
    short for the PDE to order from noise — the physics pins live in
    check_physics, which the driver runs on the full grid (and the
    committed docs/figures/phase_diagram/pde_phase_diagram.json passed)."""
    _run("run_pde_phase_diagram.py", tmp_path)
    rec = json.loads((tmp_path / "pde_phase_diagram.json").read_text())
    m = np.asarray(rec["m"])
    assert m.shape == (3, 6)
    assert np.isfinite(m).all() and (m >= 0).all() and (m <= 1).all()
    assert np.isfinite(np.asarray(rec["band"])).all()
    assert (tmp_path / "pde_phase_diagram.png").stat().st_size > 10_000
    # the committed full-grid JSON keeps passing the driver's own pins
    full = (ROOT / "docs" / "figures" / "phase_diagram"
            / "pde_phase_diagram.json")
    sys.path.insert(0, str(ROOT / "experiments"))
    try:
        from run_pde_phase_diagram import check_physics
    finally:
        sys.path.pop(0)
    check_physics(json.loads(full.read_text()))


def test_crossing_curve_unit():
    sys.path.insert(0, str(ROOT / "experiments"))
    try:
        from run_particle_phase_diagram import crossing_curve
    finally:
        sys.path.pop(0)
    beta = np.array([0.0, 1.0, 2.0, 3.0])
    rows = [[0.0, 0.25, 0.75, 1.0],     # crosses 0.5 midway between 1 and 2
            [0.0, 0.1, 0.2, 0.3],       # never orders -> NaN
            [0.9, 0.9, 0.9, 0.9]]       # already above at beta=0 -> NaN
    c = crossing_curve(beta, rows)
    assert np.isclose(c[0], 1.5)
    assert np.isnan(c[1]) and np.isnan(c[2])
