"""CI-time smoke of the hydrodynamic-limit convergence driver: --small runs
a 3-point N ladder against the matched PDE and the driver's own asserts
enforce the CLT rate (slope within (-0.75, -0.25) for both observables)."""
import json
import os
import pathlib
import subprocess
import sys


def test_run_convergence_small(tmp_path):
    driver = pathlib.Path(__file__).parent.parent / "experiments" / \
        "run_convergence.py"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, str(driver), "--small", "--outdir", str(tmp_path)],
        capture_output=True, text=True, timeout=560, env=env,
        cwd=str(driver.parent.parent))
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads((tmp_path / "convergence.json").read_text())
    assert -0.75 < rec["slope_m"] < -0.25
    assert -0.75 < rec["slope_rho"] < -0.25
    # errors strictly decrease along the ladder at these small N
    assert rec["err_m"][0] > rec["err_m"][-1]
    assert rec["err_rho"][0] > rec["err_rho"][-1]
    assert (tmp_path / "convergence.png").stat().st_size > 10_000
