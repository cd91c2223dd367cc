"""CI-time smoke of the critical-fluctuation-scaling driver: --small runs
the N ladder at beta in {0.5, 1.0} and the driver's own asserts enforce
the two laws (RMS m ~ N^-1/2 subcritical, ~ N^-1/4 critical)."""
import json
import os
import pathlib
import subprocess
import sys


def test_run_critical_scaling_small(tmp_path):
    driver = pathlib.Path(__file__).parent.parent / "experiments" / \
        "run_critical_scaling.py"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, str(driver), "--small", "--outdir", str(tmp_path)],
        capture_output=True, text=True, timeout=560, env=env,
        cwd=str(driver.parent.parent))
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads((tmp_path / "critical_scaling.json").read_text())
    assert -0.62 < rec["slope_subcritical"] < -0.38
    assert -0.35 < rec["slope_critical"] < -0.15
    # the critical fluctuation is anomalously LARGE at every N
    for m_sub, m_cr in zip(rec["rms_mean"]["0.5"], rec["rms_mean"]["1.0"]):
        assert m_cr > 2 * m_sub
    assert (tmp_path / "critical_scaling.png").stat().st_size > 10_000
