"""Unified command-line launcher: ``python -m hydrolim_tpu <command> ...``.

Thin dispatch onto the committed experiment drivers (``experiments/``), so
every driver works from any cwd without path fiddling.  ``--help`` on any
command shows that driver's own flags (``--small``, ``--engine``,
``--n-devices``, ``--ckpt-dir``, ...).

Commands map 1:1 onto the reference repo's runnable scripts (see
docs/MIGRATION.md) plus the beyond-reference science drivers.
"""
from __future__ import annotations

import os
import sys

_COMMANDS = {
    "beta-sweep": ("run_particle_beta_sweep", "particle β-sweep (flagship)"),
    "sigma-sweep": ("run_particle_sigma_sweep", "(σ, β) double sweep"),
    "double-sweep": ("run_particle_double_sweep",
                     "(N, β) sweep + C0/C1/C2 meta-fit"),
    "local-structure": ("run_particle_local_structure",
                        "pattern-formation β-sweep"),
    "particle-single": ("run_particle_single", "single K=3 particle run"),
    "anchored-exits": ("run_anchored_exits", "bind/unbind/exit channels"),
    "pde": ("run_pde_experiments", "PDE single/beta/magn/magn2"),
    "cross-engine": ("run_cross_engine_validation",
                     "particle↔PDE comparison figure"),
    "real-data": ("run_real_data_fit", "kinesin-II χ² fit"),
    "convergence": ("run_convergence", "hydrodynamic-limit rate (N^-1/2)"),
    "critical-scaling": ("run_critical_scaling",
                         "critical fluctuation exponent"),
    "large-lattice": ("run_large_lattice", "L=65536 sharded lattice"),
    "pde-phase-diagram": ("run_pde_phase_diagram",
                          "(β, σ) PDE phase plane, 1024 replicas"),
    "particle-phase-diagram": ("run_particle_phase_diagram",
                               "(β, σ) particle phase plane + "
                               "micro↔macro boundary overlay"),
    "ckpt-overhead": ("measure_ckpt_overhead",
                      "checkpointing wall-time overhead"),
}


def _experiments_dir() -> str:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(here, "experiments")


def _usage() -> str:
    lines = ["usage: python -m hydrolim_tpu <command> [driver args...]", "",
             "commands:"]
    for name, (_, desc) in _COMMANDS.items():
        lines.append(f"  {name:<23} {desc}")
    lines.append("")
    lines.append("e.g.: python -m hydrolim_tpu beta-sweep --small "
                 "--engine lattice_gas")
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_usage())
        return 0
    cmd = argv[0]
    if cmd not in _COMMANDS:
        print(f"unknown command {cmd!r}\n\n{_usage()}", file=sys.stderr)
        return 2
    module_name, _ = _COMMANDS[cmd]
    path = os.path.join(_experiments_dir(), module_name + ".py")
    if not os.path.exists(path):
        print(f"driver not found: {path}", file=sys.stderr)
        return 2
    import runpy

    # the drivers parse sys.argv under `if __name__ == "__main__"` — run
    # them exactly as the script invocation would
    sys.argv = [path] + argv[1:]
    runpy.run_path(path, run_name="__main__")
    return 0


if __name__ == "__main__":
    sys.exit(main())
