"""Tracing / profiling hooks (SURVEY.md §5).

The reference reports progress via bare prints; here the framework exposes
first-class performance instrumentation:

- :class:`PhaseTimer` — wall-clock per-phase timers with a summary table,
- :func:`trace` — context manager around ``jax.profiler`` for device traces,
- :func:`throughput` — particle-steps/sec (and friends) counters from timed
  step closures, the metric family of BASELINE.json.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict

import jax


@dataclass
class PhaseTimer:
    """Accumulating named phase timers.

    >>> timer = PhaseTimer()
    >>> with timer("simulate"): ...
    >>> timer.summary()
    """

    totals: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        lines = [f"{'phase':<24}{'calls':>8}{'total_s':>12}{'mean_ms':>12}"]
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<24}{n:>8}{tot:>12.3f}{1e3 * tot / n:>12.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str = "hydrolim_trace"):
    """Capture a device trace viewable in TensorBoard/XProf."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def throughput(step_fn: Callable[[], None], *, items_per_call: float,
               warmup: int = 1, reps: int = 5) -> Dict[str, float]:
    """Time a blocking step closure and report items/sec (e.g.
    particle-steps/sec/chip: items = B·N·K_steps)."""
    for _ in range(warmup):
        step_fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        step_fn()
        times.append(time.perf_counter() - t0)
    best = min(times)
    return {"items_per_sec": items_per_call / best, "best_s": best,
            "mean_s": sum(times) / len(times)}


def card_name_and_power() -> str:
    """``name, power.limit`` of each visible NVIDIA card, one per line, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them; "nvidia-smi not available" where it cannot be run.  A card
    set below its maximum power runs slower under load, so every device
    number is reported beside this line."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"
    return out.stdout.strip()
