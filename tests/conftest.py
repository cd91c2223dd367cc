"""Test harness: the CPU backend with 8 virtual devices.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``); sharding tests build
their meshes from ``jax.devices('cpu')``.  The persistent compilation cache
stays off so no test writes outside its own temporary directories.
``python chip_smoke.py`` is the on-card check.
"""
import os

# APPEND to any existing XLA_FLAGS (setdefault would silently drop the
# 8-virtual-device flag when e.g. --xla_dump_to is set, and every sharding
# test would then skip while the suite still reports green)
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("HYDROLIM_NO_COMPILATION_CACHE", "1")

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session", autouse=True)
def _force_cpu():
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    yield


def cpu_devices():
    return jax.devices("cpu")
