"""Multi-process distributed backend (SURVEY.md §5 distributed-backend row):
a REAL 2-process JAX cluster (gloo CPU collectives, 4 virtual devices per
process = 8 global devices) initialized through
``parallel.distributed.initialize_multihost``, running a lattice-gas step
with the lattice axis sharded across BOTH processes — the halo exchange
crosses the process boundary — and matching the single-process result
bit-for-bit."""
import os
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import sys
pid, port = int(sys.argv[1]), sys.argv[2]
repo = sys.argv[3]
sys.path.insert(0, repo)
import jax
jax.config.update("jax_num_cpu_devices", 4)
jax.config.update("jax_cpu_collectives_implementation", "gloo")
from hydrolim_tpu.parallel.distributed import (
    global_sweep_mesh, initialize_multihost, is_primary)
initialize_multihost(f"localhost:{port}", 2, pid)
import numpy as np, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from hydrolim_tpu.core.config import ParticleConfig, make_particle_params
from hydrolim_tpu.fields.magnetization import build_mfield_op
from hydrolim_tpu.particles.lattice_gas import lg_step

assert jax.process_count() == 2 and len(jax.devices()) == 8
config = ParticleConfig(L=256, N=128, init="fixed", scale_rates=False,
                        local_kernel_sigma=0.0, periodic=True,
                        site_capacity=1, active_model="plus_forward")
params = make_particle_params(config, beta=1.0, rate_diffusion=1.0,
                              rate_active=2.0)
op = build_mfield_op(config.L, config.dx, 0.0, True)
rng = np.random.default_rng(0)
occ_host = rng.choice([-1, 0, 1], size=256).astype(np.int32)
mesh = global_sweep_mesh("space")
sh = NamedSharding(mesh, P("space"))
occ = jax.make_array_from_callback((256,), sh, lambda i: occ_host[i])

@jax.jit
def steps(occ, key):
    def body(c, k):
        o, _ = lg_step(config, params, op, c, k, 5e-3)
        return o, ()
    occ, _ = jax.lax.scan(body, occ, jax.random.split(key, 50))
    return occ

out = steps(occ, jax.random.PRNGKey(7))
# gather the full global result on every process
rep = jax.jit(lambda x: x + 0, out_shardings=NamedSharding(mesh, P()))(out)
digest = np.asarray(rep)
print("DIGEST", int((digest * np.arange(1, 257)).sum()),
      int(np.abs(digest).sum()), "PRIMARY", is_primary(), flush=True)
"""


def _gloo_available():
    code = ("import jax;"
            "jax.config.update('jax_cpu_collectives_implementation','gloo')")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True)
    return r.returncode == 0


pytestmark = pytest.mark.skipif(not _gloo_available(),
                                reason="gloo CPU collectives unavailable")


def test_two_process_cluster_lattice_gas_matches_single():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("PYTHONPATH", None)
    env.pop("XLA_FLAGS", None)      # workers set jax_num_cpu_devices=4
    port = "12641"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(i), port, repo], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    digests = []
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-2000:]
        line = [ln for ln in so.splitlines() if ln.startswith("DIGEST")][0]
        digests.append(tuple(int(x) for x in line.split()[1:3]))
    # both processes observe the same global state
    assert digests[0] == digests[1]

    # single-process reference (same key; threefry is partitionable, so the
    # sharded run must be bit-identical)
    import jax
    from hydrolim_tpu.core.config import ParticleConfig, make_particle_params
    from hydrolim_tpu.fields.magnetization import build_mfield_op
    from hydrolim_tpu.particles.lattice_gas import lg_step

    config = ParticleConfig(L=256, N=128, init="fixed", scale_rates=False,
                            local_kernel_sigma=0.0, periodic=True,
                            site_capacity=1, active_model="plus_forward")
    params = make_particle_params(config, beta=1.0, rate_diffusion=1.0,
                                  rate_active=2.0)
    op = build_mfield_op(config.L, config.dx, 0.0, True)
    rng = np.random.default_rng(0)
    occ = jax.numpy.asarray(rng.choice([-1, 0, 1], size=256).astype(np.int32))

    def body(c, k):
        o, _ = lg_step(config, params, op, c, k, 5e-3)
        return o, ()
    out, _ = jax.lax.scan(body, occ, jax.random.split(jax.random.PRNGKey(7),
                                                      50))
    ref = np.asarray(out)
    assert digests[0] == (int((ref * np.arange(1, 257)).sum()),
                          int(np.abs(ref).sum()))
