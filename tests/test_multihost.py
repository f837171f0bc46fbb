"""Two-process multi-host simulation test.

This spawns TWO separate processes on localhost, each with 4 forced CPU
devices, joined via ``jax.distributed`` (``init_distributed``) into one
8-device global runtime -- the CPU-rig analogue of a 2-host GPU cluster
(the reference's equivalent surface is the Ray localhost fan-out,
ref cpu_simulate.py:714-837, tests/test_cpu_simulate.py:1090).

Each process runs the SAME polarized simulation two ways and compares:
  1. sharded over a (2 time x 2 freq x 2 source) mesh spanning BOTH
     processes (engine multiproc path: global-array inputs, psum over the
     source axis, output allgathered to every host);
  2. single-device, process-local.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_platform_name", "cpu")
import numpy as np

sys.path.insert(0, os.environ["FFTVIS_REPO"])
from fftvis_tpu import TelescopeLocation, simulate_vis
from fftvis_tpu.beams import GaussianBeam
from fftvis_tpu.parallel import init_distributed, make_mesh

port = os.environ["FFTVIS_MH_PORT"]
pid = int(sys.argv[1])
init_distributed(
    coordinator_address=f"localhost:{port}", num_processes=2, process_id=pid
)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 8, jax.device_count()
assert jax.local_device_count() == 4, jax.local_device_count()

rng = np.random.default_rng(0)
loc = TelescopeLocation(np.deg2rad(-30.7), np.deg2rad(21.4), 1000.0)
ants = {i: np.array([*rng.uniform(-50, 50, 2), 0.0]) for i in range(4)}
nsrc = 24
kw = dict(
    ants=ants,
    fluxes=rng.uniform(0.1, 1, (nsrc, 2)),
    ra=rng.uniform(0, 2 * np.pi, nsrc),
    dec=np.clip(loc.lat + rng.normal(0, 0.5, nsrc), -np.pi / 2, np.pi / 2),
    freqs=np.linspace(1e8, 1.1e8, 2),
    times=2459863.2 + np.linspace(0, 0.02, 4),
    beam=GaussianBeam(diameter=12.0),
    telescope_loc=loc,
    polarized=True,
    precision=2,
)
mesh = make_mesh(time=2, freq=2, source=2)
procs = sorted({d.process_index for d in mesh.devices.flat})
assert procs == [0, 1], procs  # the mesh genuinely spans both hosts

v_sharded = simulate_vis(backend="tpu", mesh=mesh, **kw)
v_local = simulate_vis(backend="tpu", **kw)
scale = np.abs(v_local).max()
err = np.abs(v_sharded - v_local).max() / scale
assert err < 1e-11, f"sharded != local: {err:.3e}"
print(f"MULTIHOST_OK p{pid} err={err:.2e}", flush=True)
"""


def test_two_process_multihost_equals_single():
    # Reserve a coordinator port.
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device count
    env["FFTVIS_MH_PORT"] = str(port)
    env["FFTVIS_REPO"] = repo
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(pid)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out:\n" + "\n".join(outs))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
        assert "MULTIHOST_OK" in out, out
