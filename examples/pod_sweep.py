"""Multi-device sweep pattern: mesh sharding + block checkpointing.

Demonstrates the intended production shape for large (nfreq x ntime)
parameter sweeps (BASELINE config 5: SKA-low-like 512 stations, 1000 freqs
x 100 times on a multi-GPU cluster):

  - a (time, source) device mesh: time blocks data-parallel, the source
    axis sharded with one psum of the NUFFT fine grid per (time, freq);
  - `simulate_vis_checkpointed` persisting each finished (time, freq) block
    so a preempted sweep resumes where it stopped.

Run (any host; scales the workload down automatically):
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/pod_sweep.py
For a multi-host cluster, call fftvis_tpu.parallel.mesh.init_distributed()
first and raise the sizes.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax

from fftvis_tpu import TelescopeLocation
from fftvis_tpu.beams import GaussianBeam
from fftvis_tpu.checkpoint import simulate_vis_checkpointed
from fftvis_tpu.geometry import hex_array
from fftvis_tpu.parallel.mesh import make_mesh


def main():
    ndev = len(jax.devices())
    tdev = max(1, ndev // 2)
    sdev = 2 if ndev >= 2 else 1
    mesh = make_mesh(time=tdev, source=sdev)
    print(f"mesh: {tdev} time x {sdev} source over {ndev} devices")

    rng = np.random.default_rng(0)
    ants = hex_array(3)
    loc = TelescopeLocation(np.deg2rad(-30.72), np.deg2rad(21.43), 1050.0)
    nsrc = 2000
    ra = rng.uniform(0, 2 * np.pi, nsrc)
    dec = np.arcsin(rng.uniform(-1, 1, nsrc))
    freqs = np.linspace(1.0e8, 1.2e8, 4)
    times = 2459863.2 + np.linspace(0, 0.05, 2 * tdev)
    flux = rng.uniform(0.1, 1.0, (nsrc, freqs.size))

    vis = simulate_vis_checkpointed(
        checkpoint_dir="/tmp/fftvis_sweep_ckpt",
        time_block=tdev,  # one mesh-width of times per block
        freq_block=2,
        overwrite=True,
        ants=ants,
        fluxes=flux,
        ra=ra,
        dec=dec,
        freqs=freqs,
        times=times,
        beam=GaussianBeam(diameter=14.0),
        telescope_loc=loc,
        polarized=False,
        mesh=mesh,
    )
    print(f"sweep complete: {vis.shape}, finite={np.isfinite(vis).all()}")


if __name__ == "__main__":
    main()
