"""fp64-class accuracy in an fp32 engine: the double-single path.

Simulates a km-baseline array (phases ~1e4 rad, where plain fp32 loses
~2e-4 relative) three ways and compares against the exact float64
direct-DFT oracle:

  1. plain fp32 (what precision=2 resolves to on the GPU),
  2. the compensated double-single direct path (eps below the fp32
     floor; complex128 output),
  3. the fp64 oracle itself (host NumPy).

Run:  python examples/fp64_accuracy.py
(on the GPU; the CPU backend realizes only part of the DS win -- see
tests/test_ds_engine.py's module docstring.)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from fftvis_tpu import TelescopeLocation, simulate_vis
from fftvis_tpu.beams import GaussianBeam
from fftvis_tpu.beams.interface import BeamInterface
from fftvis_tpu.reference.direct_engine import DirectSimulationEngine


def main():
    rng = np.random.default_rng(3)
    loc = TelescopeLocation(np.deg2rad(-30.7), np.deg2rad(21.4), 1000.0)
    ants = {
        i: np.array([*rng.uniform(-2000, 2000, 2), 0.0]) for i in range(6)
    }
    nsrc = 200
    ra = rng.uniform(0, 2 * np.pi, nsrc)
    dec = np.clip(loc.lat + rng.normal(0, 0.4, nsrc), -np.pi / 2, np.pi / 2)
    beam = GaussianBeam(diameter=2.0)  # gentle: isolates the phase error
    kw = dict(
        ants=ants,
        fluxes=rng.uniform(0.1, 1.0, (nsrc, 2)),
        ra=ra, dec=dec,
        freqs=np.array([1.4e8, 1.5e8]),
        times=2459863.2 + np.linspace(0, 0.02, 3),
        telescope_loc=loc,
        polarized=False,
    )

    oracle = DirectSimulationEngine().simulate(
        beam_list=[BeamInterface(beam)], precision=2, **kw
    )
    scale = np.abs(oracle).max()

    plain = simulate_vis(beam=beam, precision=2, **kw)
    ds = simulate_vis(beam=beam, precision=2, eps=1e-12, **kw)

    print(f"max |V| baseline span ~4 km, phases up to ~1e4 rad")
    print(f"plain fp32 : {np.abs(plain - oracle).max() / scale:.2e} "
          f"max rel error  (dtype {plain.dtype})")
    print(f"double-single: {np.abs(ds - oracle).max() / scale:.2e} "
          f"max rel error  (dtype {ds.dtype})")


if __name__ == "__main__":
    main()
