"""Generate golden coordinate-chain snapshots (drift detection).

Run from the repo root. The snapshot pins the composed ICRS->ENU rotation
chain (precession + nutation + ERA + polar site basis) and the annual
aberration velocities at fixed epochs/sites, so any numerical drift in
coords/erfa_lite.py fails tests/test_coords.py without needing astropy in
the test environment. Absolute correctness is separately anchored by
literature-value tests (GMST, obliquity, precession rate, aberration
constant) and by the reference's own tolerance chain.

If astropy/pyerfa ever become available, regenerate with them instead and
tighten the tolerance .
"""

import numpy as np

from fftvis_tpu.coords.erfa_lite import (
    TelescopeLocation,
    aberration_velocities,
    icrs_to_enu_matrices,
)

SITES = [
    ("hera", np.deg2rad(-30.721), np.deg2rad(21.428), 1051.0),
    ("vla", np.deg2rad(34.0784), np.deg2rad(-107.6184), 2124.0),
    ("pole", np.deg2rad(-89.99), 0.0, 2835.0),
    ("equator", 0.0, np.deg2rad(120.0), 0.0),
]
JDS = np.array(
    [2451545.0, 2455197.5, 2459863.2, 2460676.75, 2466154.3], dtype=float
)

mats = {}
for name, lat, lon, h in SITES:
    loc = TelescopeLocation(lat, lon, h)
    mats[f"mat_{name}"] = icrs_to_enu_matrices(JDS, loc)
mats["abvel"] = aberration_velocities(JDS)
mats["jds"] = JDS
np.savez_compressed("tests/data/golden_coords.npz", **mats)
print("wrote tests/data/golden_coords.npz")
