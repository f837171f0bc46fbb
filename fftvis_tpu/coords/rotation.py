"""Source coordinate rotation: host planning + device application.

Replaces matvis's CoordinateRotation lifecycle (setup/rotate/select_chunk;
ref /root/reference/src/fftvis/core/simulate.py:13 and cpu_simulate.py:
693-709, 937-945) with a host/device split:

  - host (this module, float64 NumPy): per-time 3x3 ICRS->ENU matrices and
    aberration velocity vectors -- O(ntimes) tiny work;
  - device (:func:`rotate_to_topo`, jnp): one batched matmul over all
    sources, plus a horizon *mask* instead of the reference's dynamic
    above-horizon compaction (cpu_simulate.py:940-945), keeping all shapes
    static under jit.
"""

from __future__ import annotations

import numpy as np

from .erfa_lite import (
    TelescopeLocation,
    aberration_velocities,
    icrs_to_enu_matrices,
    radec_to_icrs_vectors,
    times_to_jd,
)

# Registry of coordinate methods. Both reference names map onto the same
# ERFA-lite implementation; "simple" drops precession/nutation/aberration
# (pure sidereal spin) for synthetic tests.
COORD_METHODS = ("CoordinateRotationERFA", "CoordinateRotationAstropy", "simple")


class SourceRotation:
    """Precomputed per-time rotation data for a source catalog.

    Parameters
    ----------
    ra, dec
        ICRS coordinates in radians.
    times
        Julian dates (UTC) or an astropy-Time-like object.
    telescope_loc
        Anything :meth:`TelescopeLocation.from_any` accepts.
    coord_method
        One of :data:`COORD_METHODS`.
    """

    def __init__(
        self,
        ra: np.ndarray,
        dec: np.ndarray,
        times,
        telescope_loc,
        coord_method: str = "CoordinateRotationERFA",
        include_aberration: bool = True,
    ):
        if coord_method not in COORD_METHODS:
            raise ValueError(
                f"Unknown coord_method {coord_method!r}; valid: {COORD_METHODS}"
            )
        self.location = TelescopeLocation.from_any(telescope_loc)
        self.jd = times_to_jd(times)
        self.eq_vectors = radec_to_icrs_vectors(
            np.asarray(ra, dtype=float), np.asarray(dec, dtype=float)
        )  # (3, nsrc) float64

        if coord_method == "simple":
            self.matrices = _simple_spin_matrices(self.jd, self.location)
            self.aberration = None
        else:
            self.matrices = icrs_to_enu_matrices(self.jd, self.location)
            self.aberration = (
                aberration_velocities(self.jd) if include_aberration else None
            )

    @property
    def ntimes(self) -> int:
        return self.matrices.shape[0]

    @property
    def nsrc(self) -> int:
        return self.eq_vectors.shape[1]

    def cull_never_visible(self, margin: float = 2e-3):
        """Drop sources below the horizon at EVERY simulated time.

        The reference compacts above-horizon sources dynamically per chunk
        (ref cpu_simulate.py:940-945); static shapes forbid that under jit,
        but sources whose zenith-cosine stays < -margin for every planned
        time contribute exactly zero (the device mask kills them) and can
        be dropped from the catalog before planning -- for a full-sky
        catalog and a short observation that is ~45-50% of all sources.
        ``margin`` covers aberration (<= 1e-4) plus device-fp32 jitter.

        Filters ``eq_vectors`` in place; returns the boolean keep mask
        (indexed on the original catalog) or None if nothing was dropped.
        """
        zmax = np.full(self.nsrc, -np.inf)
        for t in range(self.ntimes):
            np.maximum(zmax, self.matrices[t, 2] @ self.eq_vectors, out=zmax)
        keep = zmax > -margin
        if keep.all():
            return None
        if not keep.any():
            keep[0] = True  # keep one (masked) source: zero-size planning
        self.eq_vectors = self.eq_vectors[:, keep]
        return keep

    def topo_all_times(self) -> np.ndarray:
        """Host-side reference path: (nt, 3, nsrc) ENU unit vectors."""
        eq = self.eq_vectors
        if self.aberration is not None:
            eq = eq[None] + self.aberration[:, :, None]
            eq = eq / np.linalg.norm(eq, axis=1, keepdims=True)
            return np.einsum("tij,tjs->tis", self.matrices, eq)
        return np.einsum("tij,js->tis", self.matrices, eq)

    def topo_at(self, t: int, eq: np.ndarray | None = None) -> np.ndarray:
        """Topocentric ENU vectors at one time, replaying the DEVICE chain
        (aberration add + renormalize + rotate) in float64.

        Capacity planners use this so their occupancy bounds see exactly the
        grid positions the device will produce (modulo fp32 jitter, covered
        by the planners' fixed cell margins); omitting the aberration term
        displaces sources by ~1e-4 direction-cosine, which on fine grids can
        exceed a fixed few-cell margin. ``eq`` defaults to the catalog
        vectors but may be a padded (3, n) array.
        """
        eq = self.eq_vectors if eq is None else eq
        if self.aberration is not None:
            eq = eq + self.aberration[t][:, None]
            eq = eq / np.linalg.norm(eq, axis=0, keepdims=True)
        return self.matrices[t] @ eq


def _simple_spin_matrices(jd: np.ndarray, loc: TelescopeLocation) -> np.ndarray:
    """Sidereal-spin-only ENU matrices (no precession): for synthetic tests."""
    from .erfa_lite import earth_rotation_angle, enu_basis, _r3

    gast = earth_rotation_angle(jd)
    return np.einsum(
        "ij,tjk->tik", enu_basis(loc.lat, loc.lon), _r3(gast)
    )


def enu_to_az_za(enu_e, enu_n, orientation: str = "uvbeam"):
    """Angle-cosine ENU components -> (az, za).

    Matches matvis.coordinates.enu_to_az_za semantics (used at ref
    cpu_simulate.py:957): za is computed from the horizontal components only
    (below-horizon directions clamp to za = pi/2), and the "uvbeam"
    orientation measures azimuth from East toward North.

    Works on NumPy or JAX arrays (uses the arrays' own namespace).
    """
    xp = _namespace_of(enu_e)
    lsqr = enu_e**2 + enu_n**2
    zeta = xp.sqrt(xp.clip(1.0 - lsqr, 0.0, None))
    az = xp.arctan2(enu_e, enu_n)
    za = xp.pi / 2 - xp.arcsin(zeta)
    if orientation == "uvbeam":
        az = xp.pi / 2 - az
    elif orientation != "astropy":
        raise ValueError("orientation must be 'uvbeam' or 'astropy'")
    return az % (2 * xp.pi), za


def _namespace_of(x):
    import jax.numpy as jnp

    return jnp if not isinstance(x, np.ndarray) and not np.isscalar(x) else np
