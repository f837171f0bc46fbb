"""Coordinate chain sanity tests (ERFA-lite).

Absolute astrometric accuracy cannot be validated here (no astropy in the
environment); these tests check internal consistency, orthonormality, known
limits, and convention contracts (enu_to_az_za matching the reference's
matvis semantics at cpu_simulate.py:957).
"""

import numpy as np
import pytest

from fftvis_tpu.coords import (
    SourceRotation,
    TelescopeLocation,
    earth_rotation_angle,
    enu_to_az_za,
    icrs_to_enu_matrices,
    radec_to_icrs_vectors,
)

JD0 = 2459863.2  # arbitrary 2022 epoch
LOC = TelescopeLocation(lat=np.deg2rad(-30.72), lon=np.deg2rad(21.43), height=1050.0)


def test_matrices_orthonormal():
    jd = JD0 + np.linspace(0, 1, 7)
    mats = icrs_to_enu_matrices(jd, LOC)
    for m in mats:
        np.testing.assert_allclose(m @ m.T, np.eye(3), atol=1e-12)
        assert np.linalg.det(m) == pytest.approx(1.0, abs=1e-12)


def test_era_rate():
    """ERA advances ~ 2pi * 1.0027379 per day."""
    e0 = earth_rotation_angle(np.array([JD0]))[0]
    e1 = earth_rotation_angle(np.array([JD0 + 1.0]))[0]
    rate = (e1 - e0) % (2 * np.pi)
    expected = (2 * np.pi * 1.00273781191135448) % (2 * np.pi)
    assert rate == pytest.approx(expected, abs=1e-9)


def test_zenith_source_at_transit():
    """A source at the site latitude transits within ~1 arcmin of zenith
    (the residual is precession between ICRS and date ~ <0.4 deg over
    ~20 yr; we search the best time of day and require close zenith
    passage for a source placed at apparent coordinates)."""
    rot = SourceRotation(
        ra=np.array([0.0]),
        dec=np.array([LOC.lat]),
        times=JD0 + np.linspace(0, 0.9973, 480),
        telescope_loc=LOC,
    )
    topo = rot.topo_all_times()  # (nt, 3, 1)
    up = topo[:, 2, 0]
    # Max altitude should come close to zenith; precession/nutation offsets
    # for a J2000-coordinates source are < 0.5 deg in 2022.
    assert up.max() > np.cos(np.deg2rad(0.5))


def test_source_below_horizon():
    """A source at the opposite pole never rises."""
    rot = SourceRotation(
        ra=np.array([1.0]),
        dec=np.array([np.pi / 2]),  # north celestial pole
        times=JD0 + np.linspace(0, 1, 10),
        telescope_loc=LOC,  # southern site
    )
    up = rot.topo_all_times()[:, 2, 0]
    assert (up < 0).all()


def test_pole_source_altitude():
    """The celestial pole sits at altitude ~ |site latitude|."""
    lat = np.deg2rad(40.0)
    loc = TelescopeLocation(lat=lat, lon=0.3, height=0.0)
    rot = SourceRotation(
        ra=np.array([0.0]),
        dec=np.array([np.pi / 2]),
        times=JD0 + np.linspace(0, 1, 5),
        telescope_loc=loc,
        include_aberration=False,
    )
    up = rot.topo_all_times()[:, 2, 0]
    alt = np.arcsin(up)
    # Pole altitude equals latitude to within precession-era offsets (<0.5 deg).
    assert np.abs(alt - lat).max() < np.deg2rad(0.5)
    # The J2000 pole circles the pole of date at the precession offset
    # (~0.12 deg in 2022), so daily motion is bounded by twice that.
    assert np.ptp(alt) < np.deg2rad(0.3)


def test_aberration_magnitude():
    """Aberration shifts directions by <= ~20.5 arcsec and is smooth."""
    rot_ab = SourceRotation(
        ra=np.array([2.0]), dec=np.array([0.3]), times=[JD0], telescope_loc=LOC
    )
    rot_no = SourceRotation(
        ra=np.array([2.0]),
        dec=np.array([0.3]),
        times=[JD0],
        telescope_loc=LOC,
        include_aberration=False,
    )
    a = rot_ab.topo_all_times()[0, :, 0]
    b = rot_no.topo_all_times()[0, :, 0]
    ang = np.arccos(np.clip(a @ b, -1, 1))
    assert 0 < ang < np.deg2rad(21 / 3600)


def test_enu_to_az_za_conventions():
    # East on the horizon: astropy az = pi/2, uvbeam az = 0.
    az, za = enu_to_az_za(np.array([1.0]), np.array([0.0]), orientation="astropy")
    assert az[0] == pytest.approx(np.pi / 2)
    assert za[0] == pytest.approx(np.pi / 2)
    az, za = enu_to_az_za(np.array([1.0]), np.array([0.0]), orientation="uvbeam")
    assert az[0] == pytest.approx(0.0)
    # North: astropy az = 0, uvbeam az = pi/2.
    az, _ = enu_to_az_za(np.array([0.0]), np.array([1.0]), orientation="uvbeam")
    assert az[0] == pytest.approx(np.pi / 2)
    # Near-zenith: za ~ 0.
    _, za = enu_to_az_za(np.array([1e-8]), np.array([0.0]))
    assert za[0] == pytest.approx(0.0, abs=1e-6)


def test_enu_to_az_za_jax():
    import jax.numpy as jnp

    e = jnp.asarray([0.3, -0.2])
    n = jnp.asarray([0.1, 0.5])
    az_j, za_j = enu_to_az_za(e, n)
    az_n, za_n = enu_to_az_za(np.asarray(e), np.asarray(n))
    np.testing.assert_allclose(np.asarray(az_j), az_n, atol=1e-12)
    np.testing.assert_allclose(np.asarray(za_j), za_n, atol=1e-12)


def test_telescope_location_coercion():
    loc = TelescopeLocation.from_any((0.1, 0.2, 300.0))
    assert loc.lat == 0.1 and loc.lon == 0.2 and loc.height == 300.0

    class FakeAngle:
        def __init__(self, rad):
            self.rad = rad

    class FakeEarthLocation:
        lat = FakeAngle(0.5)
        lon = FakeAngle(-1.0)
        height = 100.0

    loc = TelescopeLocation.from_any(FakeEarthLocation())
    assert loc.lat == 0.5 and loc.lon == -1.0


def test_radec_vectors_unit_norm():
    rng = np.random.default_rng(0)
    ra = rng.uniform(0, 2 * np.pi, 50)
    dec = rng.uniform(-np.pi / 2, np.pi / 2, 50)
    v = radec_to_icrs_vectors(ra, dec)
    np.testing.assert_allclose(np.linalg.norm(v, axis=0), 1.0, atol=1e-14)


def test_gmst_j2000_literature_value():
    """GMST at J2000.0 is 280.46061837 deg (Meeus/IAU); ERFA-lite matches
    to <0.1 arcsec (residual = TT vs UT1 epoch subtleties)."""
    from fftvis_tpu.coords import gmst_2006

    g = gmst_2006(np.array([2451545.0]), np.array([0.0]))[0]
    assert abs(np.rad2deg(g) - 280.46061837) < 0.1 / 3600


def test_nutation_magnitudes():
    """Nutation stays within its physical envelope (|dpsi| < 20 arcsec)."""
    from fftvis_tpu.coords.erfa_lite import nutation_2000b_truncated

    t = np.linspace(-0.5, 0.5, 50)  # +-50 years around J2000
    dpsi, deps = nutation_2000b_truncated(t)
    arcsec = np.pi / 180 / 3600
    assert np.all(np.abs(dpsi) < 20 * arcsec)
    assert np.all(np.abs(deps) < 12 * arcsec)
    # And it actually varies (the series is alive).
    assert np.ptp(dpsi) > 5 * arcsec


def test_mean_obliquity_j2000():
    from fftvis_tpu.coords import mean_obliquity

    eps0 = mean_obliquity(np.array([0.0]))[0]
    assert abs(eps0 - np.deg2rad(84381.406 / 3600)) < 1e-12


def test_precession_fw_angles_iau2006_literature():
    """Fukushima-Williams precession angles vs published IAU2006 rates.

    psi_bar ~ 5038.481507" t and eps_A ~ 84381.406" - 46.836769" t are the
    standard IAU2006 linear coefficients (Hilton et al. 2006); checking at
    t = 0.1 century keeps quadratic terms below the tolerance. Anchors the
    composed-chain golden snapshot (below) to absolute values.
    """
    from fftvis_tpu.coords.erfa_lite import ARCSEC, precession_fw_angles

    t = 0.1  # Julian centuries TT since J2000
    gam, phi, psi, eps = (np.asarray(a).item() for a in precession_fw_angles(np.array([t])))
    assert abs(psi / ARCSEC - 5038.481507 * t) < 0.05
    assert abs(eps / ARCSEC - (84381.406 - 46.836769 * t)) < 0.05
    assert abs(gam / ARCSEC - (-0.052928 + 10.556403 * t)) < 0.05
    assert abs(phi / ARCSEC - (84381.412819 - 46.811016 * t)) < 0.05


def test_golden_coordinate_chain_snapshot():
    """Composed ICRS->ENU chain matches the checked-in golden snapshot.

    Drift detection for erfa_lite: any numerical
    change to precession/nutation/ERA/site-basis composition beyond 0.01
    arcsec fails here, with no astropy needed at test time. Regenerate
    deliberately with tests/data/make_golden_coords.py.
    """
    import os

    from fftvis_tpu.coords.erfa_lite import (
        TelescopeLocation,
        aberration_velocities,
        icrs_to_enu_matrices,
    )

    path = os.path.join(os.path.dirname(__file__), "data", "golden_coords.npz")
    gold = np.load(path)
    jds = gold["jds"]
    sites = {
        "hera": TelescopeLocation(np.deg2rad(-30.721), np.deg2rad(21.428), 1051.0),
        "vla": TelescopeLocation(np.deg2rad(34.0784), np.deg2rad(-107.6184), 2124.0),
        "pole": TelescopeLocation(np.deg2rad(-89.99), 0.0, 2835.0),
        "equator": TelescopeLocation(0.0, np.deg2rad(120.0), 0.0),
    }
    tol = 0.01 * np.pi / 180 / 3600  # 0.01 arcsec
    for name, loc in sites.items():
        got = icrs_to_enu_matrices(jds, loc)
        want = gold[f"mat_{name}"]
        # Angular deviation between rotations: |R1 R2^T - I| ~ rotation angle.
        for g, w in zip(got, want):
            delta = g @ w.T - np.eye(3)
            angle = np.sqrt((delta**2).sum() / 2.0)
            assert angle < tol, f"{name}: drift {angle / (np.pi/180/3600):.4f} arcsec"
    np.testing.assert_allclose(
        aberration_velocities(jds), gold["abvel"], rtol=0, atol=1e-9
    )


class TestHorizonCull:
    """cull_never_visible edge cases (the engine-level oracle test covers
    the happy path; these pin the contract)."""

    def _rot(self, dec, times=None):
        import numpy as np

        from fftvis_tpu.coords.rotation import SourceRotation

        lat = np.deg2rad(-30.72)
        loc = (lat, np.deg2rad(21.43), 1000.0)
        from fftvis_tpu import TelescopeLocation

        ra = np.linspace(0, 2 * np.pi, len(dec), endpoint=False)
        # Default: a full sidereal day, so visibility depends on dec only
        # (every RA culminates); pass short windows to test RA-dependence.
        t = times if times is not None else 2459863.2 + np.linspace(0, 1.0, 25)
        return SourceRotation(ra, np.asarray(dec), t, TelescopeLocation(*loc))

    def test_none_dropped_returns_none(self):
        import numpy as np

        rot = self._rot(np.full(8, np.deg2rad(-30.0)))  # near zenith
        assert rot.cull_never_visible() is None
        assert rot.nsrc == 8

    def test_never_risers_dropped(self):
        import numpy as np

        # Northern circumpolar-invisible cap for a -30.7 deg site.
        dec = np.concatenate(
            [np.full(5, np.deg2rad(85.0)), np.full(5, np.deg2rad(-30.0))]
        )
        rot = self._rot(dec)
        keep = rot.cull_never_visible()
        assert keep is not None
        assert keep.sum() == 5 and rot.nsrc == 5
        assert not keep[:5].any() and keep[5:].all()

    def test_all_culled_keeps_one(self):
        import numpy as np

        rot = self._rot(np.full(4, np.deg2rad(89.0)))
        keep = rot.cull_never_visible()
        assert keep is not None and keep.sum() == 1 and rot.nsrc == 1

    def test_short_window_culls_by_hour_angle(self):
        import numpy as np

        # Over a 15-minute window, equal-dec sources at the wrong hour
        # angle never rise and must be culled; the cull is window-aware.
        rot = self._rot(
            np.full(8, np.deg2rad(-30.0)),
            times=2459863.2 + np.linspace(0, 0.01, 3),
        )
        keep = rot.cull_never_visible()
        assert keep is not None and 0 < keep.sum() < 8

    def test_margin_is_a_keep_side_guard(self):
        import numpy as np

        # Max altitude ~ -0.05 rad (never rises): culled at the default
        # margin, kept when the margin covers the deficit -- the margin
        # errs toward KEEPING sources (it absorbs aberration/fp32 jitter).
        lat = np.deg2rad(-30.72)
        dec = np.array([lat + np.pi / 2 + 0.05])
        rot = self._rot(dec)
        assert rot.cull_never_visible(margin=0.1) is None
        rot2 = self._rot(dec)
        keep = rot2.cull_never_visible(margin=2e-3)
        assert keep is not None and keep.sum() == 1  # keeps-one floor
