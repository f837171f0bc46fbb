"""External-truth anchors for the ERFA-lite coordinate chain.

``coords/erfa_lite.py`` was validated only by
self-generated golden snapshots (drift detection) and literature-constant
spot checks; the in-repo direct-DFT oracle SHARES the chain, so a
systematic error (wrong nutation sign, transposed precession matrix, bad
equation of equinoxes) was invisible to every oracle cross-check.

astropy/pyerfa are not installable in this image, so this file anchors the
chain two independent ways:

1. **A from-scratch second implementation** built from *different published
   models* with a *different formulation*: IAU 1976 precession (Lieske
   equatorial angles zeta/z/theta, not Fukushima-Williams), IAU 1980
   nutation (Wahr series, not IAU 2000B), IAU 1982 GMST (not
   ERA + IAU 2006 polynomial), first-order frame bias, and spherical-trig
   hour-angle alt/az (not an ENU matrix composition). The two chains share
   no code and no coefficient tables; published inter-model differences
   are < 0.2 arcsec within ~40 years of J2000, so a <= 1 arcsec gate
   catches any implementation error while tolerating the model gap.

2. **Published worked examples** (Jean Meeus, *Astronomical Algorithms*,
   2nd ed.) embedded as literal constants: Ex 12.a (Greenwich mean +
   apparent sidereal time on 1987-04-10), Ex 13.b (alt/az of Venus from
   USNO), Ex 21.b (precession of theta Persei to 2028). These pin the
   chain to external truth with no code in common at all.

All comparisons run with aberration disabled (erfa_lite applies it
separately, and it is magnitude-tested in test_coords.py).
"""

import numpy as np
import pytest

from fftvis_tpu.coords.erfa_lite import (
    TT_MINUS_UTC_SEC,
    TelescopeLocation,
    icrs_to_enu_matrices,
    radec_to_icrs_vectors,
)

ARCSEC_RAD = np.pi / (180 * 3600)
DEG = np.pi / 180.0
J2000 = 2451545.0


# ---------------------------------------------------------------------------
# Independent chain: IAU 1976 / 1980 / GMST82, hour-angle formulation
# ---------------------------------------------------------------------------


def _prec76_matrix(t):
    """IAU 1976 (Lieske) precession matrix, mean J2000 -> mean of date.

    P = R3(-z_A) R2(theta_A) R3(-zeta_A) with the standard equatorial
    angles (arcsec; t in Julian centuries TT since J2000).
    """
    zeta = (2306.2181 * t + 0.30188 * t**2 + 0.017998 * t**3) * ARCSEC_RAD
    z = (2306.2181 * t + 1.09468 * t**2 + 0.018203 * t**3) * ARCSEC_RAD
    theta = (2004.3109 * t - 0.42665 * t**2 - 0.041833 * t**3) * ARCSEC_RAD

    def r2(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])

    def r3(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])

    return r3(-z) @ r2(theta) @ r3(-zeta)


# IAU 1980 nutation: the 15 largest terms (units 0.1 mas, coefficients from
# the Wahr/IAU 1980 table; t-rates in 0.1 mas/century).
# Columns: l, l', F, D, Om, psi, psi_t, eps, eps_t
_NUT80 = np.array(
    [
        [0, 0, 0, 0, 1, -171996.0, -174.2, 92025.0, 8.9],
        [0, 0, 2, -2, 2, -13187.0, -1.6, 5736.0, -3.1],
        [0, 0, 2, 0, 2, -2274.0, -0.2, 977.0, -0.5],
        [0, 0, 0, 0, 2, 2062.0, 0.2, -895.0, 0.5],
        [0, 1, 0, 0, 0, 1426.0, -3.4, 54.0, -0.1],
        [1, 0, 0, 0, 0, 712.0, 0.1, -7.0, 0.0],
        [0, 1, 2, -2, 2, -517.0, 1.2, 224.0, -0.6],
        [0, 0, 2, 0, 1, -386.0, -0.4, 200.0, 0.0],
        [1, 0, 2, 0, 2, -301.0, 0.0, 129.0, -0.1],
        [0, -1, 2, -2, 2, 217.0, -0.5, -95.0, 0.3],
        [-1, 0, 0, 2, 0, 158.0, 0.0, -1.0, 0.0],
        [0, 0, 2, -2, 1, 129.0, 0.1, -70.0, 0.0],
        [-1, 0, 2, 0, 2, 123.0, 0.0, -53.0, 0.0],
        [1, 0, 0, 0, 1, 63.0, 0.1, -33.0, 0.0],
        [0, 0, 0, 2, 0, 63.0, 0.0, -2.0, 0.0],
    ]
)


def _nut80(t):
    """(dpsi, deps) radians from the truncated IAU 1980 series.

    Delaunay arguments per the 1980 theory (Van Flandern); the linear
    rates match the 2000 series to < 0.1 arcsec/century, far below the
    term-amplitude scale that matters here.
    """
    l = (485866.733 + 1717915922.633 * t) * ARCSEC_RAD
    lp = (1287099.804 + 129596581.224 * t) * ARCSEC_RAD
    f = (335778.877 + 1739527263.137 * t) * ARCSEC_RAD
    d = (1072261.307 + 1602961601.328 * t) * ARCSEC_RAD
    om = (450160.280 - 6962890.539 * t) * ARCSEC_RAD
    args = _NUT80[:, 0] * l + _NUT80[:, 1] * lp + _NUT80[:, 2] * f
    args = args + _NUT80[:, 3] * d + _NUT80[:, 4] * om
    unit = 1e-4 * ARCSEC_RAD
    dpsi = np.sum((_NUT80[:, 5] + _NUT80[:, 6] * t) * np.sin(args)) * unit
    deps = np.sum((_NUT80[:, 7] + _NUT80[:, 8] * t) * np.cos(args)) * unit
    return dpsi, deps


def _obl80(t):
    """IAU 1980 mean obliquity (radians)."""
    return (84381.448 - 46.8150 * t - 0.00059 * t**2 + 0.001813 * t**3) * ARCSEC_RAD


def _nut_matrix(t):
    """Nutation matrix, mean of date -> true of date."""
    dpsi, deps = _nut80(t)
    eps = _obl80(t)

    def r1(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[1, 0, 0], [0, c, s], [0, -s, c]])

    def r3(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])

    return r1(-(eps + deps)) @ r3(-dpsi) @ r1(eps)


# First-order ICRS -> mean-J2000 frame bias (IAU 2000 offsets: dalpha0 =
# -14.60 mas, xi0 = -16.6170 mas, eta0 = -6.8192 mas).
_DA0 = -0.01460 * ARCSEC_RAD
_XI0 = -0.0166170 * ARCSEC_RAD
_ETA0 = -0.0068192 * ARCSEC_RAD
_BIAS = np.array(
    [
        [1.0, _DA0, -_XI0],
        [-_DA0, 1.0, -_ETA0],
        [_XI0, _ETA0, 1.0],
    ]
)


def _gmst82(jd_ut1):
    """IAU 1982 GMST (radians), continuous form (Meeus eq. 12.4)."""
    d = jd_ut1 - J2000
    t = d / 36525.0
    deg = (
        280.46061837
        + 360.98564736629 * d
        + 0.000387933 * t**2
        - t**3 / 38710000.0
    )
    return np.deg2rad(deg % 360.0)


def _independent_enu(ra, dec, jd_utc, lat, lon):
    """ICRS (ra, dec) -> topocentric ENU unit vector, hour-angle route.

    Apparent place via bias/precession/nutation matrices, then spherical
    trigonometry (hour angle -> alt/az measured from South, Meeus ch. 13)
    -- no ENU basis matrix in common with erfa_lite.
    """
    t = (jd_utc + TT_MINUS_UTC_SEC / 86400.0 - J2000) / 36525.0
    r = np.array([np.cos(dec) * np.cos(ra), np.cos(dec) * np.sin(ra), np.sin(dec)])
    r_app = _nut_matrix(t) @ _prec76_matrix(t) @ _BIAS @ r
    app_ra = np.arctan2(r_app[1], r_app[0])
    app_dec = np.arcsin(np.clip(r_app[2], -1, 1))

    dpsi, _ = _nut80(t)
    gast = _gmst82(jd_utc) + dpsi * np.cos(_obl80(t))
    # Local hour angle (west positive); lon is east-positive.
    H = gast + lon - app_ra
    sh = np.sin(lat) * np.sin(app_dec) + np.cos(lat) * np.cos(app_dec) * np.cos(H)
    alt = np.arcsin(np.clip(sh, -1, 1))
    # Azimuth from South, westward (Meeus 13.5), converted to from-North.
    A = np.arctan2(np.sin(H), np.cos(H) * np.sin(lat) - np.tan(app_dec) * np.cos(lat))
    az_north = A + np.pi
    return np.array(
        [np.cos(alt) * np.sin(az_north), np.cos(alt) * np.cos(az_north), np.sin(alt)]
    )


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------

SITES = [
    ("hera", np.deg2rad(-30.721), np.deg2rad(21.428)),
    ("vla", np.deg2rad(34.0784), np.deg2rad(-107.6184)),
    ("high-north", np.deg2rad(69.0), np.deg2rad(19.0)),
    ("equator", 0.0, np.deg2rad(120.0)),
]

EPOCHS = [2449718.5, 2452000.25, 2455197.0, 2458849.5, 2462502.75, 2466154.0]
# 1995 .. 2045, spanning +-0.45 century around J2000.

SOURCES = [
    (0.0, np.deg2rad(-30.0)),
    (np.deg2rad(83.6), np.deg2rad(22.0)),   # Crab-like
    (np.deg2rad(201.4), np.deg2rad(-43.0)),  # Cen A-like
    (np.deg2rad(310.0), np.deg2rad(78.0)),
    (np.deg2rad(150.0), np.deg2rad(-85.0)),
]


def test_independent_chain_agreement():
    """The ERFA-lite matrix chain agrees with the independently-derived
    IAU76/80 hour-angle chain to <= 1 arcsec everywhere (published
    model-to-model differences are < ~0.2 arcsec over this span; an
    implementation error in either chain is orders of magnitude larger).
    """
    worst = 0.0
    for _, lat, lon in SITES:
        loc = TelescopeLocation(lat=lat, lon=lon, height=1000.0)
        for jd in EPOCHS:
            mats = icrs_to_enu_matrices(np.array([jd]), loc)
            for ra, dec in SOURCES:
                got = mats[0] @ radec_to_icrs_vectors(
                    np.array([ra]), np.array([dec])
                )[:, 0]
                want = _independent_enu(ra, dec, jd, lat, lon)
                ang = np.arccos(np.clip(got @ want, -1, 1))
                worst = max(worst, ang)
    assert worst < 1.0 * ARCSEC_RAD, f"worst deviation {worst / ARCSEC_RAD:.3f}\""


def test_meeus_12a_sidereal_time():
    """Meeus Ex 12.a: Greenwich mean sidereal time at 1987-04-10 0h UT is
    13h10m46.3668s; apparent sidereal time is 13h10m46.1351s. Anchors
    GMST and the equation of equinoxes to a published external value."""
    from fftvis_tpu.coords.erfa_lite import (
        gmst_2006,
        mean_obliquity,
        nutation_2000b_truncated,
    )

    jd = 2446895.5
    t = np.array([(jd + TT_MINUS_UTC_SEC / 86400.0 - J2000) / 36525.0])
    gmst = gmst_2006(np.array([jd]), t)[0]
    want_mean = (13 + 10 / 60 + 46.3668 / 3600) / 24 * 2 * np.pi
    # 0.01 s of time = 0.15 arcsec; allow the GMST82-vs-2006 model gap and
    # the fixed TT-UTC approximation (actual 1987 TT-UTC was 55.184 s).
    assert abs(gmst - want_mean) < 0.05 / 86400 * 2 * np.pi

    dpsi, _ = nutation_2000b_truncated(t)
    gast = gmst + dpsi[0] * np.cos(mean_obliquity(t)[0])
    want_app = (13 + 10 / 60 + 46.1351 / 3600) / 24 * 2 * np.pi
    assert abs(gast - want_app) < 0.05 / 86400 * 2 * np.pi


def test_meeus_13b_venus_altaz():
    """Meeus Ex 13.b: Venus from the US Naval Observatory (lon +77d03'56" W,
    lat +38d55'17"), 1987-04-10 19:21:00 UT, APPARENT geocentric place
    alpha = 23h09m16.641s, delta = -6d43'11.61" -> A(from South) =
    68.0337 deg, h = +15.1249 deg. Anchors the spin + site composition
    (GAST, hour angle, alt/az conventions) to published external truth,
    bypassing the NPB part (the input is already apparent-of-date)."""
    from fftvis_tpu.coords.erfa_lite import (
        _r3,
        enu_basis,
        gmst_2006,
        mean_obliquity,
        nutation_2000b_truncated,
    )

    jd = 2446896.30625  # 1987-04-10 19:21:00 UT
    lon = -(77 + 3 / 60 + 56 / 3600) * DEG
    lat = (38 + 55 / 60 + 17 / 3600) * DEG
    app_ra = (23 + 9 / 60 + 16.641 / 3600) / 24 * 2 * np.pi
    app_dec = -(6 + 43 / 60 + 11.61 / 3600) * DEG

    t = np.array([(jd + TT_MINUS_UTC_SEC / 86400.0 - J2000) / 36525.0])
    dpsi, _ = nutation_2000b_truncated(t)
    gast = gmst_2006(np.array([jd]), t) + dpsi * np.cos(mean_obliquity(t))
    # Site ENU of an apparent-of-date direction: E . R3(GAST) . r_app.
    r_app = np.array(
        [
            np.cos(app_dec) * np.cos(app_ra),
            np.cos(app_dec) * np.sin(app_ra),
            np.sin(app_dec),
        ]
    )
    enu = enu_basis(lat, lon) @ _r3(gast)[0] @ r_app

    alt = np.arcsin(enu[2])
    az_north = np.arctan2(enu[0], enu[1]) % (2 * np.pi)
    az_south_west = (az_north - np.pi) % (2 * np.pi)  # Meeus convention
    assert abs(np.rad2deg(alt) - 15.1249) < 3.0 / 3600
    assert abs(np.rad2deg(az_south_west) - 68.0337) < 3.0 / 3600


def test_meeus_21b_precession_theta_persei():
    """Meeus Ex 21.b: theta Persei J2000 alpha = 2h44m11.986s, delta =
    +49d13'42.48" (after proper motion to epoch: alpha = 2h44m12.975s,
    delta = +49d13'39.90"), precessed to 2028 Nov 13.19 TD ->
    alpha = 2h46m11.331s, delta = +49d20'54.54". Anchors the precession
    part of the chain (compared frame-bias + FW-angles composition with
    nutation zeroed) to a published IAU-1976 worked example; the
    1976-vs-2006 model gap over 0.29 century is < 0.1 arcsec."""
    from fftvis_tpu.coords.erfa_lite import _r1, _r3, precession_fw_angles

    jd_tt = 2462088.69
    t = np.array([(jd_tt - J2000) / 36525.0])
    gamb, phib, psib, epsa = precession_fw_angles(t)
    # Frame bias + precession only: FW composition with dpsi = deps = 0.
    pb = (_r1(-epsa) @ _r3(-psib) @ _r1(phib) @ _r3(gamb))[0]

    ra0 = (2 + 44 / 60 + 12.975 / 3600) / 24 * 2 * np.pi
    dec0 = (49 + 13 / 60 + 39.90 / 3600) * DEG
    r = pb @ np.array(
        [np.cos(dec0) * np.cos(ra0), np.cos(dec0) * np.sin(ra0), np.sin(dec0)]
    )
    ra1 = np.arctan2(r[1], r[0]) % (2 * np.pi)
    dec1 = np.arcsin(r[2])

    want_ra = (2 + 46 / 60 + 11.331 / 3600) / 24 * 2 * np.pi
    want_dec = (49 + 20 / 60 + 54.54 / 3600) * DEG
    # 1" total budget: model gap + worked-example rounding (0.001 s in RA).
    assert abs((ra1 - want_ra + np.pi) % (2 * np.pi) - np.pi) * np.cos(dec1) < 1.0 * ARCSEC_RAD
    assert abs(dec1 - want_dec) < 1.0 * ARCSEC_RAD
