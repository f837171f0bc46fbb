"""Randomized-configuration oracle fuzz.

The parameter space (polarization x sky model x beam kinds x per-antenna
routing x array geometry x transform path x baseline subsets) has
interaction bugs the hand-written matrices miss (e.g. the multi-pair +
lowrank-z channel-slicing bug found in round 2). Each case draws a full
configuration from a seeded RNG and cross-validates the engine against
the exact fp64 direct-DFT oracle at the reference's 1e-5 tolerance
(ref tests/test_cpu_simulate.py:75-196 is the fixed-matrix ancestor).

Seeds are FIXED: failures are reproducible, and the drawn space grows
deliberately (add seeds, never reuse).
"""

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # randomized soak: dedicated CI job

from fftvis_tpu import TelescopeLocation, simulate_vis
from fftvis_tpu.beams import (
    AiryBeam,
    GaussianBeam,
    GriddedBeam,
    ShortDipoleBeam,
)

LOC = TelescopeLocation(np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
JD0 = 2459863.2
FREQ_LO, FREQ_HI = 8.0e7, 1.8e8


def _draw_beam(rng, freqs, polarized):
    kind = rng.choice(["gauss", "airy", "dipole", "gridded"])
    if kind == "gauss":
        return GaussianBeam(diameter=float(rng.uniform(6, 16)))
    if kind == "airy":
        return AiryBeam(diameter=float(rng.uniform(6, 16)))
    if kind == "dipole" and polarized:
        return ShortDipoleBeam()
    if kind == "dipole":
        return GaussianBeam(diameter=float(rng.uniform(6, 16)))
    return GriddedBeam.from_function(
        GaussianBeam(diameter=float(rng.uniform(6, 16))),
        n_az=int(rng.integers(60, 120)),
        n_za=int(rng.integers(30, 60)),
        freqs=freqs,
        za_max=np.pi / 2,
    )


def _draw_case(seed):
    rng = np.random.default_rng(seed)
    nant = int(rng.integers(3, 8))
    tilted = bool(rng.integers(0, 2))
    span = float(rng.uniform(30, 300))
    ants = {
        i: np.array(
            [
                *rng.uniform(-span, span, 2),
                rng.uniform(-3, 3) if tilted else 0.0,
            ]
        )
        for i in range(nant)
    }
    nsrc = int(rng.integers(15, 80))
    ra = rng.uniform(0, 2 * np.pi, nsrc)
    dec = np.arcsin(rng.uniform(-1, 1, nsrc))  # full sphere: exercises cull
    nfreq = int(rng.integers(1, 4))
    ntime = int(rng.integers(1, 4))
    freqs = np.sort(rng.uniform(FREQ_LO, FREQ_HI, nfreq))
    times = JD0 + np.sort(rng.uniform(0, 0.03, ntime))
    polarized = bool(rng.integers(0, 2))
    polarized_sky = polarized and bool(rng.integers(0, 2))
    if polarized_sky:
        I = rng.uniform(0.5, 1.0, (nsrc, nfreq))
        frac = rng.uniform(-0.2, 0.2, (nsrc, nfreq, 3))
        flux = np.concatenate([I[..., None], I[..., None] * frac], axis=-1)
    else:
        flux = rng.uniform(0.1, 1.0, (nsrc, nfreq))

    kw = dict(
        ants=ants, fluxes=flux, ra=ra, dec=dec, freqs=freqs, times=times,
        telescope_loc=LOC, polarized=polarized, precision=2,
    )

    # Beam setup: shared, or per-antenna with routing.
    if rng.integers(0, 3) == 0:
        nbeam = int(rng.integers(2, min(nant, 4) + 1))
        kw["beam"] = [_draw_beam(rng, freqs, polarized) for _ in range(nbeam)]
        kw["beam_idx"] = rng.integers(0, nbeam, nant)
    else:
        kw["beam"] = _draw_beam(rng, freqs, polarized)

    # Baseline subset (sometimes shuffled), sometimes default redundant set.
    if rng.integers(0, 2):
        keys = list(ants.keys())
        all_bls = [
            (keys[i], keys[j])
            for i in range(nant)
            for j in range(i, nant)
        ]
        take = rng.permutation(len(all_bls))[
            : int(rng.integers(1, len(all_bls) + 1))
        ]
        kw["baselines"] = [all_bls[i] for i in take]

    if rng.integers(0, 2):
        kw["force_use_type3"] = True
    return kw


@pytest.mark.parametrize("seed", range(96))
def test_fuzz_vs_oracle(seed):
    kw = _draw_case(seed)
    got = simulate_vis(backend="tpu", **kw)
    want = simulate_vis(backend="direct", **{
        k: v for k, v in kw.items() if k != "force_use_type3"
    })
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, atol=2e-5 * scale, rtol=0)


@pytest.mark.parametrize("seed", range(200, 212))
def test_fuzz_tiled_spreader_vs_oracle(seed, monkeypatch):
    """Same fuzz, but forcing the tile-binned spreader with the device-side
    capacity/occupancy checks armed: random configurations must neither
    drop sources (FFTVIS_DEBUG raises) nor lose accuracy through the
    balanced-occupancy class schedule."""
    monkeypatch.setenv("FFTVIS_SPREADER", "tiled")
    monkeypatch.setenv("FFTVIS_DEBUG", "1")
    kw = _draw_case(seed)
    kw["force_use_type3"] = True
    got = simulate_vis(backend="tpu", **kw)
    want = simulate_vis(backend="direct", **{
        k: v for k, v in kw.items() if k != "force_use_type3"
    })
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, atol=2e-5 * scale, rtol=0)


def _draw_gridded_case(seed):
    """Random GRIDDED-lattice configuration: the exact separable-DFT path,
    its ES+FFT small-C crossover, the outer-product matmul form, and horizon
    banding are reachable only on lattice arrays, which the positions the
    plain fuzz draws never form."""
    from fftvis_tpu.geometry import hex_array, square_array

    rng = np.random.default_rng(10_000 + seed)
    sep = float(rng.uniform(8, 20))
    if rng.integers(0, 2):
        ants = hex_array(int(rng.integers(2, 4)), sep=sep)
    else:
        ants = square_array(int(rng.integers(2, 4)), sep=sep)
    # In-plane rotation and a shear keep the lattice griddable; random
    # removal exercises partial-lattice mode sets.
    th = rng.uniform(0, 2 * np.pi)
    R = np.array(
        [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]]
    )
    shear = np.eye(3)
    if rng.integers(0, 2):
        shear[0, 1] = float(rng.uniform(-0.4, 0.4))
    ants = {k: shear @ (R @ v) for k, v in ants.items()}
    keys = list(ants.keys())
    for k in rng.permutation(keys)[: int(rng.integers(0, max(1, len(keys) // 4)))]:
        ants.pop(int(k))
    nant = len(ants)

    nsrc = int(rng.integers(15, 60))
    ra = rng.uniform(0, 2 * np.pi, nsrc)
    dec = np.arcsin(rng.uniform(-1, 1, nsrc))
    nfreq = int(rng.integers(1, 3))
    ntime = int(rng.integers(1, 3))
    freqs = np.sort(rng.uniform(FREQ_LO, FREQ_HI, nfreq))
    times = JD0 + np.sort(rng.uniform(0, 0.03, ntime))
    polarized = bool(rng.integers(0, 2))
    flux = rng.uniform(0.1, 1.0, (nsrc, nfreq))
    kw = dict(
        ants=ants, fluxes=flux, ra=ra, dec=dec, freqs=freqs, times=times,
        telescope_loc=LOC, polarized=polarized, precision=2,
    )
    # Per-antenna beams push the exact path's channel count (C = npairs *
    # nfeeds^2) toward the outer-product regime.
    if rng.integers(0, 3) == 0 and nant >= 3:
        nbeam = int(rng.integers(2, min(nant, 4) + 1))
        kw["beam"] = [_draw_beam(rng, freqs, polarized) for _ in range(nbeam)]
        kw["beam_idx"] = rng.integers(0, nbeam, nant)
    else:
        kw["beam"] = _draw_beam(rng, freqs, polarized)
    return kw


@pytest.mark.parametrize("seed", range(20))
def test_fuzz_gridded_vs_oracle(seed, monkeypatch):
    kw = _draw_gridded_case(seed)
    rng = np.random.default_rng(20_000 + seed)
    monkeypatch.setenv(
        "FFTVIS_TYPE1", str(rng.choice(["auto", "exact", "es"]))
    )
    monkeypatch.setenv(
        "FFTVIS_EXACT_OUTER", str(rng.choice(["auto", "0", "1"]))
    )
    if rng.integers(0, 2):
        # Tiny banding blocks force the horizon-banded scan to engage on
        # these small skies.
        monkeypatch.setenv("FFTVIS_BAND_BLOCK", "8")
        monkeypatch.setenv("FFTVIS_BLOCK", "8")
    got = simulate_vis(backend="tpu", **kw)
    want = simulate_vis(backend="direct", **kw)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, atol=2e-5 * scale, rtol=0)


@pytest.mark.parametrize("seed", range(40_000, 40_006))
def test_fuzz_auto_rank_vs_oracle(seed, caplog):
    """Random LOW-RANK per-antenna tabulated-beam families: the automatic
    SVD rank compression (core/auto_rank.py) must ENGAGE (asserted via its
    INFO log) and the compressed engine must still match the exact per-pair
    direct oracle. The targeted tests in test_auto_rank.py compare against
    the uncompressed engine path; this axis is the independent one -- the
    oracle never compresses, so a wrong coefficient contraction or channel
    list cannot cancel."""
    import logging

    rng = np.random.default_rng(seed)
    nant = int(rng.integers(6, 9))
    span = float(rng.uniform(40, 150))
    ants = {
        i: np.array([*rng.uniform(-span, span, 2), 0.0]) for i in range(nant)
    }
    nsrc = int(rng.integers(20, 60))
    ra = rng.uniform(0, 2 * np.pi, nsrc)
    dec = np.arcsin(rng.uniform(-1, 1, nsrc))
    nfreq = int(rng.integers(1, 3))
    freqs = np.sort(rng.uniform(FREQ_LO, FREQ_HI, nfreq))
    ntime = int(rng.integers(1, 3))
    times = JD0 + np.sort(rng.uniform(0, 0.02, ntime))
    iquv = bool(rng.integers(0, 2))
    if iquv:
        I = rng.uniform(0.5, 1.0, (nsrc, nfreq))
        frac = rng.uniform(-0.2, 0.2, (nsrc, nfreq, 3))
        flux = np.concatenate([I[..., None], I[..., None] * frac], axis=-1)
    else:
        flux = rng.uniform(0.1, 1.0, (nsrc, nfreq))

    # A rank-R family: every antenna's table is a random combination of R
    # parent tables on one common grid (R small so compression wins).
    R = int(rng.integers(2, 4))
    parents = [
        np.asarray(
            GriddedBeam.from_function(
                GaussianBeam(diameter=float(rng.uniform(10, 16))),
                n_az=81, n_za=41, freqs=freqs, za_max=np.pi / 2,
            ).data_array
        )
        for _ in range(R)
    ]
    first = GriddedBeam.from_function(
        GaussianBeam(diameter=12.0), n_az=81, n_za=41, freqs=freqs,
        za_max=np.pi / 2,
    )
    beams = []
    for _ in range(nant):
        w = rng.uniform(0.2, 1.0, R)
        data = sum(wk * p for wk, p in zip(w, parents))
        if rng.integers(0, 2):  # complex tables force the ordered K^2 list
            data = data * np.exp(1j * float(rng.uniform(0, 0.3)))
        beams.append(
            GriddedBeam(
                data, first.axis1_array, first.axis2_array,
                first.freq_array, beam_type="efield", feeds=first.feeds,
            )
        )

    keys = list(ants.keys())
    kw = dict(
        ants=ants, fluxes=flux, ra=ra, dec=dec, freqs=freqs, times=times,
        beam=beams, beam_idx=np.arange(nant), telescope_loc=LOC,
        polarized=True, precision=2, eps=2e-6,
        baselines=[
            (keys[i], keys[j])
            for i in range(nant)
            for j in range(i, nant)
        ],
    )
    caplog.set_level(logging.INFO)
    got = simulate_vis(backend="tpu", **kw)
    assert any(
        "auto-rank" in r.getMessage() and "compressed" in r.getMessage()
        for r in caplog.records
    ), "auto-rank did not engage on a low-rank beam family"
    want = simulate_vis(backend="direct", **kw)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, atol=2e-5 * scale, rtol=0)


@pytest.mark.parametrize("seed", range(30_000, 30_008))
def test_fuzz_eigenbeam_vs_oracle(seed):
    """Random eigenbeam-basis configurations (beam_coefs path) against the
    per-antenna direct sim they compress. Both sides interpolate the SAME
    gridded tables (the basis is exact on table samples; an analytic
    comparison would measure table interpolation error instead), and the
    basis path requires polarized=True by API contract."""
    from fftvis_tpu import compute_beam_basis

    rng = np.random.default_rng(seed)
    nant = int(rng.integers(3, 6))
    span = float(rng.uniform(40, 150))
    ants = {
        i: np.array([*rng.uniform(-span, span, 2), 0.0]) for i in range(nant)
    }
    nsrc = int(rng.integers(15, 50))
    ra = rng.uniform(0, 2 * np.pi, nsrc)
    dec = np.arcsin(rng.uniform(-1, 1, nsrc))
    freqs = np.array([float(rng.uniform(FREQ_LO, FREQ_HI))])
    ntime = int(rng.integers(1, 3))
    times = JD0 + np.sort(rng.uniform(0, 0.02, ntime))
    flux = rng.uniform(0.1, 1.0, (nsrc, 1))
    n_az = int(rng.integers(90, 150))
    n_za = int(rng.integers(40, 70))
    ant_beams = [
        GriddedBeam.from_function(
            GaussianBeam(diameter=float(rng.uniform(10, 14))),
            n_az=n_az, n_za=n_za, freqs=freqs, za_max=np.pi / 2,
        )
        for _ in range(nant)
    ]
    eig, coefs = compute_beam_basis(
        ant_beams, float(freqs[0]), polarized=True, threshold=1e-12,
    )
    kw = dict(
        ants=ants, fluxes=flux, ra=ra, dec=dec, freqs=freqs, times=times,
        telescope_loc=LOC, polarized=True, precision=2,
    )
    got = simulate_vis(
        beam=eig, beam_coefs=coefs[:, :, None], backend="tpu", **kw
    )
    want = simulate_vis(
        beam=list(ant_beams), beam_idx=np.arange(nant), backend="direct", **kw
    )
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-12)
    np.testing.assert_allclose(got, want, atol=5e-5 * scale, rtol=0)
