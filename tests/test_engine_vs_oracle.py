"""End-to-end engine validation against the in-repo exact oracle.

This is the reference's backbone testing pattern (oracle cross-validation
against matvis across a parameter matrix, atol 1e-5 fp64 / 1e-4 fp32;
ref tests/test_cpu_simulate.py:75-196), with the in-repo direct-DFT engine
standing in for matvis, plus the type-1-vs-type-3 internal consistency
pattern (ref tests/test_cpu_simulate.py:199-271).
"""

import numpy as np
import pytest

from fftvis_tpu import TelescopeLocation, simulate_vis
from fftvis_tpu.beams import GaussianBeam, GriddedBeam, ShortDipoleBeam
from fftvis_tpu.geometry import hex_array

LOC = TelescopeLocation(np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
JD0 = 2459863.2


def _sky(rng, nsrc, nfreq, polarized_sky=False, lat=LOC.lat):
    # Cluster sources around the site zenith so plenty are above horizon.
    ra = rng.uniform(0, 2 * np.pi, nsrc)
    dec = np.clip(lat + rng.normal(0, 0.4, nsrc), -np.pi / 2, np.pi / 2)
    if polarized_sky:
        I = rng.uniform(0.5, 1.0, (nsrc, nfreq))
        frac = rng.uniform(0, 0.3, (nsrc, nfreq, 3))
        flux = np.concatenate([I[..., None], I[..., None] * frac], axis=-1)
    else:
        flux = rng.uniform(0.1, 1.0, (nsrc, nfreq))
    return ra, dec, flux


def _random_ants(rng, nant, tilted=False):
    ants = {}
    for i in range(nant):
        z = rng.uniform(-2, 2) if tilted else 0.0
        ants[i] = np.array([*rng.uniform(-60, 60, 2), z])
    return ants


FREQS = np.array([1.0e8, 1.17e8])
TIMES = JD0 + np.linspace(0, 0.02, 2)


def _run(backend, force_type3=False, **overrides):
    kw = dict(
        telescope_loc=LOC,
        freqs=FREQS,
        times=TIMES,
        precision=2,
        force_use_type3=force_type3,
        backend=backend,
    )
    kw.update(overrides)
    return simulate_vis(**kw)


@pytest.mark.parametrize("polarized", [False, True])
@pytest.mark.parametrize("precision", [2, 1])
@pytest.mark.parametrize("tilted", [False, True])
@pytest.mark.parametrize("beam_kind", ["analytic", "gridded", "dipole"])
def test_type3_vs_oracle(polarized, precision, tilted, beam_kind):
    """The reference's backbone oracle matrix: polarized x precision x
    beam-type x array-geometry, atol 1e-5 fp64 / 1e-4 fp32 (ref
    tests/test_cpu_simulate.py:75-196, 24 cases here)."""
    rng = np.random.default_rng(10)
    ants = _random_ants(rng, 7, tilted=tilted)
    ra, dec, flux = _sky(rng, 40, len(FREQS))
    if beam_kind == "analytic":
        beam = GaussianBeam(diameter=10.0)
    elif beam_kind == "dipole":
        beam = ShortDipoleBeam()
    else:
        beam = GriddedBeam.from_function(
            GaussianBeam(diameter=10.0), n_az=180, n_za=91,
            freqs=FREQS, za_max=np.pi / 2,
        )
    common = dict(
        ants=ants, fluxes=flux, ra=ra, dec=dec, beam=beam,
        polarized=polarized, precision=precision,
    )
    want = _run("direct", **common)
    got = _run("tpu", force_type3=True, **common)
    assert got.shape == want.shape
    atol = 1e-5 if precision == 2 else 1e-4
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=atol * scale, rtol=0)


@pytest.mark.parametrize("polarized", [False, True])
@pytest.mark.parametrize("mesh_shape", [(2, 1, 2), (1, 2, 2), (2, 2, 2)])
def test_type3_vs_oracle_sharded(polarized, mesh_shape):
    """The oracle matrix's sharded axis: the same sim over multi-axis
    meshes must match the exact oracle (and thus the unsharded run) --
    the SPMD analogue of the reference's nprocesses dimension (ref
    tests/test_cpu_simulate.py:75-196 with nprocesses=2)."""
    import jax

    from fftvis_tpu.parallel.mesh import make_mesh

    t, f, s = mesh_shape
    if len(jax.devices()) < t * f * s:
        pytest.skip("needs more virtual devices")
    rng = np.random.default_rng(11)
    ants = _random_ants(rng, 6)
    ra, dec, flux = _sky(rng, 32, len(FREQS))
    common = dict(
        ants=ants, fluxes=flux, ra=ra, dec=dec,
        beam=GaussianBeam(diameter=10.0), polarized=polarized,
    )
    want = _run("direct", **common)
    mesh = make_mesh(time=t, freq=f, source=s)
    got = _run("tpu", force_type3=True, mesh=mesh, **common)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)


def test_polarized_sky_vs_oracle():
    rng = np.random.default_rng(3)
    ants = _random_ants(rng, 5)
    ra, dec, flux = _sky(rng, 30, len(FREQS), polarized_sky=True)
    beam = ShortDipoleBeam()
    common = dict(ants=ants, fluxes=flux, ra=ra, dec=dec, beam=beam, polarized=True)
    want = _run("direct", **common)
    got = _run("tpu", force_type3=True, **common)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)


def test_gridded_type1_vs_oracle_and_type3():
    rng = np.random.default_rng(4)
    ants = hex_array(3)  # 19 ants on a perfect lattice
    ra, dec, flux = _sky(rng, 50, len(FREQS))
    beam = GaussianBeam(diameter=10.0)
    common = dict(ants=ants, fluxes=flux, ra=ra, dec=dec, beam=beam, polarized=False)

    want = _run("direct", **common)
    got_t1 = _run("tpu", **common)  # auto-selects the gridded type-1 path
    got_t3 = _run("tpu", force_type3=True, **common)

    scale = np.abs(want).max()
    np.testing.assert_allclose(got_t1, want, atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(got_t3, want, atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(got_t1, got_t3, atol=1e-5 * scale, rtol=0)


def test_sheared_grid_type1():
    """Sheared lattices still take (and pass) the type-1 path
    (ref tests/test_cpu_simulate.py:199-271 exercises shear/rotation)."""
    rng = np.random.default_rng(5)
    basis = np.array([[12.0, 5.0], [0.0, 9.0]])
    ants = {
        4 * i + j: np.array([*(basis @ [i, j]), 0.0])
        for i in range(4)
        for j in range(4)
    }
    ra, dec, flux = _sky(rng, 40, len(FREQS))
    beam = GaussianBeam(diameter=10.0)
    common = dict(ants=ants, fluxes=flux, ra=ra, dec=dec, beam=beam, polarized=False)
    want = _run("direct", **common)
    got = _run("tpu", **common)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)


def test_per_antenna_beams_vs_oracle():
    rng = np.random.default_rng(6)
    ants = _random_ants(rng, 5)
    ra, dec, flux = _sky(rng, 30, len(FREQS))
    beams = [GaussianBeam(diameter=10.0), GaussianBeam(diameter=13.0)]
    beam_idx = np.array([0, 1, 0, 1, 1])
    common = dict(
        ants=ants, fluxes=flux, ra=ra, dec=dec, beam=beams, beam_idx=beam_idx,
        polarized=True,
    )
    want = _run("direct", **common)
    got = _run("tpu", force_type3=True, **common)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)

    # Anti-test: beam diversity must change the answer
    # (ref tests/test_cpu_simulate.py:276-382).
    same = _run(
        "tpu", force_type3=True,
        ants=ants, fluxes=flux, ra=ra, dec=dec,
        beam=[GaussianBeam(diameter=10.0)] * 2, beam_idx=beam_idx,
        polarized=True,
    )
    assert np.abs(same - got).max() > 1e-6 * scale


def test_gridded_beam_interpolation_vs_oracle():
    rng = np.random.default_rng(7)
    ants = _random_ants(rng, 4)
    ra, dec, flux = _sky(rng, 25, len(FREQS))
    gb = GriddedBeam.from_function(
        GaussianBeam(diameter=6.0), n_az=180, n_za=181, freqs=(0.9e8, 1.3e8)
    )
    common = dict(ants=ants, fluxes=flux, ra=ra, dec=dec, beam=gb, polarized=True)
    want = _run("direct", **common)
    got = _run("tpu", force_type3=True, **common)
    scale = np.abs(want).max()
    # Both paths share the interpolation kernels; agreement is transform-only.
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)


def test_explicit_baselines_and_autos():
    rng = np.random.default_rng(8)
    ants = _random_ants(rng, 5)
    ra, dec, flux = _sky(rng, 20, len(FREQS))
    baselines = [(0, 1), (2, 4), (3, 3), (1, 0)]
    common = dict(
        ants=ants, fluxes=flux, ra=ra, dec=dec,
        beam=GaussianBeam(diameter=10.0), baselines=baselines, polarized=False,
    )
    want = _run("direct", **common)
    got = _run("tpu", force_type3=True, **common)
    assert got.shape == (len(FREQS), len(TIMES), len(baselines))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)
    # (0,1) and (1,0) must be conjugates.
    np.testing.assert_allclose(got[..., 0], np.conj(got[..., 3]), atol=1e-5 * scale)


def test_source_chunking_invariance():
    """nchunks (static source blocking) must not change results
    (replaces the reference's chunked coord_mgr contract, ref :939-945)."""
    rng = np.random.default_rng(9)
    ants = _random_ants(rng, 5)
    ra, dec, flux = _sky(rng, 33, len(FREQS))
    common = dict(
        ants=ants, fluxes=flux, ra=ra, dec=dec,
        beam=GaussianBeam(diameter=10.0), polarized=False,
    )
    a = _run("tpu", force_type3=True, min_chunks=1, **common)
    b = _run("tpu", force_type3=True, min_chunks=4, **common)
    scale = np.abs(a).max()
    np.testing.assert_allclose(a, b, atol=1e-12 * scale, rtol=0)


def test_simple_coord_method():
    """The 'simple' (sidereal-spin-only) coordinate method: engine == oracle."""
    rng = np.random.default_rng(12)
    ants = _random_ants(rng, 4)
    ra, dec, flux = _sky(rng, 20, len(FREQS))
    common = dict(
        ants=ants, fluxes=flux, ra=ra, dec=dec, beam=GaussianBeam(diameter=10.0),
        polarized=False, coord_method="simple",
    )
    want = _run("direct", **common)
    got = _run("tpu", force_type3=True, **common)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)


def test_upsample_factor_125():
    rng = np.random.default_rng(13)
    ants = _random_ants(rng, 5)
    ra, dec, flux = _sky(rng, 30, len(FREQS))
    common = dict(
        ants=ants, fluxes=flux, ra=ra, dec=dec, beam=GaussianBeam(diameter=10.0),
        polarized=False,
    )
    want = _run("direct", **common)
    got = _run("tpu", force_type3=True, upsample_factor=1.25, **common)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)


def test_eps_loosened():
    """A loose eps must still deliver roughly that accuracy."""
    rng = np.random.default_rng(14)
    ants = _random_ants(rng, 5)
    ra, dec, flux = _sky(rng, 30, len(FREQS))
    common = dict(
        ants=ants, fluxes=flux, ra=ra, dec=dec, beam=GaussianBeam(diameter=10.0),
        polarized=False,
    )
    want = _run("direct", **common)
    # Force the actual type-3 NUFFT (the auto cost model would pick the
    # exact direct path for a problem this small).
    from fftvis_tpu.beams.interface import BeamInterface, prepare_beam_unpolarized
    from fftvis_tpu.tpu.engine import TPUSimulationEngine

    eng = TPUSimulationEngine(nufft_mode="type3")
    beam_list = [prepare_beam_unpolarized(BeamInterface(common.pop("beam")))]
    got = eng.simulate(
        beam_list=beam_list, freqs=FREQS, times=TIMES, telescope_loc=LOC,
        precision=2, eps=1e-4, **common,
    )
    scale = np.abs(want).max()
    err = np.abs(got - want).max() / scale
    assert err < 1e-2
    # And it must NOT be accidentally exact (the NUFFT path really ran).
    assert err > 1e-9


def test_strip_spreader_matches_oracle(monkeypatch):
    """The strip-binned spreader (FFTVIS_SPREADER=strip), forced on CPU."""
    monkeypatch.setenv("FFTVIS_SPREADER", "strip")
    rng = np.random.default_rng(15)
    ants = _random_ants(rng, 6)
    ra, dec, flux = _sky(rng, 60, len(FREQS))
    common = dict(
        ants=ants, fluxes=flux, ra=ra, dec=dec,
        polarized=True,
    )
    want = _run("direct", beam=GaussianBeam(diameter=10.0), **common)

    from fftvis_tpu.beams.interface import BeamInterface
    from fftvis_tpu.tpu.engine import TPUSimulationEngine

    eng = TPUSimulationEngine(nufft_mode="type3")
    got = eng.simulate(
        beam_list=[BeamInterface(GaussianBeam(diameter=10.0))],
        freqs=FREQS, times=TIMES, telescope_loc=LOC, precision=2,
        nchunks=2, **common,
    )
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)


def test_gridded_polarized_type1():
    """Type-1 gridded path with polarization + per-antenna beams."""
    rng = np.random.default_rng(16)
    ants = hex_array(2)  # 7 ants on the lattice
    ra, dec, flux = _sky(rng, 30, len(FREQS))
    beams = [GaussianBeam(diameter=10.0), GaussianBeam(diameter=12.0)]
    beam_idx = np.array([0, 1, 0, 1, 0, 1, 0])
    common = dict(
        ants=ants, fluxes=flux, ra=ra, dec=dec, beam=beams, beam_idx=beam_idx,
        polarized=True,
    )
    want = _run("direct", **common)
    got = _run("tpu", **common)  # auto: type-1
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)


@pytest.mark.parametrize("polarized", [False, True])
def test_3d_lowrank_z_nufft_vs_oracle(polarized):
    """Non-coplanar arrays through the forced 3D NUFFT (lowrank-z) path.

    The reference treats nufft3d3 as a first-class path (ref cpu/nufft.py:
    62-118, dispatched at cpu_simulate.py:284-295); here the equivalent is
    the low-rank Chebyshev z factorization batched through the 2D type-3
    (transform.plan_type3_lowrank_z). Forced via nufft_mode='type3' so the
    FLOP model cannot fall back to the exact direct path.
    """
    from fftvis_tpu.beams.interface import BeamInterface, prepare_beam_unpolarized
    from fftvis_tpu.nufft.transform import Type3LowrankZExecutor
    from fftvis_tpu.tpu.engine import TPUSimulationEngine

    rng = np.random.default_rng(17)
    ants = _random_ants(rng, 9, tilted=True)
    ra, dec, flux = _sky(rng, 60, len(FREQS))
    common = dict(
        ants=ants, fluxes=flux, ra=ra, dec=dec,
        telescope_loc=LOC, freqs=FREQS, times=TIMES,
        precision=2, polarized=polarized, force_use_type3=True,
    )
    want = simulate_vis(beam=GaussianBeam(diameter=10.0), backend="direct", **common)

    eng = TPUSimulationEngine(nufft_mode="type3")
    b = BeamInterface(GaussianBeam(diameter=10.0))
    blist = [b if polarized else prepare_beam_unpolarized(b)]
    got = eng.simulate(beam_list=blist, **common)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=0)

    # The plan must actually be the 3D lowrank-z executor (not 2D/direct).
    from fftvis_tpu.tpu.engine import _PLAN_CACHE

    assert any(
        isinstance(getattr(p, "executor", None), Type3LowrankZExecutor)
        for p in _PLAN_CACHE.values()
        if hasattr(p, "executor")
    )


def _square_grid(n=4, sep=11.0):
    return {
        n * i + j: np.array([i * sep, j * sep, 0.0])
        for i in range(n)
        for j in range(n)
    }


@pytest.mark.parametrize("polarized", [False, True])
@pytest.mark.parametrize("precision", [2, 1])
@pytest.mark.parametrize("shear_array", [True, False])
@pytest.mark.parametrize("rotate_array", [True, False])
@pytest.mark.parametrize("remove_antennas", [True, False])
@pytest.mark.parametrize("grid", ["hex", "square"])
def test_gridded_type1_vs_type3_matrix(
    polarized, precision, shear_array, rotate_array, remove_antennas, grid
):
    """Type-1 (gridded) and type-3 paths agree across the reference's full
    lattice-deformation matrix: polarized x precision x shear x rotation x
    random antenna removal x (hex | square) -- 64 cases (ref
    tests/test_cpu_simulate.py:199-271, atol 1e-5 fp64 / 1e-4 fp32)."""
    rng = np.random.default_rng(42)
    ants = hex_array(3, sep=12.0) if grid == "hex" else _square_grid()

    if remove_antennas:
        keep = [k for k in ants if rng.uniform() > 0.25]
        ants = {i: ants[k] for i, k in enumerate(keep)}
    if rotate_array:
        th = np.pi / 2
        R = np.array(
            [[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1]]
        )
        ants = {a: R @ p for a, p in ants.items()}
    if shear_array:
        S = np.array([[1, 0.5, 0], [0, 1, 0], [0, 0, 1]])
        ants = {a: S @ p for a, p in ants.items()}

    baselines = [(i, j) for i in ants for j in ants if j >= i]
    ra, dec, flux = _sky(rng, 30, 1)
    common = dict(
        ants=ants, fluxes=flux, ra=ra, dec=dec,
        beam=GaussianBeam(diameter=10.0),
        baselines=baselines, polarized=polarized, precision=precision,
        eps=1e-10 if precision == 2 else 6e-8,
        freqs=FREQS[:1], times=TIMES[:1],
    )
    v1 = _run("tpu", **common)  # auto: gridded lattices take type-1
    v3 = _run("tpu", force_type3=True, **common)
    atol = 1e-5 if precision == 2 else 1e-4
    np.testing.assert_allclose(v1, v3, atol=atol * np.abs(v3).max(), rtol=0)


@pytest.mark.parametrize("polarized", [False, True])
@pytest.mark.parametrize("beam_kind", ["analytic", "gridded"])
def test_per_antenna_beam_diversity(polarized, beam_kind):
    """Per-antenna beams: identical beam slots must reproduce the shared-
    beam result exactly, and genuinely different beams must CHANGE the
    answer while still matching the oracle -- proving beam diversity
    propagates through the transform (ref tests/test_cpu_simulate.py:
    276-382's anti-test)."""
    rng = np.random.default_rng(6)
    ants = _random_ants(rng, 6)
    ra, dec, flux = _sky(rng, 35, len(FREQS))
    beam_idx = np.array([i % 2 for i in range(len(ants))])

    def mk(diam):
        b = GaussianBeam(diameter=diam)
        if beam_kind == "gridded":
            return GriddedBeam.from_function(
                b, n_az=180, n_za=91, freqs=FREQS, za_max=np.pi / 2
            )
        return b

    base = dict(
        ants=ants, fluxes=flux, ra=ra, dec=dec, polarized=polarized,
    )
    shared = _run("tpu", force_type3=True, beam=mk(10.0), **base)
    identical = _run(
        "tpu", force_type3=True, beam=[mk(10.0), mk(10.0)],
        beam_idx=beam_idx, **base,
    )
    scale = np.abs(shared).max()
    np.testing.assert_allclose(identical, shared, atol=1e-10 * scale, rtol=0)

    different = _run(
        "tpu", force_type3=True, beam=[mk(10.0), mk(7.5)],
        beam_idx=beam_idx, **base,
    )
    assert np.abs(different - shared).max() > 1e-3 * scale, (
        "beam diversity did not change the visibilities"
    )
    oracle = _run(
        "direct", beam=[mk(10.0), mk(7.5)], beam_idx=beam_idx, **base
    )
    np.testing.assert_allclose(different, oracle, atol=1e-5 * scale, rtol=0)


def test_horizon_culling_matches_oracle_full_sky():
    """A full-sky catalog (half of it never visible) must match the
    no-culling oracle: static horizon culling (engine-side, static-shape
    analogue of ref cpu_simulate.py:940-945 dynamic compaction) may only
    remove exact zeros."""
    rng = np.random.default_rng(77)
    nsrc = 600
    ra = rng.uniform(0, 2 * np.pi, nsrc)
    dec = np.arcsin(rng.uniform(-1, 1, nsrc))  # uniform over the sphere
    flux = rng.uniform(0.1, 1.0, (nsrc, len(FREQS)))
    ants = _random_ants(rng, 5)
    common = dict(
        ants=ants, fluxes=flux, ra=ra, dec=dec,
        beam=GaussianBeam(diameter=10.0),
    )
    got = _run("tpu", **common)
    want = _run("direct", **common)
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max())

    # The cull must actually engage on this sky (roughly half never rises).
    from fftvis_tpu.coords.rotation import SourceRotation

    rot = SourceRotation(ra, dec, TIMES, LOC)
    keep = rot.cull_never_visible()
    assert keep is not None and 0.3 < keep.mean() < 0.8


def test_noncoplanar_multibeam_type3_vs_oracle():
    """Non-coplanar (lowrank-z, K>1) + multi-pair routing: the per-pair
    grid slice must account for the z-mode channel multiplier (a wrong
    slice crashes at trace time or silently mixes pair channels)."""
    from fftvis_tpu.beams import GriddedBeam

    rng = np.random.default_rng(91)
    ants = _random_ants(rng, 6, tilted=True)
    ra, dec, flux = _sky(rng, 50, len(FREQS))
    beams = [
        GriddedBeam.from_function(
            GaussianBeam(diameter=d), n_az=90, n_za=46, freqs=FREQS,
            za_max=np.pi / 2,
        )
        for d in (9.0, 13.0)
    ]
    beam_idx = np.array([0, 1, 0, 1, 0, 1])
    common = dict(
        ants=ants, fluxes=flux, ra=ra, dec=dec, beam=beams,
        beam_idx=beam_idx, polarized=True,
    )
    got = _run("tpu", force_type3=True, **common)
    want = _run("direct", **common)
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max())


def test_lowrank_z_cap_falls_back_to_direct(caplog):
    """A z extent beyond the Chebyshev cap must fall back to the exact
    direct path with a warning, not return silently wrong results."""
    import logging

    rng = np.random.default_rng(92)
    # ~km-scale antenna heights -> z bandwidth far beyond 160 modes.
    ants = {
        i: np.array([*rng.uniform(-500, 500, 2), rng.uniform(-400, 400)])
        for i in range(5)
    }
    ra, dec, flux = _sky(rng, 30, len(FREQS))
    with caplog.at_level(logging.WARNING, logger="fftvis_tpu.tpu.engine"):
        got = _run(
            "tpu", force_type3=True, ants=ants, fluxes=flux, ra=ra, dec=dec,
            beam=GaussianBeam(diameter=10.0),
        )
    assert any("low-rank factorization unavailable" in r.message
               for r in caplog.records)
    want = _run(
        "direct", ants=ants, fluxes=flux, ra=ra, dec=dec,
        beam=GaussianBeam(diameter=10.0),
    )
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max())
