"""Engine-level double-single (compensated) direct path.

An explicitly-requested eps below the fp32 floor routes the simulation
through the exact direct path with two-float arithmetic (engine.simulate
use_ds; tpu/ds.py). These tests pin the routing contract and the accuracy
improvement on the CPU backend. NOTE: XLA:CPU's fusion pipeline duplicates
subexpressions with one-ulp rounding differences, which costs the DS chain
part of its budget on CPU; the full fp64-class win is realized where
compilation preserves the error-free transformations exactly (the GPU:
tests/test_ds.py's ``gpu``-marked tests). CPU assertions below are set at
what XLA:CPU actually delivers.
"""

import logging

import numpy as np
import pytest

from fftvis_tpu import TelescopeLocation, simulate_vis
from fftvis_tpu.beams import GaussianBeam

LOC = TelescopeLocation(np.deg2rad(-30.7), np.deg2rad(21.4), 1000.0)


def _problem(span=2000.0, nsrc=120, polarized=False):
    rng = np.random.default_rng(3)
    ants = {i: np.array([*rng.uniform(-span, span, 2), 0.0]) for i in range(6)}
    ra = rng.uniform(0, 2 * np.pi, nsrc)
    dec = np.clip(LOC.lat + rng.normal(0, 0.4, nsrc), -np.pi / 2, np.pi / 2)
    flux = rng.uniform(0.1, 1.0, (nsrc, 2))
    return dict(
        ants=ants, fluxes=flux, ra=ra, dec=dec,
        freqs=np.array([1.4e8, 1.5e8]),
        times=2459863.2 + np.linspace(0, 0.02, 3),
        beam=GaussianBeam(diameter=12.0), telescope_loc=LOC,
        polarized=polarized,
    )


class TestRouting:
    def test_env_opt_in_forces_direct_ds(self, caplog, monkeypatch):
        monkeypatch.setenv("FFTVIS_DS", "1")
        kw = _problem(span=60.0, nsrc=40)
        with caplog.at_level(logging.INFO, logger="fftvis_tpu.tpu.engine"):
            vis = simulate_vis(precision=1, **kw)
        assert vis.dtype == np.complex128
        assert any("double-single" in r.message for r in caplog.records)
        assert any("direct path" in r.message for r in caplog.records)

    def test_default_eps_keeps_fast_path(self):
        kw = _problem(span=60.0, nsrc=40)
        vis = simulate_vis(precision=1, **kw)  # default eps: no DS
        assert vis.dtype == np.complex64

    def test_precision1_small_eps_keeps_dtype_contract(self, caplog):
        """precision=1 + small explicit eps must NOT silently switch to the
        complex128 DS path (that trigger is reserved for the precision=2
        fp64 contract); it floors eps with the standard warning."""
        kw = _problem(span=60.0, nsrc=40)
        with caplog.at_level(logging.WARNING, logger="fftvis_tpu.tpu.engine"):
            vis = simulate_vis(precision=1, eps=1e-12, **kw)
        assert vis.dtype == np.complex64
        assert any("below what" in r.message for r in caplog.records)

    def test_multi_pair_routes_through_ds(self, monkeypatch):
        """precision=2 semantics must be the same for per-antenna-beam sims
        as for single-beam ones: multi-pair
        routing runs through the DS path, complex128 out."""
        monkeypatch.setenv("FFTVIS_DS", "1")
        kw = _problem(span=60.0, nsrc=40, polarized=True)
        beams = [GaussianBeam(diameter=12.0), GaussianBeam(diameter=13.0)]
        kw["beam"] = beams
        kw["beam_idx"] = np.array([0, 1, 0, 1, 0, 1])
        vis = simulate_vis(precision=1, **kw)
        assert vis.dtype == np.complex128


class TestDsCoords:
    """DS grid coordinates for the fp32 type-1 path (FFTVIS_DS_COORDS).

    On by default only on the GPU (XLA:CPU fusion breaks the error-free
    transforms; the HERA-331 polarized north star is the row it guards
    against the 1e-5 gate). These CPU tests pin the
    mechanics: forced-on must produce a correct fp32-class result and the
    program must compile promptly (optimization-barrier regression guard
    -- without it XLA:CPU compile hangs for minutes).
    """

    def _gridded_problem(self):
        rng = np.random.default_rng(9)
        # 14.6 m hex lattice: griddable -> type-1 path.
        from fftvis_tpu.geometry import hex_array

        ants = hex_array(3, sep=14.6)
        nsrc = 80
        ra = rng.uniform(0, 2 * np.pi, nsrc)
        dec = np.clip(LOC.lat + rng.normal(0, 0.4, nsrc), -np.pi / 2, np.pi / 2)
        return dict(
            ants=ants, fluxes=rng.uniform(0.1, 1.0, (nsrc, 1)), ra=ra, dec=dec,
            freqs=np.array([1.1e8]), times=2459863.2 + np.linspace(0, 0.01, 2),
            beam=GaussianBeam(diameter=14.0), telescope_loc=LOC,
            polarized=True,
        )

    def test_forced_on_matches_f64_at_f32_tolerance(self, monkeypatch):
        kw = self._gridded_problem()
        want = simulate_vis(precision=2, **kw)
        monkeypatch.setenv("FFTVIS_DS_COORDS", "1")
        got = simulate_vis(precision=1, **kw)
        assert got.dtype == np.complex64
        scale = np.abs(want).max()
        assert np.abs(got - want).max() / scale < 1e-4

    def test_fp32_type3_engine_path(self, monkeypatch):
        """Regression (round 3): precision=1 + type-3 crashed on the
        x64-enabled CPU backend (es_kernel_ft returned f64 quadrature ->
        complex128 scan carry). Must run, and forced DS coordinates must
        stay within f32 tolerance of the fp64 result."""
        rng = np.random.default_rng(11)
        nsrc = 150
        ra = rng.uniform(0, 2 * np.pi, nsrc)
        dec = np.clip(LOC.lat + rng.normal(0, 0.4, nsrc), -np.pi / 2, np.pi / 2)
        kw = dict(
            ants={i: np.array([*rng.uniform(-400, 400, 2), 0.0]) for i in range(8)},
            fluxes=rng.uniform(0.1, 1.0, (nsrc, 1)), ra=ra, dec=dec,
            freqs=np.array([1.1e8]), times=2459863.2 + np.linspace(0, 0.01, 2),
            beam=GaussianBeam(diameter=14.0), telescope_loc=LOC,
            polarized=True, force_use_type3=True,
        )
        from fftvis_tpu.tpu.engine import TPUSimulationEngine

        want = simulate_vis(precision=2, **kw)
        scale = np.abs(want).max()
        import fftvis_tpu.wrapper as W

        eng = TPUSimulationEngine(nufft_mode="type3")
        orig = W.create_simulation_engine
        monkeypatch.setattr(
            W, "create_simulation_engine",
            lambda backend, **k: eng if backend == "tpu" else orig(backend, **k),
        )
        got_pl = simulate_vis(precision=1, **kw)
        assert got_pl.dtype == np.complex64
        assert np.abs(got_pl - want).max() / scale < 1e-3
        monkeypatch.setenv("FFTVIS_DS_COORDS", "1")
        got_ds = simulate_vis(precision=1, **kw)
        assert got_ds.dtype == np.complex64
        assert np.abs(got_ds - want).max() / scale < 1e-3

    def test_off_by_default_on_cpu(self, monkeypatch, caplog):
        import logging

        monkeypatch.delenv("FFTVIS_DS_COORDS", raising=False)
        kw = self._gridded_problem()
        a = simulate_vis(precision=1, **kw)
        monkeypatch.setenv("FFTVIS_DS_COORDS", "0")
        b = simulate_vis(precision=1, **kw)
        np.testing.assert_array_equal(a, b)


class TestAccuracy:
    @pytest.mark.parametrize("polarized", [False, True])
    def test_ds_beats_plain_f32_wide_array(self, polarized, monkeypatch):
        """km-scale baselines: phases ~1e4 rad, where fp32 loses ~2e-4.

        The DS path must (a) match the fp64 reference much closer than
        plain fp32 and (b) stay within the XLA:CPU-degraded DS budget.
        """
        kw = _problem(span=2000.0, polarized=polarized)
        want = simulate_vis(precision=2, **kw)  # fp64 on the CPU backend
        monkeypatch.delenv("FFTVIS_DS", raising=False)
        got32 = simulate_vis(precision=1, **kw)
        monkeypatch.setenv("FFTVIS_DS", "1")
        gotds = simulate_vis(precision=1, **kw)
        scale = np.abs(want).max()
        err32 = np.abs(got32 - want).max() / scale
        errds = np.abs(gotds - want).max() / scale
        assert errds < err32 / 2
        assert errds < 5e-4

    def test_ds_matches_f64_small_array(self, monkeypatch):
        """Small phases: DS must sit at the f32-beam floor, not fp32's."""
        monkeypatch.setenv("FFTVIS_DS", "1")
        kw = _problem(span=30.0)
        gotds = simulate_vis(precision=1, **kw)
        monkeypatch.delenv("FFTVIS_DS", raising=False)
        want = simulate_vis(precision=2, **kw)
        scale = np.abs(want).max()
        assert np.abs(gotds - want).max() / scale < 2e-5

    def test_ds_multi_pair_beats_plain_f32(self, monkeypatch):
        """2 distinct beams + beam_idx (multi-pair routing) through the DS
        path: must match the fp64 reference much closer than plain fp32 on
        a wide array (the full ~1e-7 win is a property of the GPU
        compilation -- XLA:CPU fusion costs the EFT chain part of its
        budget here)."""
        kw = _problem(span=2000.0, polarized=True)
        kw["beam"] = [GaussianBeam(diameter=12.0), GaussianBeam(diameter=13.0)]
        kw["beam_idx"] = np.array([0, 1, 0, 1, 0, 1])
        want = simulate_vis(precision=2, **kw)
        monkeypatch.delenv("FFTVIS_DS", raising=False)
        got32 = simulate_vis(precision=1, **kw)
        monkeypatch.setenv("FFTVIS_DS", "1")
        gotds = simulate_vis(precision=1, **kw)
        assert gotds.dtype == np.complex128
        scale = np.abs(want).max()
        err32 = np.abs(got32 - want).max() / scale
        errds = np.abs(gotds - want).max() / scale
        assert errds < err32 / 2
        assert errds < 5e-4

    def test_ds_eigenbeam_matches_f64(self, monkeypatch):
        """Eigenbeam (beam_coefs) contraction through the DS path matches
        the fp64 eigenbeam reference (coefficient contraction runs on the
        host in float64)."""
        from fftvis_tpu import compute_beam_basis
        from fftvis_tpu.beams.gridded import GriddedBeam

        rng = np.random.default_rng(5)
        nant = 4
        ants = {i: np.array([*rng.uniform(-40, 40, 2), 0.0]) for i in range(nant)}
        nsrc = 25
        ra = rng.uniform(0, 2 * np.pi, nsrc)
        dec = np.clip(LOC.lat + rng.normal(0, 0.3, nsrc), -np.pi / 2, np.pi / 2)
        freq = 1.0e8
        beams = [
            GriddedBeam.from_function(
                GaussianBeam(diameter=6.0 + 2.0 * i), n_az=90, n_za=91,
                freqs=(freq,),
            )
            for i in range(nant)
        ]
        eig, coefs = compute_beam_basis(beams, freq, polarized=True, threshold=1e-12)
        kw = dict(
            ants=ants, fluxes=rng.uniform(0.2, 1.0, (nsrc, 1)), ra=ra, dec=dec,
            freqs=np.array([freq]), times=2459863.2 + np.linspace(0, 0.01, 2),
            beam=eig, beam_coefs=coefs[:, :, None], telescope_loc=LOC,
            polarized=True,
        )
        want = simulate_vis(precision=2, **kw)
        monkeypatch.setenv("FFTVIS_DS", "1")
        gotds = simulate_vis(precision=1, **kw)
        assert gotds.dtype == np.complex128
        scale = np.abs(want).max()
        assert np.abs(gotds - want).max() / scale < 2e-5

    def test_ds_output_layout_matches(self, monkeypatch):
        kw = _problem(span=100.0, nsrc=30, polarized=True)
        a = simulate_vis(precision=1, **kw)
        monkeypatch.setenv("FFTVIS_DS", "1")
        b = simulate_vis(precision=1, **kw)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=5e-4 * np.abs(a).max())
