"""Per-time horizon-band block skipping (coords/banding.py + engine).

The banded scan must be a pure work-skipping optimization: identical
results (up to summation-order rounding) on long observations, engaged
only when the planner proves a real static-shape saving, and off for
short observations, sharded source axes, and small catalogs.
"""

import logging

import numpy as np
import pytest

from fftvis_tpu import TelescopeLocation, simulate_vis
from fftvis_tpu.beams import GaussianBeam
from fftvis_tpu.coords.banding import plan_horizon_bands
from fftvis_tpu.coords.rotation import SourceRotation
from fftvis_tpu.geometry import hex_array

LOC = TelescopeLocation(np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
JD0 = 2459863.2


def _sky(n, seed=7):
    rng = np.random.default_rng(seed)
    ra = rng.uniform(0, 2 * np.pi, n)
    dec = np.arcsin(rng.uniform(-1, 1, n))  # isotropic
    return ra, dec, rng


class TestPlanner:
    def test_table_matches_brute_force(self):
        ra, dec, _ = _sky(3000)
        rot = SourceRotation(ra, dec, JD0 + np.linspace(0, 1.0, 12), LOC)
        rot.cull_never_visible()
        nb = 64
        blk = int(np.ceil(rot.nsrc / nb))
        pad = blk * nb
        out = plan_horizon_bands(rot, blk, nb, pad)
        assert out is not None
        perm, idx, val = out
        assert sorted(perm.tolist()) == list(range(rot.nsrc))
        # Brute force: block active iff it holds any visible source.
        z = np.stack([rot.topo_at(t)[2] for t in range(rot.ntimes)])
        visp = (z > -2e-3)[:, perm]
        visp = np.pad(visp, ((0, 0), (0, pad - rot.nsrc)))
        actb = visp.reshape(rot.ntimes, nb, blk).any(axis=2)
        for t in range(rot.ntimes):
            want = set(np.flatnonzero(actb[t]).tolist())
            got = set(idx[t, val[t] > 0].tolist())
            assert got == want

    def test_no_plan_for_short_observation(self):
        """A 30-minute window: everything visible stays visible; no
        banding (protects the tutorial-scale workloads from overhead)."""
        ra, dec, _ = _sky(3000)
        rot = SourceRotation(ra, dec, JD0 + np.linspace(0, 30 / 60 / 24, 12), LOC)
        rot.cull_never_visible()
        nb = 64
        blk = int(np.ceil(rot.nsrc / nb))
        assert plan_horizon_bands(rot, blk, nb, blk * nb) is None

    def test_all_circumpolar_returns_none(self):
        rng = np.random.default_rng(0)
        n = 600
        ra = rng.uniform(0, 2 * np.pi, n)
        dec = np.full(n, np.deg2rad(-85.0))  # circumpolar at -30.7 deg site
        rot = SourceRotation(ra, dec, JD0 + np.linspace(0, 1.0, 12), LOC)
        rot.cull_never_visible()
        assert plan_horizon_bands(rot, 10, 60, 600) is None


class TestEngineEquivalence:
    def _kw(self, polarized, nsrc=9000, iquv=False, beams=None):
        ra, dec, rng = _sky(nsrc)
        if iquv:
            flux = rng.uniform(0.1, 1.0, (nsrc, 2, 4))
            flux[:, :, 1:] *= 0.1
        else:
            flux = rng.uniform(0.1, 1.0, (nsrc, 2))
        kw = dict(
            ants=hex_array(3, sep=14.6), fluxes=flux, ra=ra, dec=dec,
            freqs=np.array([1e8, 1.1e8]),
            times=JD0 + np.linspace(0, 1.0, 10),
            beam=beams or GaussianBeam(diameter=14.0),
            telescope_loc=LOC, polarized=polarized, precision=2,
        )
        return kw

    @pytest.mark.parametrize("polarized", [False, True])
    def test_banded_equals_plain_24h(self, polarized, monkeypatch, caplog):
        kw = self._kw(polarized)
        # Fine-grained blocks so banding engages on this small test sky
        # (the default targets ~4096-source blocks, chosen for per-step
        # device efficiency, which keeps K/nblocks above the engagement
        # threshold at this catalog size).
        monkeypatch.setenv("FFTVIS_BAND_BLOCK", "256")
        with caplog.at_level(logging.INFO, logger="fftvis_tpu.tpu.engine"):
            v_band = simulate_vis(**kw)
        assert any("horizon banding engaged" in r.message for r in caplog.records)
        monkeypatch.setenv("FFTVIS_BAND", "0")
        v_ref = simulate_vis(**kw)
        scale = np.abs(v_ref).max()
        assert np.abs(v_band - v_ref).max() / scale < 1e-11

    def test_banded_equals_plain_iquv_sky(self, monkeypatch):
        """IQUV coherency rides the same permutation as the positions."""
        kw = self._kw(True, iquv=True)
        monkeypatch.setenv("FFTVIS_BAND_BLOCK", "256")
        v_band = simulate_vis(**kw)
        monkeypatch.setenv("FFTVIS_BAND", "0")
        v_ref = simulate_vis(**kw)
        scale = np.abs(v_ref).max()
        assert np.abs(v_band - v_ref).max() / scale < 1e-11

    def test_banded_equals_plain_per_antenna_beams(self, monkeypatch):
        beams = [GaussianBeam(diameter=12.0), GaussianBeam(diameter=14.0)]
        kw = self._kw(True, nsrc=6000)
        kw["beam"] = beams
        kw["beam_idx"] = np.arange(len(kw["ants"])) % 2
        monkeypatch.setenv("FFTVIS_BAND_BLOCK", "256")
        v_band = simulate_vis(**kw)
        monkeypatch.setenv("FFTVIS_BAND", "0")
        v_ref = simulate_vis(**kw)
        scale = np.abs(v_ref).max()
        assert np.abs(v_band - v_ref).max() / scale < 1e-11

    @pytest.mark.parametrize("spreader", ["auto", "dense"])
    def test_type3_banding_compacts(self, spreader, monkeypatch, caplog):
        """Type-3 bands via per-time COMPACTION (one gathered mega-block,
        exactly one spread + post-pass per (time, freq)) when the spread
        is occupancy-proportional -- the scatter (auto) and dense
        spreaders. A banded block SCAN would pay the O(grid) spread
        post-pass once per block; compaction pays it once per time."""
        from fftvis_tpu.beams.interface import (
            BeamInterface,
            prepare_beam_unpolarized,
        )
        from fftvis_tpu.tpu.engine import TPUSimulationEngine

        kw = self._kw(False, nsrc=9000)
        kw["precision"] = 1
        kw["force_use_type3"] = True
        kw["beam_list"] = [
            prepare_beam_unpolarized(BeamInterface(kw.pop("beam")))
        ]
        monkeypatch.setenv("FFTVIS_SPREADER", spreader)
        monkeypatch.setenv("FFTVIS_BAND_BLOCK", "256")
        with caplog.at_level(logging.INFO, logger="fftvis_tpu.tpu.engine"):
            v = TPUSimulationEngine(nufft_mode="type3").simulate(**kw)
        assert any(
            "horizon banding engaged" in r.message and "compacted" in r.message
            for r in caplog.records
        )
        monkeypatch.setenv("FFTVIS_BAND", "0")
        v_ref = TPUSimulationEngine(nufft_mode="type3").simulate(**kw)
        scale = np.abs(v_ref).max()
        assert np.abs(v - v_ref).max() / scale < 5e-5

    def test_type3_fp64_banding_compacts_exactly(self, monkeypatch, caplog):
        """fp64 (CPU) type-3 compaction equals the unbanded program to
        summation-order rounding. (nufft_mode pins type-3: the FLOP model
        would otherwise choose the exact direct path at this size, which
        correctly bands via the block scan instead.)"""
        from fftvis_tpu.beams.interface import BeamInterface
        from fftvis_tpu.tpu.engine import TPUSimulationEngine

        kw = self._kw(True, nsrc=9000)
        kw["force_use_type3"] = True
        kw["beam_list"] = [BeamInterface(kw.pop("beam"))]
        monkeypatch.setenv("FFTVIS_BAND_BLOCK", "256")
        with caplog.at_level(logging.INFO, logger="fftvis_tpu.tpu.engine"):
            v_band = TPUSimulationEngine(nufft_mode="type3").simulate(**kw)
        assert any(
            "horizon banding engaged" in r.message and "compacted" in r.message
            for r in caplog.records
        )
        monkeypatch.setenv("FFTVIS_BAND", "0")
        v_ref = TPUSimulationEngine(nufft_mode="type3").simulate(**kw)
        scale = np.abs(v_ref).max()
        assert np.abs(v_band - v_ref).max() / scale < 1e-11

    def test_type3_capacity_planned_spreaders_stay_unbanded(
        self, monkeypatch, caplog
    ):
        """The strip/tiled XLA scans cost static capacity per call and
        their occupancy bounds assume one-block calls: no compaction."""
        from fftvis_tpu.beams.interface import (
            BeamInterface,
            prepare_beam_unpolarized,
        )
        from fftvis_tpu.tpu.engine import TPUSimulationEngine

        kw = self._kw(False, nsrc=9000)
        kw["force_use_type3"] = True
        kw["beam_list"] = [
            prepare_beam_unpolarized(BeamInterface(kw.pop("beam")))
        ]
        monkeypatch.setenv("FFTVIS_SPREADER", "tiled")
        monkeypatch.setenv("FFTVIS_BAND_BLOCK", "256")
        with caplog.at_level(logging.INFO, logger="fftvis_tpu.tpu.engine"):
            v = TPUSimulationEngine(nufft_mode="type3").simulate(**kw)
        assert not any(
            "horizon banding engaged" in r.message for r in caplog.records
        )
        monkeypatch.delenv("FFTVIS_SPREADER")
        v_ref = TPUSimulationEngine(nufft_mode="type3").simulate(**kw)
        scale = np.abs(v_ref).max()
        assert np.abs(v - v_ref).max() / scale < 1e-9

    def test_type3_compaction_per_antenna_beams(self, monkeypatch, caplog):
        """Pair routing (multi-beam) runs on the compacted mega-block:
        per-antenna-beam type-3 banding equals the unbanded program."""
        from fftvis_tpu.beams.interface import BeamInterface
        from fftvis_tpu.tpu.engine import TPUSimulationEngine

        kw = self._kw(True, nsrc=9000)
        kw.pop("beam")
        kw["beam_list"] = [
            BeamInterface(GaussianBeam(diameter=12.0)),
            BeamInterface(GaussianBeam(diameter=14.0)),
        ]
        kw["beam_idx"] = np.arange(len(kw["ants"])) % 2
        kw["force_use_type3"] = True
        monkeypatch.setenv("FFTVIS_BAND_BLOCK", "256")
        with caplog.at_level(logging.INFO, logger="fftvis_tpu.tpu.engine"):
            v_band = TPUSimulationEngine(nufft_mode="type3").simulate(**kw)
        assert any(
            "horizon banding engaged" in r.message and "compacted" in r.message
            for r in caplog.records
        )
        monkeypatch.setenv("FFTVIS_BAND", "0")
        v_ref = TPUSimulationEngine(nufft_mode="type3").simulate(**kw)
        scale = np.abs(v_ref).max()
        assert np.abs(v_band - v_ref).max() / scale < 1e-11

    def test_type3_compaction_eigenbeam_basis(self, monkeypatch, caplog):
        """The eigenbeam coefficient contraction consumes compacted
        per-pair grids: basis-path type-3 banding equals unbanded."""
        from fftvis_tpu import compute_beam_basis
        from fftvis_tpu.beams.interface import BeamInterface
        from fftvis_tpu.tpu.engine import TPUSimulationEngine

        kw = self._kw(True, nsrc=9000)
        kw.pop("beam")
        nant = len(kw["ants"])
        ant_beams = [
            GaussianBeam(diameter=12.0 + 0.5 * (i % 3)) for i in range(nant)
        ]
        eig, coefs = compute_beam_basis(
            ant_beams, float(kw["freqs"][0]), polarized=True,
            threshold=1e-8, n_axis1=121, n_axis2=61,
        )
        kw["beam_list"] = [BeamInterface(b) for b in eig]
        kw["beam_coefs"] = np.repeat(
            coefs[:, :, None], kw["freqs"].size, axis=2
        )
        kw["force_use_type3"] = True
        monkeypatch.setenv("FFTVIS_BAND_BLOCK", "256")
        with caplog.at_level(logging.INFO, logger="fftvis_tpu.tpu.engine"):
            v_band = TPUSimulationEngine(nufft_mode="type3").simulate(**kw)
        assert any(
            "horizon banding engaged" in r.message and "compacted" in r.message
            for r in caplog.records
        )
        monkeypatch.setenv("FFTVIS_BAND", "0")
        v_ref = TPUSimulationEngine(nufft_mode="type3").simulate(**kw)
        scale = np.abs(v_ref).max()
        assert np.abs(v_band - v_ref).max() / scale < 1e-11

    def test_banded_off_under_source_sharding(self, caplog):
        """The block table is a global-order construct: a sharded source
        axis disables banding (and still gets the right answer)."""
        import jax

        from fftvis_tpu.parallel import make_mesh

        kw = self._kw(False, nsrc=6000)
        mesh = make_mesh(time=1, freq=1, source=2,
                         devices=jax.devices("cpu")[:2])
        with caplog.at_level(logging.INFO, logger="fftvis_tpu.tpu.engine"):
            v_shard = simulate_vis(backend="tpu", mesh=mesh, **kw)
        assert not any(
            "horizon banding engaged" in r.message for r in caplog.records
        )
        v_ref = simulate_vis(**kw)
        scale = np.abs(v_ref).max()
        assert np.abs(v_shard - v_ref).max() / scale < 1e-11
