"""Analytic FLOP model + program cache-key construction properties."""

import dataclasses

import numpy as np
import pytest

from fftvis_tpu import TelescopeLocation
from fftvis_tpu.beams import GaussianBeam
from fftvis_tpu.beams.interface import (
    BeamInterface,
    prepare_beam_unpolarized,
)
from fftvis_tpu.flops import chip_peak_flops, mfu_string, program_model_flops
from fftvis_tpu.tpu.engine import TPUSimulationEngine
from fftvis_tpu.tpu.program import ProgramConfig, cache_key

LOC = TelescopeLocation(np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
JD0 = 2459863.2


def _info(nant=6, nsrc=40, nfreq=2, ntimes=2, gridded=False, **over):
    rng = np.random.default_rng(0)
    if gridded:
        ants = {
            i: np.array([14.6 * (i % 3), 14.6 * (i // 3), 0.0])
            for i in range(nant)
        }
    else:
        ants = {
            i: np.array([*rng.uniform(-60, 60, 2), 0.0]) for i in range(nant)
        }
    kw = dict(
        ants=ants,
        fluxes=rng.uniform(0.1, 1, (nsrc, nfreq)),
        ra=rng.uniform(0, 2 * np.pi, nsrc),
        dec=np.clip(
            LOC.lat + rng.normal(0, 0.4, nsrc), -np.pi / 2, np.pi / 2
        ),
        freqs=np.linspace(1e8, 1.2e8, nfreq),
        times=JD0 + np.linspace(0, 0.01, ntimes),
        telescope_loc=LOC,
        polarized=False,
        precision=2,
    )
    kw.update(over)
    beam = prepare_beam_unpolarized(BeamInterface(GaussianBeam(diameter=12.0)))
    run, inputs, info = TPUSimulationEngine().simulate(
        beam_list=[beam], return_program="full", **kw
    )
    return info


class TestFlopModel:
    def test_returns_positive_terms_and_total(self):
        info = _info()
        terms = program_model_flops(info["program_config"], ntimes=2)
        assert terms["total"] > 0
        assert all(v >= 0 for v in terms.values())
        assert terms["total"] == pytest.approx(
            sum(v for k, v in terms.items() if k != "total")
        )

    def test_scales_linearly_in_times(self):
        cfg = _info()["program_config"]
        t2 = program_model_flops(cfg, ntimes=2)["total"]
        t4 = program_model_flops(cfg, ntimes=4)["total"]
        assert t4 == pytest.approx(2 * t2)

    def test_gridded_exact_dominant_term(self):
        """For the factored separable DFT the 8 C n nm_y nm_x contraction
        must dominate and match the closed form."""
        info = _info(gridded=True, nsrc=200)
        cfg = info["program_config"]
        plan = cfg.plan
        if not hasattr(plan.executor.plan, "split"):
            pytest.skip("engine chose the ES type-1 variant here")
        terms = program_model_flops(cfg, ntimes=2)
        cells = float(np.prod(plan.executor.plan.nf))
        C = cfg.npairs * cfg.nfeeds**2
        n = plan.nsrc_pad
        expect = 2 * cfg.nfreqs * 8.0 * C * n * cells
        assert terms["t1x_contract"] == pytest.approx(expect)

    def test_mfu_string_shapes(self):
        s = mfu_string(1e9, 1e-3)
        assert "GFLOP" in s and "TFLOP/s" in s
        peak, label = chip_peak_flops()
        # CPU test backend: no device peak -> mfu omitted, label still set.
        if peak is None:
            assert "mfu" not in s
        else:
            assert "mfu=" in s

    def test_cpu_backend_has_no_peak(self):
        peak, label = chip_peak_flops("float32")
        assert peak is None and label


class TestPeakTable:
    """The H100 table (NVIDIA data sheet, SXM, dense) and its lookups."""

    class _Dev:
        platform = "gpu"

        def __init__(self, kind):
            self.device_kind = kind

    def _patch(self, monkeypatch, kind):
        import jax

        monkeypatch.setattr(jax, "devices", lambda *a: [self._Dev(kind)])

    def test_h100_rates(self):
        from fftvis_tpu.flops import PEAKS

        h100 = PEAKS["NVIDIA H100 80GB HBM3"]
        assert h100 == {"float32": 67e12, "tf32": 495e12, "bf16": 989e12,
                        "hbm_bytes_per_s": 3.35e12}

    @pytest.mark.parametrize(
        "prec,rate",
        [("float32", 67e12), ("highest", 67e12), ("tensorfloat32", 495e12),
         ("bfloat16", 989e12)],
    )
    def test_precision_selects_unit(self, monkeypatch, prec, rate):
        self._patch(monkeypatch, "NVIDIA H100 80GB HBM3")
        peak, label = chip_peak_flops(prec)
        assert peak == rate and "H100" in label

    def test_unknown_gpu_raises(self, monkeypatch):
        self._patch(monkeypatch, "NVIDIA Imaginary 9000")
        with pytest.raises(KeyError, match="Imaginary"):
            chip_peak_flops("float32")
        with pytest.raises(KeyError):
            mfu_string(1e9, 1e-3)


class TestCacheKeyConstruction:
    def test_every_field_participates_or_justifies(self):
        """The cache key must iterate EVERY ProgramConfig field: hashed,
        fingerprinted, or excluded with a written covered_by reason."""
        for f in dataclasses.fields(ProgramConfig):
            meta = f.metadata
            if meta.get("key", True) is False:
                assert meta.get("covered_by"), f.name

    def test_unjustified_exclusion_raises(self):
        """An excluded field WITHOUT a covered_by justification must make
        cache_key raise (the forgettable-knob guard)."""
        import dataclasses as dc

        from fftvis_tpu.tpu import program as prog_mod

        @dc.dataclass
        class Bad(ProgramConfig):
            rogue: int = dc.field(default=0, metadata={"key": False})

        cfg = _info()["program_config"]
        bad = Bad(**{f.name: getattr(cfg, f.name)
                     for f in dc.fields(ProgramConfig)})
        orig = prog_mod.ProgramConfig
        prog_mod.ProgramConfig = Bad
        try:
            with pytest.raises(AssertionError, match="covered_by"):
                cache_key(bad)
        finally:
            prog_mod.ProgramConfig = orig

    def test_key_changes_with_env_knob(self, monkeypatch):
        """ALL FFTVIS_* env vars key the program cache wholesale."""
        cfg = _info()["program_config"]
        k1 = cache_key(cfg)
        monkeypatch.setenv("FFTVIS_SOME_FUTURE_KNOB", "1")
        k2 = cache_key(cfg)
        assert k1 != k2

    def test_key_stable_for_same_config(self):
        cfg = _info()["program_config"]
        assert cache_key(cfg) == cache_key(cfg)
