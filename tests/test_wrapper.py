"""Public API contract tests (ref tests/test_wrapper.py:22-322):
shapes, dtypes, validation error messages, factories, coherency prep."""

import numpy as np
import pytest

from fftvis_tpu import (
    TelescopeLocation,
    create_beam_evaluator,
    create_simulation_engine,
    default_accuracy_dict,
    simulate_vis,
)
from fftvis_tpu.beams import GaussianBeam
from fftvis_tpu.core.coherency import prepare_source_catalog

LOC = TelescopeLocation(np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
JD0 = 2459863.2


def _kwargs(rng, nant=4, nsrc=12, nfreq=2, ntimes=2, **over):
    ants = {i: np.array([*rng.uniform(-40, 40, 2), 0.0]) for i in range(nant)}
    kw = dict(
        ants=ants,
        fluxes=rng.uniform(0.1, 1, (nsrc, nfreq)),
        ra=rng.uniform(0, 2 * np.pi, nsrc),
        dec=np.clip(LOC.lat + rng.normal(0, 0.4, nsrc), -np.pi / 2, np.pi / 2),
        freqs=np.linspace(1e8, 1.2e8, nfreq),
        times=JD0 + np.linspace(0, 0.01, ntimes),
        beam=GaussianBeam(diameter=10.0),
        telescope_loc=LOC,
    )
    kw.update(over)
    return kw


class TestShapes:
    def test_unpolarized_shape_dtype(self):
        rng = np.random.default_rng(0)
        v = simulate_vis(**_kwargs(rng), polarized=False, precision=2)
        assert v.dtype == np.complex128
        nbl = v.shape[-1]
        assert v.shape == (2, 2, nbl)

    def test_polarized_shape(self):
        rng = np.random.default_rng(0)
        v = simulate_vis(**_kwargs(rng), polarized=True)
        assert v.shape[:4] == (2, 2, 2, 2)
        assert v.ndim == 5

    def test_precision1_dtype(self):
        rng = np.random.default_rng(0)
        v = simulate_vis(**_kwargs(rng), precision=1)
        assert v.dtype == np.complex64

    def test_async_fetch_matches_sync(self):
        """async_fetch=True returns a VisibilityFuture resolving to the
        synchronous result; several in-flight futures resolve independently
        and np.asarray(future) works."""
        from fftvis_tpu import VisibilityFuture

        rng = np.random.default_rng(3)
        kw = _kwargs(rng, ntimes=2)
        want = simulate_vis(**kw, polarized=True)
        futs = [simulate_vis(**kw, polarized=True, async_fetch=True)
                for _ in range(3)]
        assert all(isinstance(f, VisibilityFuture) for f in futs)
        for f in futs:
            got = f.result()
            np.testing.assert_allclose(got, want, rtol=0, atol=0)
            assert f.result() is got  # memoized
            assert f.done()
        np.testing.assert_allclose(np.asarray(futs[0]), want)

    def test_async_fetch_direct_backend_resolved(self):
        """Backends without a deferred fetch hand back a pre-resolved
        future with identical contents."""
        from fftvis_tpu import VisibilityFuture

        rng = np.random.default_rng(4)
        kw = _kwargs(rng, nsrc=6, ntimes=1)
        want = simulate_vis(**kw, backend="direct")
        fut = simulate_vis(**kw, backend="direct", async_fetch=True)
        assert isinstance(fut, VisibilityFuture)
        assert fut.done()
        np.testing.assert_allclose(fut.result(), want)

    def test_baselines_shape(self):
        rng = np.random.default_rng(0)
        v = simulate_vis(**_kwargs(rng), baselines=[(0, 1), (1, 2)])
        assert v.shape == (2, 2, 2)

    def test_scalar_freq_and_time(self):
        rng = np.random.default_rng(0)
        v = simulate_vis(**_kwargs(rng, nfreq=1, ntimes=1))
        assert v.shape[0] == 1 and v.shape[1] == 1


class TestValidation:
    def test_default_eps(self):
        assert default_accuracy_dict == {1: 6e-8, 2: 1e-13}

    def test_bad_backend(self):
        rng = np.random.default_rng(0)
        with pytest.raises(ValueError, match="Unsupported backend"):
            simulate_vis(**_kwargs(rng), backend="quantum")

    def test_gpu_backend_maps_to_jax_engine(self):
        """backend="gpu" selects the JAX engine and evaluator (the
        reference's GPU stubs raise; here the engine runs on the card)."""
        from fftvis_tpu import TPUBeamEvaluator, TPUSimulationEngine

        assert isinstance(
            create_simulation_engine(backend="gpu"), TPUSimulationEngine
        )
        assert isinstance(create_beam_evaluator(backend="gpu"), TPUBeamEvaluator)

    def test_beam_idx_inference_error(self):
        rng = np.random.default_rng(0)
        kw = _kwargs(rng)
        kw["beam"] = [GaussianBeam(diameter=10.0), GaussianBeam(diameter=12.0)]
        with pytest.raises(ValueError, match="beam_idx must be provided"):
            simulate_vis(**kw)

    def test_beam_idx_and_coefs_conflict(self):
        rng = np.random.default_rng(0)
        kw = _kwargs(rng)
        kw["beam"] = [GaussianBeam(diameter=10.0)] * 2
        with pytest.raises(ValueError, match="beam_idx should not be provided"):
            simulate_vis(
                **kw,
                beam_idx=np.zeros(4, dtype=int),
                beam_coefs=np.ones((4, 2, 2)),
                polarized=True,
            )

    def test_polarized_sky_requires_polarized(self):
        rng = np.random.default_rng(0)
        kw = _kwargs(rng)
        kw["fluxes"] = rng.uniform(0.1, 1, (12, 2, 4))
        with pytest.raises(ValueError, match="requires sky_model to be 2D"):
            simulate_vis(**kw, polarized=False)

    def test_evaluator_factory(self):
        ev = create_beam_evaluator(backend="tpu")
        assert ev.beam_list == [] and ev.beam_idx is None

    def test_coord_method_params_unknown_key_raises(self):
        """A typo'd coord_method_params key must not be silently swallowed
        (ref core/simulate.py:118-126 forwards them into the rotation)."""
        rng = np.random.default_rng(0)
        with pytest.raises(ValueError, match="unknown coord_method_params"):
            simulate_vis(
                **_kwargs(rng),
                coord_method_params={"update_bcrs_evry": 10.0},
            )

    def test_coord_method_params_known_keys_accepted(self):
        """The reference's documented CoordinateRotation kwargs are
        accepted (update_bcrs_every / source_buffer / chunk_size are
        documented no-ops here; include_aberration is honored)."""
        rng = np.random.default_rng(0)
        kw = _kwargs(rng)
        want = simulate_vis(**kw)
        got = simulate_vis(
            **kw,
            coord_method_params={
                "update_bcrs_every": 10.0,
                "source_buffer": 0.75,
                "chunk_size": 100,
            },
        )
        np.testing.assert_allclose(got, want, rtol=0, atol=0)


class TestPrepareSourceCatalog:
    def test_unpolarized_half(self):
        flux = np.ones((5, 3))
        coh, pol = prepare_source_catalog(flux, polarized_beam=False)
        assert not pol
        np.testing.assert_allclose(coh, 0.5)

    def test_polarized_coherency(self):
        sky = np.zeros((2, 1, 4))
        sky[..., 0] = 2.0  # I
        sky[..., 1] = 1.0  # Q
        sky[..., 3] = 0.5  # V
        coh, pol = prepare_source_catalog(sky, polarized_beam=True)
        assert pol and coh.shape == (2, 1, 2, 2)
        np.testing.assert_allclose(coh[0, 0, 0, 0], 1.5)  # (I+Q)/2
        np.testing.assert_allclose(coh[0, 0, 1, 1], 0.5)  # (I-Q)/2
        np.testing.assert_allclose(coh[0, 0, 0, 1], 0.25j)  # (U+iV)/2
        np.testing.assert_allclose(coh[0, 0, 1, 0], -0.25j)

    def test_bad_ndim(self):
        with pytest.raises(ValueError, match="2D unpolarized"):
            prepare_source_catalog(np.ones((3, 2, 3)), polarized_beam=True)


class TestEvaluatorBridge:
    def test_interp_bridge(self):
        """The matvis-style interp() adapter (ref core/beams.py:106-139)."""
        ev = create_beam_evaluator()
        ev.beam_list = [GaussianBeam(diameter=10.0)]
        ev.polarized = True
        ev.freq = 1e8
        tx = np.array([0.1, 0.0])
        ty = np.array([0.0, 0.1])
        out = np.zeros((1, 2, 2, 2), dtype=complex)
        ev.interp(tx, ty, out)
        assert np.all(np.isfinite(out)) and np.abs(out).max() > 0

    def test_evaluate_beam_check(self):
        ev = create_beam_evaluator()
        vals = ev.evaluate_beam(
            GaussianBeam(diameter=10.0),
            az=np.zeros(3),
            za=np.linspace(0, 0.4, 3),
            polarized=True,
            freq=1e8,
            check=True,
        )
        assert vals.shape == (2, 2, 3)

    def test_apparent_flux(self):
        ev = create_beam_evaluator()
        rng = np.random.default_rng(0)
        beam = rng.normal(size=(2, 2, 5)) + 1j * rng.normal(size=(2, 2, 5))
        flux = rng.uniform(1, 2, 5)
        want = np.einsum("afs,s,ags->fgs", beam.conj(), flux, beam)
        got = ev.get_apparent_flux_polarized(beam.copy(), flux)
        np.testing.assert_allclose(got, want, atol=1e-12)


class TestGPUBackend:
    """backend="gpu" runs the JAX engine end to end (the reference's GPU
    backend is a stub, ref tests/test_gpu_nufft.py:7-65)."""

    @pytest.mark.parametrize("polarized", [False, True])
    def test_simulate_vis_gpu_equals_tpu_name(self, polarized):
        rng = np.random.default_rng(3)
        kw = _kwargs(rng, nfreq=2, ntimes=2)
        kw["polarized"] = polarized
        got = simulate_vis(backend="gpu", **kw)
        want = simulate_vis(backend="tpu", **kw)
        np.testing.assert_array_equal(got, want)

    def test_gpu_backend_accepts_a_mesh(self):
        from fftvis_tpu.parallel.mesh import make_mesh

        rng = np.random.default_rng(4)
        kw = _kwargs(rng, nfreq=2, ntimes=2)
        want = simulate_vis(backend="gpu", **kw)
        got = simulate_vis(backend="gpu", mesh=make_mesh(time=2), **kw)
        np.testing.assert_allclose(got, want, atol=1e-9 * np.abs(want).max())

    def test_cli_accepts_gpu_backend(self):
        from fftvis_tpu.cli import build_parser

        args = build_parser().parse_args(["run-profile", "--backend", "gpu"])
        assert args.backend == "gpu"


class TestEngineABC:
    def test_evaluate_vis_chunk_not_supported(self):
        from fftvis_tpu.tpu.engine import TPUSimulationEngine

        with pytest.raises(NotImplementedError, match="jitted blocks"):
            TPUSimulationEngine()._evaluate_vis_chunk()

    def test_resolve_precision(self):
        from fftvis_tpu.core.simulate import resolve_precision

        r, c = resolve_precision(1)
        assert r == np.float32 and c == np.complex64
        r, c = resolve_precision(2)  # CPU tests have x64 enabled
        assert r == np.float64 and c == np.complex128
        with pytest.raises(ValueError):
            resolve_precision(3)

    def test_bad_nufft_mode(self):
        from fftvis_tpu.tpu.engine import TPUSimulationEngine

        with pytest.raises(ValueError, match="invalid nufft_mode"):
            TPUSimulationEngine(nufft_mode="warp")


class TestCaches:
    def test_program_cache_hits(self):
        """Repeated identical simulations reuse the compiled program."""
        from fftvis_tpu.tpu import engine as eng_mod

        rng = np.random.default_rng(1)
        kw = _kwargs(rng)
        simulate_vis(**kw)
        n_before = len(eng_mod._PROGRAM_CACHE)
        a = simulate_vis(**kw)
        assert len(eng_mod._PROGRAM_CACHE) == n_before
        b = simulate_vis(**kw)
        np.testing.assert_array_equal(a, b)

    def test_program_cache_distinguishes_configs(self):
        from fftvis_tpu.tpu import engine as eng_mod

        rng = np.random.default_rng(1)
        kw = _kwargs(rng)
        simulate_vis(**kw)
        n_before = len(eng_mod._PROGRAM_CACHE)
        # Different polarization => different program.
        simulate_vis(**{**kw, "polarized": True})
        assert len(eng_mod._PROGRAM_CACHE) >= n_before


class TestDegenerateSkies:
    """Degenerate inputs must produce exact zeros, not NaNs or crashes
    (the static horizon cull keeps a masked sentinel source; zero flux
    rides the whole pipeline)."""

    def _kw(self, rng, **over):
        ants = {i: np.array([*rng.uniform(-40, 40, 2), 0.0]) for i in range(3)}
        base = dict(
            ants=ants,
            fluxes=rng.uniform(0.1, 1.0, (6, 2)),
            ra=rng.uniform(0, 2 * np.pi, 6),
            dec=np.full(6, np.deg2rad(85.0)),  # never visible from -30.7
            freqs=np.array([1.0e8, 1.1e8]),
            times=2459863.2 + np.linspace(0, 0.01, 2),
            beam=GaussianBeam(diameter=12.0),
            telescope_loc=LOC,
            precision=2,
        )
        base.update(over)
        return base

    def test_all_sources_below_horizon_yields_zeros(self):
        rng = np.random.default_rng(41)
        vis = simulate_vis(**self._kw(rng))
        assert vis.shape[-1] > 0
        np.testing.assert_array_equal(vis, np.zeros_like(vis))

    def test_zero_flux_yields_zeros(self):
        rng = np.random.default_rng(42)
        lat = float(LOC.lat)
        kw = self._kw(
            rng,
            fluxes=np.zeros((6, 2)),
            dec=np.clip(lat + rng.normal(0, 0.3, 6), -np.pi / 2, np.pi / 2),
        )
        vis = simulate_vis(**kw)
        np.testing.assert_array_equal(vis, np.zeros_like(vis))


def test_matmul_precision_knob_never_touches_fp64(monkeypatch):
    """FFTVIS_MATMUL_PRECISION tunes f32 pipelines only: demoting f64
    matmul passes would silently break the precision=2 contract on fp64
    backends, so the engine must ignore the knob there."""
    import numpy as np

    from fftvis_tpu import TelescopeLocation, simulate_vis
    from fftvis_tpu.beams import GaussianBeam

    rng = np.random.default_rng(3)
    loc = TelescopeLocation(np.deg2rad(-30.7), np.deg2rad(21.4), 1000.0)
    ants = {i: np.array([*rng.uniform(-50, 50, 2), 0.0]) for i in range(3)}
    kw = dict(
        ants=ants, fluxes=rng.uniform(0.1, 1, (16, 2)),
        ra=rng.uniform(0, 2 * np.pi, 16), dec=rng.uniform(-1.2, -0.2, 16),
        freqs=np.linspace(1e8, 1.2e8, 2),
        times=2459863.2 + np.linspace(0, 0.01, 2),
        beam=GaussianBeam(diameter=12.0), telescope_loc=loc, polarized=True,
        precision=2,
    )
    v1 = simulate_vis(**kw)
    monkeypatch.setenv("FFTVIS_MATMUL_PRECISION", "high")
    v2 = simulate_vis(**kw)
    np.testing.assert_array_equal(v1, v2)


def test_matmul_precision_knob_engages_f32_pipelines(monkeypatch):
    """FFTVIS_MATMUL_PRECISION=high must actually reach
    jax.default_matmul_precision on f32 pipelines (regression: a
    str(np.float32) string comparison made the knob a silent no-op)."""
    import jax

    seen = []
    orig = jax.default_matmul_precision

    def recorder(prec):
        seen.append(prec)
        return orig(prec)

    monkeypatch.setattr(jax, "default_matmul_precision", recorder)
    monkeypatch.setenv("FFTVIS_MATMUL_PRECISION", "high")
    rng = np.random.default_rng(5)
    simulate_vis(**_kwargs(rng), polarized=False, precision=1)
    assert "high" in seen


def test_baselines_accept_ndarray_and_lists():
    """The baseline list may be an (nbl, 2) ndarray or a list of 2-lists
    (regression: the baseline-index memo key assumed hashable elements)."""
    rng = np.random.default_rng(6)
    kw = _kwargs(rng)
    bls = [(0, 1), (1, 2), (0, 3)]
    v_tuples = simulate_vis(**kw, baselines=bls, polarized=False)
    v_array = simulate_vis(**kw, baselines=np.array(bls), polarized=False)
    v_lists = simulate_vis(**kw, baselines=[list(b) for b in bls], polarized=False)
    np.testing.assert_array_equal(v_tuples, v_array)
    np.testing.assert_array_equal(v_tuples, v_lists)


def test_future_array_copy_semantics():
    """np.array(fut, copy=True) must not alias the memoized result
    (NumPy 2 passes ``copy`` through __array__), and copy=False with a
    dtype conversion must refuse."""
    rng = np.random.default_rng(7)
    fut = simulate_vis(**_kwargs(rng), polarized=False, async_fetch=True)
    res = fut.result()
    a = fut.__array__(copy=True)
    assert a is not res
    a *= 2.0
    np.testing.assert_array_equal(fut.result(), res)
    assert fut.__array__() is res  # plain asarray may share
    with pytest.raises(ValueError, match="copy"):
        fut.__array__(dtype=np.complex64, copy=False)


def test_async_fetch_snapshots_beam_coefs(monkeypatch):
    """Mutating beam_coefs in place between dispatch and result() must not
    change an in-flight eigenbeam sim (the DS assembly contracts
    coefficients on the host at result() time)."""
    monkeypatch.setenv("FFTVIS_DS", "1")  # the deferred-contraction path
    from fftvis_tpu import compute_beam_basis
    from fftvis_tpu.beams import GaussianBeam as _GB

    rng = np.random.default_rng(9)
    ants = {i: np.array([*rng.uniform(-40, 40, 2), 0.0]) for i in range(4)}
    beams = [_GB(diameter=12.0 + 0.3 * i) for i in range(4)]
    eig, coefs = compute_beam_basis(
        beams, 1.0e8, polarized=True, threshold=1e-10, n_axis1=41, n_axis2=21
    )
    kw = dict(
        ants=ants,
        fluxes=rng.uniform(0.1, 1, (12, 1)),
        ra=rng.uniform(0, 2 * np.pi, 12),
        dec=np.clip(LOC.lat + rng.normal(0, 0.4, 12), -np.pi / 2, np.pi / 2),
        freqs=np.array([1.0e8]),
        times=JD0 + np.linspace(0, 0.01, 2),
        beam=eig,
        telescope_loc=LOC,
        polarized=True,
        precision=1,  # f32 pipeline + FFTVIS_DS=1 => the DS direct path
    )
    coefs_live = np.array(coefs[:, :, None])
    want = simulate_vis(beam_coefs=coefs_live, **kw)
    assert want.dtype == np.complex128  # proves the DS path engaged
    fut = simulate_vis(beam_coefs=coefs_live, async_fetch=True, **kw)
    coefs_live *= 0.0  # caller reuses the buffer for the "next" sim
    np.testing.assert_array_equal(fut.result(), want)


def test_future_releases_assembly_after_result():
    """result() drops the device buffer and the assembly closure (which
    pins MB-scale engine locals), and done() is True afterwards."""
    rng = np.random.default_rng(10)
    fut = simulate_vis(**_kwargs(rng), polarized=False, async_fetch=True)
    fut.result()
    assert fut._dev is None and fut._assemble is None
    assert fut.done()
    # memoized result still available
    assert fut.result() is fut.result()


def test_future_done_warns_once_without_is_ready(caplog):
    """On a backend whose arrays lack is_ready(), done() conservatively
    returns False and logs a one-time warning so a polling consumer
    learns it has degraded to serial collection."""
    import logging

    from fftvis_tpu.tpu.engine import VisibilityFuture

    class _NoPollBuffer:
        def copy_to_host_async(self):
            pass

        def is_ready(self):
            raise AttributeError("no is_ready on this backend")

    VisibilityFuture._warned_no_poll = False
    fut = VisibilityFuture(_NoPollBuffer(), lambda s: s)
    with caplog.at_level(logging.WARNING, logger="fftvis_tpu.tpu.engine"):
        assert fut.done() is False
        assert fut.done() is False
    warnings = [r for r in caplog.records if "is_ready" in r.message]
    assert len(warnings) == 1  # one-time, not per poll


class TestUpsampleDefault:
    """upsample_factor default (None) must resolve to sigma=2 on EVERY
    pipeline. Pinned here: auto-lowering f32 type-3 to sigma=1.25 would
    be faster but degrades accuracy config-dependently to ~5e-4 relative
    (kernel/deconv dynamic
    range at the narrower band; NOT rescued by DS coordinates) -- see
    planning.plan_transform's docstring. Explicit sigma=1.25 remains
    honored for callers that accept that error class."""

    def _type3_sigma(self, upsample, precision):
        from fftvis_tpu.beams.interface import (
            BeamInterface,
            prepare_beam_unpolarized,
        )
        from fftvis_tpu.tpu.engine import TPUSimulationEngine

        rng = np.random.default_rng(0)
        kw = _kwargs(rng, nant=5, nsrc=400)
        kw.pop("beam")
        beam = prepare_beam_unpolarized(
            BeamInterface(GaussianBeam(diameter=10.0))
        )
        eng = TPUSimulationEngine(nufft_mode="type3")
        run, inputs, info = eng.simulate(
            beam_list=[beam], return_program="full", polarized=False,
            precision=precision, force_use_type3=True,
            upsample_factor=upsample, **kw,
        )
        plan = info["program_config"].plan
        assert plan.mode == "type3"
        return plan.executor.plan.kernel.sigma

    def test_default_f32_is_sigma_2(self):
        assert self._type3_sigma(None, precision=1) == 2.0

    def test_default_fp64_is_sigma_2(self):
        assert self._type3_sigma(None, precision=2) == 2.0

    def test_explicit_sigma_125_honored(self):
        assert self._type3_sigma(1.25, precision=1) == 1.25

    def test_default_equals_explicit_sigma_2(self):
        rng = np.random.default_rng(1)
        kw = _kwargs(rng, nant=5, nsrc=300)
        v_none = simulate_vis(**kw, precision=1, force_use_type3=True)
        v_two = simulate_vis(
            **kw, precision=1, force_use_type3=True, upsample_factor=2
        )
        np.testing.assert_array_equal(v_none, v_two)
