"""Batched hot-path equivalence: stacked beam evaluation, fused pair
coherency, and scatter-free pair assembly.

These paths exist purely for device efficiency (one interpolation /
one contraction / one permutation instead of per-beam, per-pair ops); each
must be bit-compatible-or-tight with the straightforward per-item form the
oracle tests validate. Mirrors the reference's evaluator unit tests
(ref tests/test_cpu_beams.py:708-854) at the layer the JAX engine actually
executes.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from fftvis_tpu import TelescopeLocation, simulate_vis
from fftvis_tpu.beams import GaussianBeam, GriddedBeam
from fftvis_tpu.beams.interface import prepare_beams, stack_prepared
from fftvis_tpu.core import coherency as coh

LOC = TelescopeLocation(np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
JD0 = 2459863.2
FREQS = np.array([1.0e8, 1.17e8])


def _gridded(diameter, n_az=90, n_za=46, za_max=np.pi / 2, freqs=FREQS):
    return GriddedBeam.from_function(
        GaussianBeam(diameter=diameter), n_az=n_az, n_za=n_za,
        freqs=freqs, za_max=za_max,
    )


def _angles(rng, n=64):
    az = rng.uniform(0, 2 * np.pi, n)
    za = rng.uniform(0, np.pi / 2, n)
    return jnp.asarray(az), jnp.asarray(za)


class TestStackPrepared:
    @pytest.mark.parametrize("order", [1, 3])
    @pytest.mark.parametrize("polarized", [False, True])
    def test_matches_per_beam(self, order, polarized):
        rng = np.random.default_rng(3)
        beams = [_gridded(10.0 + i) for i in range(4)]
        prepared = prepare_beams(
            beams, freqs=FREQS, polarized=polarized,
            spline_opts={"order": order},
        )
        batched = stack_prepared(prepared)
        assert batched is not None
        assert batched.nbeams == 4
        assert batched.polarized == polarized
        az, za = _angles(rng)
        for fi in range(len(FREQS)):
            stacked = batched.evaluate_all(az, za, FREQS[fi], fi)
            for k, pb in enumerate(prepared):
                single = pb.evaluate(az, za, FREQS[fi], fi)
                np.testing.assert_allclose(
                    np.asarray(stacked[k]), np.asarray(single),
                    rtol=0, atol=1e-14,
                )

    def test_single_beam_not_stacked(self):
        prepared = prepare_beams([_gridded(12.0)], freqs=FREQS, polarized=True)
        assert stack_prepared(prepared) is None

    def test_mismatched_grids_not_stacked(self):
        prepared = prepare_beams(
            [_gridded(12.0, n_az=90), _gridded(12.0, n_az=120)],
            freqs=FREQS, polarized=True,
        )
        assert stack_prepared(prepared) is None

    def test_analytic_beams_not_stacked(self):
        prepared = prepare_beams(
            [GaussianBeam(diameter=12.0), GaussianBeam(diameter=13.0)],
            freqs=FREQS, polarized=True,
        )
        assert stack_prepared(prepared) is None

    def test_mixed_tabulated_analytic_not_stacked(self):
        prepared = prepare_beams(
            [_gridded(12.0), GaussianBeam(diameter=13.0)],
            freqs=FREQS, polarized=True,
        )
        assert stack_prepared(prepared) is None


class TestBatchedCoherencyRows:
    """apparent_coherency_rows_batched == per-pair concatenation, for all
    three (polarized, polarized_sky) modes and every pair ordering."""

    def _evals(self, rng, K, nsrc, polarized):
        if polarized:
            return jnp.asarray(
                rng.normal(size=(K, 2, 2, nsrc))
                + 1j * rng.normal(size=(K, 2, 2, nsrc))
            )
        return jnp.asarray(rng.uniform(0.1, 1.0, (K, nsrc)))

    @pytest.mark.parametrize(
        "polarized,polarized_sky", [(False, False), (True, False), (True, True)]
    )
    def test_matches_loop(self, polarized, polarized_sky):
        rng = np.random.default_rng(7)
        K, nsrc = 3, 50
        evals = self._evals(rng, K, nsrc, polarized)
        if polarized_sky:
            flux = jnp.asarray(
                rng.normal(size=(nsrc, 2, 2)) + 1j * rng.normal(size=(nsrc, 2, 2))
            )
        else:
            flux = jnp.asarray(rng.uniform(0.1, 1.0, nsrc))
        pairs = [(k, l) for k in range(K) for l in range(k, K)]
        idx_i = np.array([p[0] for p in pairs])
        idx_j = np.array([p[1] for p in pairs])

        batched = coh.apparent_coherency_rows_batched(
            evals, idx_i, idx_j, flux, polarized, polarized_sky
        )
        loop = jnp.concatenate(
            [
                coh.apparent_coherency_rows(
                    evals[i], evals[j], flux, polarized, polarized_sky
                )
                for i, j in pairs
            ],
            axis=0,
        )
        assert batched.shape == loop.shape
        np.testing.assert_allclose(
            np.asarray(batched), np.asarray(loop), rtol=0, atol=1e-13
        )

    def test_flip_convention_polarized_sky(self):
        """The vector-axis flip must act per beam BEFORE pair indexing
        (regression guard: flipping after the gather is identical only when
        idx is the identity)."""
        rng = np.random.default_rng(11)
        evals = self._evals(rng, 2, 8, True)
        flux = jnp.asarray(
            rng.normal(size=(8, 2, 2)) + 1j * rng.normal(size=(8, 2, 2))
        )
        out = coh.apparent_coherency_rows_batched(
            evals, np.array([1]), np.array([0]), flux, True, True
        )
        ref = coh.apparent_coherency_rows(evals[1], evals[0], flux, True, True)
        np.testing.assert_allclose(
            np.asarray(out[0:4]), np.asarray(ref), rtol=0, atol=1e-13
        )


class TestAssemblyPermutation:
    """Scatter-free pair assembly: shuffled baseline orders and multi-pair
    routing must land every visibility at its own baseline slot."""

    def _sim(self, baselines, beam_idx=None, beams=None, polarized=True):
        rng = np.random.default_rng(5)
        ants = {i: np.array([*rng.uniform(-40, 40, 2), 0.0]) for i in range(4)}
        ra = rng.uniform(0, 2 * np.pi, 30)
        dec = np.clip(LOC.lat + rng.normal(0, 0.3, 30), -np.pi / 2, np.pi / 2)
        flux = rng.uniform(0.1, 1.0, (30, len(FREQS)))
        kw = dict(
            ants=ants, fluxes=flux, ra=ra, dec=dec, freqs=FREQS,
            times=JD0 + np.linspace(0, 0.01, 2), telescope_loc=LOC,
            polarized=polarized, precision=2, baselines=baselines,
        )
        if beams is not None:
            kw["beam"] = beams
            kw["beam_idx"] = beam_idx
        else:
            kw["beam"] = _gridded(11.0)
        return simulate_vis(**kw)

    def test_baseline_order_is_a_permutation(self):
        bls = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
        ref = self._sim(bls)
        perm = [3, 0, 5, 2, 4, 1]
        shuffled = self._sim([bls[i] for i in perm])
        for out_slot, src_slot in enumerate(perm):
            np.testing.assert_allclose(
                shuffled[..., out_slot], ref[..., src_slot],
                rtol=0, atol=1e-12,
            )

    def test_multi_pair_routing_permutation(self):
        """Two distinct per-antenna beams: routing splits baselines across
        beam pairs; the inverse permutation must restore input order."""
        beams = [_gridded(10.0), _gridded(14.0)]
        beam_idx = np.array([0, 1, 0, 1])
        bls = [(0, 1), (2, 3), (0, 2), (1, 3), (3, 0), (1, 2)]
        ref = self._sim(bls, beam_idx=beam_idx, beams=beams)
        perm = [5, 2, 0, 4, 1, 3]
        shuffled = self._sim(
            [bls[i] for i in perm], beam_idx=beam_idx, beams=beams
        )
        for out_slot, src_slot in enumerate(perm):
            np.testing.assert_allclose(
                shuffled[..., out_slot], ref[..., src_slot],
                rtol=0, atol=1e-12,
            )

    def test_engine_matches_unbatched_fallback(self, monkeypatch):
        """Disabling stack_prepared (per-beam fallback) must not change the
        result beyond accumulation-order noise."""
        import fftvis_tpu.tpu.engine as eng_mod

        beams = [_gridded(10.0), _gridded(14.0)]
        beam_idx = np.array([0, 1, 0, 1])
        bls = [(0, 1), (2, 3), (0, 2), (1, 3)]
        batched = self._sim(bls, beam_idx=beam_idx, beams=beams)
        monkeypatch.setattr(eng_mod, "stack_prepared", lambda prepared: None)
        # A fresh trace is required: the program cache key does not include
        # the monkeypatch, so clear it.
        eng_mod._PROGRAM_CACHE.clear()
        unbatched = self._sim(bls, beam_idx=beam_idx, beams=beams)
        eng_mod._PROGRAM_CACHE.clear()
        np.testing.assert_allclose(batched, unbatched, rtol=0, atol=1e-10)


def test_skewed_routing_uses_per_pair_loop_and_matches():
    """One dominant beam + several outliers: npairs * m_max exceeds the
    padded-routing waste bound, so the engine takes the work-optimal
    per-pair loop; the result is validated against the exact fp64
    direct-DFT oracle."""
    rng = np.random.default_rng(23)
    nant = 14
    ants = {i: np.array([*rng.uniform(-50, 50, 2), 0.0]) for i in range(nant)}
    ra = rng.uniform(0, 2 * np.pi, 25)
    dec = np.clip(LOC.lat + rng.normal(0, 0.3, 25), -np.pi / 2, np.pi / 2)
    flux = rng.uniform(0.1, 1.0, (25, len(FREQS)))
    beams = [_gridded(10.0 + i) for i in range(5)]
    beam_idx = np.array([0] * (nant - 4) + [1, 2, 3, 4])
    kw = dict(
        ants=ants, fluxes=flux, ra=ra, dec=dec, freqs=FREQS,
        times=JD0 + np.linspace(0, 0.01, 2), telescope_loc=LOC,
        polarized=True, precision=2, beam=beams, beam_idx=beam_idx,
    )
    got = simulate_vis(backend="tpu", **kw)
    want = simulate_vis(backend="direct", **kw)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())

    # The skew condition must actually select the loop here.
    from fftvis_tpu.core.beams import plan_beam_pairs
    from fftvis_tpu.core.utils import get_pos_reds

    bls = [r[0] for r in get_pos_reds(ants, include_autos=True)]
    plan = plan_beam_pairs(list(ants.keys()), bls, beam_idx)
    nbl = sum(len(s) for s in plan.bls_idxs)
    m_max = max(len(s) for s in plan.bls_idxs)
    assert plan.npairs * m_max > 4 * nbl and plan.npairs <= 32


class TestFetchAndSweepBatching:
    """Freq-stacked sweep batching (one-dispatch one-D2H production
    sweeps; results must be exact)."""

    def _kw(self, rng, nfreq=2):
        ants = {i: np.array([*rng.uniform(-50, 50, 2), 0.0])
                for i in range(5)}
        nsrc = 36
        return dict(
            ants=ants,
            fluxes=rng.uniform(0.1, 1.0, (nsrc, nfreq)),
            ra=rng.uniform(0, 2 * np.pi, nsrc),
            dec=np.clip(LOC.lat + rng.normal(0, 0.3, nsrc),
                        -np.pi / 2, np.pi / 2),
            freqs=np.linspace(1.0e8, 1.1e8, nfreq),
            times=JD0 + np.linspace(0, 0.01, 2),
            beam=GaussianBeam(diameter=12.0),
            telescope_loc=LOC,
            polarized=False,
            precision=2,
        )

    def test_freq_stacked_sweep_equals_separate_sims(self):
        """A sweep batched by stacking per-sim flux columns on a tiled
        freq axis equals the separate per-sim calls (the engine treats
        each freq column independently; this is the one-dispatch
        one-D2H production sweep pattern the bench scores)."""
        rng = np.random.default_rng(6)
        kw = self._kw(rng)
        freqs = kw.pop("freqs")
        flux_a = kw.pop("fluxes")
        flux_b = rng.uniform(0.1, 1.0, flux_a.shape)
        va = simulate_vis(freqs=freqs, fluxes=flux_a, **kw)
        vb = simulate_vis(freqs=freqs, fluxes=flux_b, **kw)
        v = simulate_vis(
            freqs=np.concatenate([freqs, freqs]),
            fluxes=np.concatenate([flux_a, flux_b], axis=1),
            **kw,
        )
        scale = np.abs(va).max()
        np.testing.assert_allclose(v[: freqs.size], va, atol=1e-12 * scale)
        np.testing.assert_allclose(v[freqs.size:], vb, atol=1e-12 * scale)

    def test_freq_stacked_sweep_polarized_per_antenna(self):
        """The batched-sweep equivalence must survive the per-antenna
        routing machinery: polarized, distinct beams per antenna, flip
        bookkeeping -- any cross-talk between stacked freq columns in
        the pair routing or beam frequency interpolation would break
        this."""
        rng = np.random.default_rng(7)
        kw = self._kw(rng)
        kw["polarized"] = True
        ants = kw["ants"]
        beams = [_gridded(11.0 + 0.4 * i) for i in range(len(ants))]
        kw["beam"] = beams
        kw["beam_idx"] = np.arange(len(ants))
        freqs = kw.pop("freqs")
        flux_a = kw.pop("fluxes")
        flux_b = rng.uniform(0.1, 1.0, flux_a.shape)
        va = simulate_vis(freqs=freqs, fluxes=flux_a, **kw)
        vb = simulate_vis(freqs=freqs, fluxes=flux_b, **kw)
        v = simulate_vis(
            freqs=np.concatenate([freqs, freqs]),
            fluxes=np.concatenate([flux_a, flux_b], axis=1),
            **kw,
        )
        scale = np.abs(va).max()
        np.testing.assert_allclose(v[: freqs.size], va, atol=1e-11 * scale)
        np.testing.assert_allclose(v[freqs.size:], vb, atol=1e-11 * scale)

    def test_async_fetch_immune_to_flux_mutation_after_dispatch(self):
        """Inputs are consumed at DISPATCH: a caller that reuses its flux
        buffer for the next sweep step while a future is in flight must
        not corrupt the in-flight result (the coherency input is device-
        resident by the time the call returns)."""
        rng = np.random.default_rng(8)
        kw = self._kw(rng)
        flux = kw.pop("fluxes")
        want = simulate_vis(fluxes=flux.copy(), **kw)
        live = flux.copy()
        fut = simulate_vis(fluxes=live, async_fetch=True, **kw)
        live[:] = -999.0  # caller reuses the buffer for the next step
        got = fut.result()
        np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max())

    def test_many_futures_resolve_from_threads(self):
        """Several in-flight futures collected concurrently (the bench's
        pipelined pattern) must each resolve to the sync result."""
        from concurrent.futures import ThreadPoolExecutor

        rng = np.random.default_rng(9)
        kw = self._kw(rng)
        flux = kw.pop("fluxes")
        fluxes = [rng.uniform(0.1, 1.0, flux.shape) for _ in range(4)]
        want = [simulate_vis(fluxes=f, **kw) for f in fluxes]
        futs = [simulate_vis(fluxes=f, async_fetch=True, **kw)
                for f in fluxes]
        with ThreadPoolExecutor(2) as pool:
            got = list(pool.map(lambda f: f.result(), futs))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g)

    def test_same_future_resolved_from_two_threads(self):
        """result() must be idempotent under concurrent callers on the
        SAME future (the collector pattern makes that easy to do by
        accident): both threads get the identical array, not a
        double-assembled or half-released state."""
        from concurrent.futures import ThreadPoolExecutor

        rng = np.random.default_rng(10)
        kw = self._kw(rng)
        want = simulate_vis(**kw)
        fut = simulate_vis(async_fetch=True, **kw)
        with ThreadPoolExecutor(2) as pool:
            a, b = list(pool.map(lambda f: f.result(), [fut, fut]))
        assert a is b
        np.testing.assert_array_equal(a, want)
