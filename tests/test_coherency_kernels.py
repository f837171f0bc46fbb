"""Coherency kernels vs explicit einsum formulas, and input-cache safety.

The reference validates each of its four Numba coherency kernels against an
explicit np.einsum specification (ref tests/test_cpu_beams.py:99-109,
861-875). The JAX engine computes the same algebra as broadcast
multiply-adds (a dot_general with size-2 contractions would need layout
copies); these tests pin the math to the einsum formulas independently of
that implementation choice.

The second half guards the identity-memoized digest cache
(core/hashing.py): content keys MUST track in-place mutation, or the
engine's device-input cache would silently serve stale catalogs.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from fftvis_tpu import TelescopeLocation, simulate_vis
from fftvis_tpu.beams import GaussianBeam
from fftvis_tpu.core import coherency as coh
from fftvis_tpu.core.hashing import hash_parts

LOC = TelescopeLocation(np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)


def _jones(rng, nsrc):
    return rng.normal(size=(2, 2, nsrc)) + 1j * rng.normal(size=(2, 2, nsrc))


class TestKernelFormulas:
    """apparent_coherency_rows == the reference's einsum specifications."""

    nsrc = 37

    def test_unpolarized_kernel(self):
        """Unpolarized: rows = sqrt(b_i b_j) * flux (ref cpu/beams.py:129-154)."""
        rng = np.random.default_rng(0)
        bi = rng.uniform(0.1, 1.0, self.nsrc)
        bj = rng.uniform(0.1, 1.0, self.nsrc)
        flux = rng.uniform(0.1, 1.0, self.nsrc)
        out = np.asarray(
            coh.apparent_coherency_rows(
                jnp.asarray(bi), jnp.asarray(bj), jnp.asarray(flux), False, False
            )
        )
        assert out.shape == (1, self.nsrc)
        np.testing.assert_allclose(out[0], np.sqrt(bi * bj) * flux, atol=1e-15)

    def test_polarized_beam_unpolarized_sky(self):
        """rows = einsum('afs,ags,s->fgs', conj(A_i), A_j, I) in row order
        (f1, f2) = 00, 01, 10, 11 (ref cpu/beams.py:157-186)."""
        rng = np.random.default_rng(1)
        ei, ej = _jones(rng, self.nsrc), _jones(rng, self.nsrc)
        flux = rng.uniform(0.1, 1.0, self.nsrc)
        out = np.asarray(
            coh.apparent_coherency_rows(
                jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(flux), True, False
            )
        )
        want = np.einsum("afs,ags,s->fgs", ei.conj(), ej, flux)
        assert out.shape == (4, self.nsrc)
        np.testing.assert_allclose(out, want.reshape(4, self.nsrc), atol=1e-13)

    def test_polarized_beam_polarized_sky(self):
        """rows = einsum('afs,abs,bgs->fgs', conj(flip(A_i)), C, flip(A_j))
        with the reference's vector-component flip (ref cpu_simulate.py:
        138-156)."""
        rng = np.random.default_rng(2)
        ei, ej = _jones(rng, self.nsrc), _jones(rng, self.nsrc)
        C = rng.normal(size=(self.nsrc, 2, 2)) + 1j * rng.normal(
            size=(self.nsrc, 2, 2)
        )
        out = np.asarray(
            coh.apparent_coherency_rows(
                jnp.asarray(ei), jnp.asarray(ej), jnp.asarray(C), True, True
            )
        )
        ai, aj = ei[::-1], ej[::-1]
        want = np.einsum(
            "afs,abs,bgs->fgs", ai.conj(), np.moveaxis(C, 0, -1), aj
        )
        np.testing.assert_allclose(out, want.reshape(4, self.nsrc), atol=1e-13)

    def test_autopair_is_hermitian(self):
        """Same-beam rows form a Hermitian 2x2 coherency at every source."""
        rng = np.random.default_rng(3)
        e = _jones(rng, self.nsrc)
        flux = rng.uniform(0.1, 1.0, self.nsrc)
        out = np.asarray(
            coh.apparent_coherency_rows(
                jnp.asarray(e), jnp.asarray(e), jnp.asarray(flux), True, False
            )
        ).reshape(2, 2, self.nsrc)
        np.testing.assert_allclose(
            out, np.conj(np.swapaxes(out, 0, 1)), atol=1e-13
        )
        assert np.all(out[0, 0].real >= 0) and np.all(out[1, 1].real >= 0)

    def test_stokes_to_coherency_matrix(self):
        """IQUV -> 0.5 [[I+Q, U+iV], [U-iV, I-Q]] (ref cpu/utils.py:26-81)."""
        rng = np.random.default_rng(4)
        sky = rng.normal(size=(5, 3, 4))
        C = coh.build_coherency(sky, True)
        I, Q, U, V = (sky[..., i] for i in range(4))
        np.testing.assert_allclose(C[..., 0, 0], 0.5 * (I + Q), atol=1e-15)
        np.testing.assert_allclose(C[..., 0, 1], 0.5 * (U + 1j * V), atol=1e-15)
        np.testing.assert_allclose(C[..., 1, 0], 0.5 * (U - 1j * V), atol=1e-15)
        np.testing.assert_allclose(C[..., 1, 1], 0.5 * (I - Q), atol=1e-15)
        # Unpolarized Stokes-I halves the flux.
        flux = rng.uniform(0.1, 1.0, (5, 3))
        np.testing.assert_allclose(coh.build_coherency(flux, False), 0.5 * flux)

    def test_classify_sky_error_contracts(self):
        """Validation error text matches the reference (its tests assert
        on the message; ref tests/test_cpu_simulate.py:588-700)."""
        with pytest.raises(ValueError, match="polarized_beam=True requires"):
            coh.classify_sky(np.ones((3, 2, 3)), polarized_beam=True)
        with pytest.raises(ValueError, match="polarized_beam=False requires"):
            coh.classify_sky(np.ones((3, 2, 4)), polarized_beam=False)
        assert coh.classify_sky(np.ones((3, 2)), polarized_beam=True) is False
        assert coh.classify_sky(np.ones((3, 2, 4)), polarized_beam=True) is True


class TestDigestMemo:
    """hash_parts must track content even with the identity memo active."""

    def _big(self, seed=0):
        # Above the memo threshold (256 KB).
        return np.random.default_rng(seed).normal(size=(300, 300))

    def test_repeat_hash_is_stable(self):
        a = self._big()
        assert hash_parts(a) == hash_parts(a)

    def test_equal_content_different_objects_agree(self):
        a = self._big()
        assert hash_parts(a) == hash_parts(a.copy())

    def test_inplace_mutation_changes_key(self):
        a = self._big()
        k0 = hash_parts(a)
        assert hash_parts(a) == k0  # memo primed
        orig = float(a[17, 23])
        a[17, 23] = orig + 1.0
        assert hash_parts(a) != k0
        a[17, 23] = orig  # exact restore (float, bit-identical)
        assert hash_parts(a) == k0

    def test_view_and_noncontiguous(self):
        a = self._big()
        assert hash_parts(a[::2]) == hash_parts(a[::2].copy())
        assert hash_parts(a[::2]) != hash_parts(a[1::2])

    def test_dead_id_reuse_is_safe(self):
        """A new array reusing a dead array's id must not inherit its
        digest (the weakref guard)."""
        keys = set()
        for seed in range(8):
            a = self._big(seed)
            keys.add(hash_parts(a))
            del a  # frees id for possible reuse by the next iteration
        assert len(keys) == 8

    def test_shape_dtype_in_key(self):
        a = self._big()
        assert hash_parts(a) != hash_parts(a.reshape(300 * 300))
        assert hash_parts(np.float32(1.0)) != hash_parts(np.float64(1.0))

    def test_odd_count_non8byte_dtype(self):
        """nbytes not a multiple of 8 (odd-count float32): the content
        check must slice the 8-byte-aligned prefix in BYTES, not dtype
        items (an item slice of such a view raised in frombuffer)."""
        a = np.random.default_rng(3).normal(size=32769).astype(np.float32)
        assert a.nbytes % 8 != 0 and a.nbytes >= (1 << 16)
        k0 = hash_parts(a)
        assert hash_parts(a) == k0  # memo revalidation path
        a[-1] += 1.0  # mutate inside the CRC-only tail's 8-byte word
        assert hash_parts(a) != k0


class TestInputCacheFreshness:
    """End-to-end: the engine's device-input cache must not serve a stale
    catalog after in-place flux mutation (the cache keys on raw arrays)."""

    def test_inplace_flux_mutation_changes_result(self):
        rng = np.random.default_rng(5)
        ants = {i: np.array([*rng.uniform(-30, 30, 2), 0.0]) for i in range(3)}
        ra = rng.uniform(0, 2 * np.pi, 20)
        dec = np.clip(LOC.lat + rng.normal(0, 0.3, 20), -np.pi / 2, np.pi / 2)
        flux = rng.uniform(0.1, 1.0, (20, 2))
        kw = dict(
            ants=ants, fluxes=flux, ra=ra, dec=dec,
            freqs=np.array([1.0e8, 1.1e8]),
            times=2459863.2 + np.linspace(0, 0.01, 2),
            beam=GaussianBeam(diameter=12.0), telescope_loc=LOC,
            polarized=False, precision=2,
        )
        v1 = simulate_vis(**kw)
        v1b = simulate_vis(**kw)  # cache hit: identical
        np.testing.assert_array_equal(v1, v1b)
        flux *= 2.0  # in-place: same object, new content
        v2 = simulate_vis(**kw)
        np.testing.assert_allclose(v2, 2.0 * v1, rtol=1e-12)


def test_immutable_owner_fast_path():
    """Frozen owner arrays skip content revalidation but still digest
    correctly: same content agrees across objects, and the skip only
    engages when NO alias can write the buffer."""
    from fftvis_tpu.core.hashing import _DIGEST_MEMO, _immutable_owner

    rng3 = np.random.default_rng(3)
    a = rng3.normal(size=(300, 300))
    a.setflags(write=False)
    assert _immutable_owner(a)
    k0 = hash_parts(a)
    assert hash_parts(a) == k0
    assert _DIGEST_MEMO[id(a)][1] is None  # stored as frozen
    assert hash_parts(a.copy()) == k0  # content-equal writable agrees

    # A view of a frozen owner inherits the fast path ...
    v = a.reshape(300, 300)
    assert _immutable_owner(v)
    # ... but a non-writeable VIEW of a WRITABLE base must not (the
    # base can still mutate the shared buffer).
    b = np.random.default_rng(4).normal(size=(300, 300))
    w = b.reshape(300, 300)
    w.setflags(write=False)
    assert not _immutable_owner(w)
    kw = hash_parts(w)
    assert hash_parts(w) == kw
    b[0, 0] += 1.0
    assert hash_parts(w) != kw  # mutation through the base is tracked


class TestPlanCacheFreshness:
    """End-to-end freshness of the round-3 planning caches: the digest
    memo path for >=256KB user arrays, the redundancy-grouping cache, and
    the culled-SourceRotation cache must all track input changes."""

    def _kw(self, rng, nsrc=18000):
        # nsrc chosen so flux (nsrc, 2) f64 ~ 288 KB: ABOVE the digest
        # memo threshold (the small-flux test never exercises the memo).
        ants = {i: np.array([*rng.uniform(-30, 30, 2), 0.0]) for i in range(3)}
        ra = rng.uniform(0, 2 * np.pi, nsrc)
        dec = np.clip(LOC.lat + rng.normal(0, 0.3, nsrc), -np.pi / 2, np.pi / 2)
        flux = rng.uniform(0.1, 1.0, (nsrc, 2))
        return dict(
            ants=ants, fluxes=flux, ra=ra, dec=dec,
            freqs=np.array([1.0e8, 1.1e8]),
            times=2459863.2 + np.linspace(0, 0.01, 2),
            beam=GaussianBeam(diameter=12.0), telescope_loc=LOC,
            polarized=False, precision=2,
        )

    def test_big_flux_inplace_mutation_tracked(self):
        rng = np.random.default_rng(6)
        kw = self._kw(rng)
        v1 = simulate_vis(**kw)
        np.testing.assert_array_equal(v1, simulate_vis(**kw))
        kw["fluxes"] *= 2.0  # in-place, same object: memo must revalidate
        v2 = simulate_vis(**kw)
        np.testing.assert_allclose(v2, 2.0 * v1, rtol=1e-10)

    def test_antenna_move_recomputes_baselines(self):
        rng = np.random.default_rng(7)
        kw = self._kw(rng, nsrc=500)
        v1 = simulate_vis(**kw)
        ants2 = dict(kw["ants"])
        ants2[2] = ants2[2] + np.array([40.0, 0.0, 0.0])  # new layout
        kw2 = dict(kw, ants=ants2)
        v2 = simulate_vis(**kw2)
        assert v1.shape == v2.shape  # 3 ants -> same auto+red structure
        assert not np.allclose(v2, v1)  # but different baselines/values

    def test_time_change_recomputes_rotation(self):
        rng = np.random.default_rng(8)
        kw = self._kw(rng, nsrc=500)
        v1 = simulate_vis(**kw)
        kw2 = dict(kw, times=kw["times"] + 0.25)  # 6 hours later
        v2 = simulate_vis(**kw2)
        assert not np.allclose(v2, v1)


class TestBeamCacheWorkingSet:
    """The prepared-beam LRU must hold a whole per-antenna beam list.

    Regression: with a 32-slot FIFO, a 37-distinct-beam simulate() call
    (the north-star configuration) evicted every entry every call --
    steady-state sweeps re-ran frequency interpolation and spline
    prefiltering for all beams (~90 ms/call measured on the bench host).
    The cache is now LRU and prepare_beams() grows its capacity to fit the
    largest beam list seen.
    """

    def test_large_beam_list_hits_cache_on_second_call(self, monkeypatch):
        from fftvis_tpu.beams import interface as bi
        from fftvis_tpu.beams.gridded import GriddedBeam

        nbeams = bi._PREPARED_CACHE_LIMIT + 5  # exceeds the static limit
        beams = [
            GriddedBeam.from_function(
                GaussianBeam(diameter=12.0 + 0.01 * i),
                n_az=31, n_za=16, freqs=(1.0e8,),
            )
            for i in range(nbeams)
        ]
        misses = []
        orig = bi._prepare_beam_uncached

        def counting(*a, **k):
            misses.append(1)
            return orig(*a, **k)

        monkeypatch.setattr(bi, "_prepare_beam_uncached", counting)
        freqs = np.array([1.0e8])
        kw = dict(
            freqs=freqs, polarized=True, spline_opts=None,
            interpolation_function="az_za_map_coordinates", use_feed="x",
        )
        bi.prepare_beams(beams, **kw)
        first = len(misses)
        assert first == nbeams  # cold: every beam prepared once
        bi.prepare_beams(beams, **kw)
        assert len(misses) == first  # steady: zero rebuilds


def test_batched_rows_empty_pair_list():
    """An empty pair list returns an empty (0, nsrc) result (the
    unrolled slice-stack path must not try to stack zero arrays)."""
    import numpy as np

    from fftvis_tpu.core import coherency as coh

    rng = np.random.default_rng(3)
    evals = rng.uniform(0.1, 1.0, (3, 16))
    out = coh.apparent_coherency_rows_batched(
        evals, np.array([], dtype=int), np.array([], dtype=int),
        rng.uniform(0.1, 1.0, 16), False, False,
    )
    assert out.shape == (0, 16)
