"""Beam interface layer: wrapping, unpolarized preparation, device closures.

Plays the role of pyuvdata's BeamInterface plus matvis's
``prepare_beam_unpolarized`` in the reference stack (ref wrapper.py:6-8,
271-285), and adds the device-side step: compiling each beam into a pure
JAX evaluation closure (:func:`prepare_beams`) used inside the jitted
simulation program -- the replacement for per-chunk host-side
``compute_response`` calls (ref cpu/beams.py:62-74).
"""

from __future__ import annotations

import logging

import numpy as np

from ..core.hashing import cache_get_lru as _cache_get_lru
from .analytic import AnalyticBeam
from .gridded import GriddedBeam
from .interp import (
    map_coordinates_2d_cl,
    spline_prefilter_2d,
    upsample_prefiltered_2d,
)

logger = logging.getLogger(__name__)

_FEED_INDEX = {"x": 0, "y": 1}


class BeamInterface:
    """Thin wrapper unifying analytic beams, gridded beams, and (duck-typed)
    pyuvdata UVBeam objects."""

    def __init__(self, beam, beam_type: str | None = None):
        if isinstance(beam, BeamInterface):
            self.beam = beam.beam
        elif isinstance(beam, (AnalyticBeam, GriddedBeam, PowerBeam)):
            self.beam = beam
        elif hasattr(beam, "data_array") and hasattr(beam, "axis1_array"):
            self.beam = GriddedBeam.from_uvbeam(beam)
        else:
            raise TypeError(f"Unsupported beam object: {type(beam)}")
        self.beam_type = beam_type or getattr(self.beam, "beam_type", "efield")

    @property
    def _isuvbeam(self) -> bool:
        """True when the underlying beam is tabulated (UVBeam-like)."""
        return isinstance(self.beam, GriddedBeam)

    def compute_response(
        self,
        az_array,
        za_array,
        freq_array,
        spline_opts: dict | None = None,
        interpolation_function: str = "az_za_map_coordinates",
        **kwargs,
    ) -> np.ndarray:
        """Host-side response evaluation with the UVBeam output layout.

        Returns (Naxes_vec, Nfeeds, Nfreqs, Nsrc) for efield beams and
        (1, Npols, Nfreqs, Nsrc) for power beams -- matching the slicing the
        reference applies at cpu/beams.py:76-81.
        """
        import jax

        freq_array = np.atleast_1d(np.asarray(freq_array, dtype=float))
        # Host-facing evaluation: pin to the CPU device (complex arrays
        # cannot be fetched from some accelerator runtimes).
        with jax.default_device(jax.devices("cpu")[0]):
            prepared = prepare_beam(
                self,
                freqs=freq_array,
                polarized=(self.beam_type == "efield"),
                spline_opts=spline_opts,
                interpolation_function=interpolation_function,
            )
            out = []
            for fi, f in enumerate(freq_array):
                resp = np.asarray(prepared.evaluate(az_array, za_array, f, fi))
                out.append(resp)
        out = np.stack(out, axis=0)  # (nfreq, ..., nsrc)
        if self.beam_type == "efield":
            return np.moveaxis(out, 0, 2)  # (2, 2, nfreq, nsrc)
        return np.moveaxis(out, 0, 0)[None, None]  # (1, 1, nfreq, nsrc)


class PowerBeam:
    """A single-feed power beam derived from any beam (matvis's
    prepare_beam_unpolarized equivalent; ref wrapper.py:278-279)."""

    beam_type = "power"

    def __init__(self, base, use_feed: str = "x"):
        if isinstance(base, BeamInterface):
            base = base.beam
        if isinstance(base, PowerBeam):
            # Already a power beam of a specific feed -- it has no other
            # feed to offer, so keep its selection and unwrap (re-wrapping
            # a pre-converted beam through simulate_vis must be a no-op).
            use_feed = base.use_feed
            base = base.base
        self.use_feed = use_feed
        if isinstance(base, GriddedBeam):
            self.base = base.as_power_beam()
        else:
            self.base = base  # analytic: power computed on the fly

    @property
    def data_array(self):
        return getattr(self.base, "data_array", None)

    def power(self, az, za, freq):
        if isinstance(self.base, GriddedBeam):
            raise RuntimeError("Gridded power beams evaluate via prepare_beam().")
        return self.base.power(az, za, freq, feed=self.use_feed)


def prepare_beam_unpolarized(beam, use_feed: str = "x") -> BeamInterface:
    """Convert any beam to an unpolarized power beam wrapped in an interface."""
    bi = beam if isinstance(beam, BeamInterface) else BeamInterface(beam)
    return BeamInterface(PowerBeam(bi.beam, use_feed=use_feed), beam_type="power")


# ---------------------------------------------------------------------------
# Device-side prepared beams
# ---------------------------------------------------------------------------


class PreparedBeam:
    """A beam compiled to a pure-JAX evaluation closure.

    ``evaluate(az, za, freq_value, freq_index)`` returns
      - polarized: (2, 2, nsrc) complex Jones (vec, feed) response;
      - unpolarized: (nsrc,) real power response.
    ``freq_index`` indexes the simulation frequency axis (gridded beams are
    pre-interpolated onto it); ``freq_value`` feeds analytic beams. Both may
    be traced values inside jit.
    """

    def __init__(self, evaluate_fn, polarized: bool, nbeampix: int = 0):
        self._fn = evaluate_fn
        self.polarized = polarized
        self.nbeampix = nbeampix

    def evaluate(self, az, za, freq_value, freq_index):
        return self._fn(az, za, freq_value, freq_index)


_PREPARED_CACHE: dict = {}
# LRU capacity. Must exceed the number of DISTINCT beams in one simulate()
# call or every call thrashes the whole cache and re-runs freq interp +
# spline prefiltering for every beam (measured: the 37-beam north-star row
# spent ~90 ms/call rebuilding beams against the old 32-slot FIFO).
# prepare_beams() grows it to fit the largest beam list seen (2x margin,
# capped); entries hold ~0.1-2 MB host tables each.
_PREPARED_CACHE_LIMIT = 64
_PREPARED_CACHE_MAX_LIMIT = 1024


def prepare_beam(
    beam,
    freqs: np.ndarray,
    polarized: bool,
    spline_opts: dict | None = None,
    interpolation_function: str = "az_za_map_coordinates",
    use_feed: str = "x",
) -> PreparedBeam:
    """Compile one beam into a :class:`PreparedBeam` for the given sim freqs.

    Results are content-cached: frequency interpolation and (order-3) spline
    prefiltering of large tabulated beams are pure functions of the inputs
    and would otherwise repeat on every simulate() call of a sweep.
    """
    from ..core.hashing import beam_fingerprint, hash_parts

    import os

    cache_key = hash_parts(
        (
            beam_fingerprint(beam),
            np.asarray(freqs, dtype=float),
            bool(polarized),
            repr(spline_opts),
            interpolation_function,
            use_feed,
            # Domain handling is decided at prepare time; the opt-in clamp
            # flag changes whether a short-za beam raises, so it keys here.
            os.environ.get("FFTVIS_ALLOW_BEAM_CLAMP", ""),
            # The opt-in table-upsample knob changes the shipped table and
            # the device interpolation order.
            os.environ.get("FFTVIS_BEAM_UPSAMPLE", ""),
        )
    )
    hit = _cache_get_lru(_PREPARED_CACHE, cache_key)
    if hit is not None:
        return hit
    prepared = _prepare_beam_uncached(
        beam, freqs, polarized, spline_opts, interpolation_function, use_feed
    )
    while len(_PREPARED_CACHE) >= _PREPARED_CACHE_LIMIT:
        _PREPARED_CACHE.pop(next(iter(_PREPARED_CACHE)))
    _PREPARED_CACHE[cache_key] = prepared
    return prepared


def _prepare_beam_uncached(
    beam,
    freqs: np.ndarray,
    polarized: bool,
    spline_opts: dict | None = None,
    interpolation_function: str = "az_za_map_coordinates",
    use_feed: str = "x",
) -> PreparedBeam:
    import jax.numpy as jnp

    bi = beam if isinstance(beam, BeamInterface) else BeamInterface(beam)
    inner = bi.beam
    spline_opts = dict(spline_opts or {})
    # pyuvdata spells the spline order 'order' for az_za_map_coordinates and
    # 'kx'/'ky' for az_za_simple (RectBivariateSpline); honor both.
    if "kx" in spline_opts or "ky" in spline_opts:
        kx = int(spline_opts.get("kx", spline_opts.get("ky", 3)))
        ky = int(spline_opts.get("ky", kx))
        if kx != ky:
            raise ValueError(
                f"anisotropic spline orders are not supported (kx={kx}, ky={ky})"
            )
        spline_opts.setdefault("order", kx)
    known = {"order", "kx", "ky"}
    unknown = set(spline_opts) - known
    if unknown:
        logger.info(
            "ignoring unsupported beam_spline_opts keys: %s", sorted(unknown)
        )
    order = int(spline_opts.get("order", 1))
    if interpolation_function == "az_za_simple":
        # The 'simple' backend is a cubic spline in the reference (pyuvdata
        # RectBivariateSpline, not-a-knot boundaries); here both names map
        # onto the same gather kernels (order-3 prefiltered B-spline,
        # mirror boundaries). The two interpolants deviate only through
        # their end conditions: bounded at < 1e-4 of the beam peak for
        # interior points on a realistic grid
        # (tests/test_beams.py::test_az_za_simple_vs_rect_bivariate_spline_bound).
        order = int(spline_opts.get("order", 3))
    elif interpolation_function != "az_za_map_coordinates":
        raise ValueError(
            "interpolation_function must be 'az_za_simple' or 'az_za_map_coordinates'"
        )
    if order not in (1, 3):
        raise ValueError(f"spline order must be 1 or 3, got {order}")

    if isinstance(inner, PowerBeam) and not isinstance(inner.base, GriddedBeam):
        if polarized:
            raise ValueError("Power beams cannot be evaluated polarized.")
        base = inner.base
        feed = inner.use_feed

        def eval_power(az, za, fv, fi):
            return base.power(az, za, fv, feed=feed)

        return PreparedBeam(eval_power, polarized=False)

    if isinstance(inner, AnalyticBeam):
        if polarized:
            def eval_ef(az, za, fv, fi):
                return inner.efield(az, za, fv)

            return PreparedBeam(eval_ef, polarized=True)

        def eval_pw(az, za, fv, fi):
            return inner.power(az, za, fv, feed=use_feed)

        return PreparedBeam(eval_pw, polarized=False)

    # Gridded beams (including PowerBeam wrapping a gridded base).
    gb = inner.base if isinstance(inner, PowerBeam) else inner
    if not isinstance(gb, GriddedBeam):
        raise TypeError(f"Cannot prepare beam of type {type(inner)}")
    if polarized and gb.beam_type != "efield":
        raise ValueError("polarized=True requires an efield beam")
    if not polarized and gb.beam_type == "efield":
        gb = gb.as_power_beam()

    gb = gb.interp_freq(np.asarray(freqs, dtype=float))
    # check_azza_domain equivalent (pyuvdata's UVBeam domain check, which
    # the reference exposes via compute_response at ref cpu/beams.py:62-74):
    # the hot path cannot host-validate traced coordinates, but any
    # above-horizon source can reach za = pi/2, so a beam grid ending short
    # of that WILL be evaluated out of domain. Silent edge-row clamping on
    # a partial-sky beam file produces plausible-but-wrong visibilities, so
    # this raises at prepare time (the grid and the horizon are both
    # static); set FFTVIS_ALLOW_BEAM_CLAMP=1 to opt in to clamping.
    import os

    za_end = float(gb.axis2_array[-1])
    if za_end < np.pi / 2 - 1e-9:
        if os.environ.get("FFTVIS_ALLOW_BEAM_CLAMP") == "1":
            logger.warning(
                "beam za grid ends at %.4f rad < pi/2: above-horizon "
                "sources beyond it clamp to the edge row "
                "(FFTVIS_ALLOW_BEAM_CLAMP=1)",
                za_end,
            )
        else:
            raise ValueError(
                f"beam za grid ends at {za_end:.4f} rad < pi/2: "
                "above-horizon sources can fall outside the beam domain "
                "(check_azza_domain). Extend the beam grid to the horizon, "
                "or set FFTVIS_ALLOW_BEAM_CLAMP=1 to clamp to the edge row."
            )
    # Ship complex beam tables as a stacked (re, im) real array:
    # interpolation distributes over re/im, so the gather stays real.
    host = gb.data_array
    is_complex = np.iscomplexobj(host)
    wrap = gb.az_wraps
    if is_complex:
        host = np.stack([host.real, host.imag])
    if order == 3:
        # Prefilter once at prepare time, on the host CPU device: the table
        # stays a NumPy closure constant (embedded into the program at trace
        # time with no device round-trip).
        import jax

        with jax.default_device(jax.devices("cpu")[0]):
            host = np.asarray(
                spline_prefilter_2d(jnp.asarray(host), periodic_x=wrap)
            )
    az0 = float(gb.axis1_array[0])
    daz = float(gb.axis1_array[1] - gb.axis1_array[0]) if gb.axis1_array.size > 1 else 1.0
    za0 = float(gb.axis2_array[0])
    dza = float(gb.axis2_array[1] - gb.axis2_array[0]) if gb.axis2_array.size > 1 else 1.0
    # Opt-in accuracy/speed trade (FFTVIS_BEAM_UPSAMPLE=N, N>=2): resample
    # the cubic spline onto an Nx-denser grid ONCE on the host, then run
    # 4-tap order-1 interpolation on device instead of 16-tap order-3. The
    # device kernel is gather-bound, so taps ~ time; accuracy degrades from
    # the cubic's O(h^4) to bilinear-on-refined O((h/N)^2) -- exact at the
    # refined nodes. Documented semantic change; off by default.
    ups = int(os.environ.get("FFTVIS_BEAM_UPSAMPLE", "0") or "0")
    if order == 3 and ups >= 2 and host.shape[-1] > 1 and host.shape[-2] > 1:
        host = upsample_prefiltered_2d(host, ups, wrap_x=wrap)
        order = 1
        daz /= ups
        dza /= ups
        logger.info(
            "FFTVIS_BEAM_UPSAMPLE=%d: beam table resampled to %dx%d, "
            "device interpolation order 3 -> 1", ups,
            host.shape[-2], host.shape[-1],
        )
    # Relayout to channels-LAST (nfreq, ny, nx, chflat), chflat = the
    # flattened ([2 reim,] nvec, nfeed) response axes: each interpolation
    # tap then fetches one contiguous ch-vector instead of ch elements
    # strided ny*nx apart (see map_coordinates_2d_cl).
    freq_axis = 3 if is_complex else 2
    ch_shape = host.shape[:freq_axis]
    host = np.moveaxis(host, freq_axis, 0)  # (nfreq, *ch_shape, ny, nx)
    nfreq_t, ny_t, nx_t = host.shape[0], host.shape[-2], host.shape[-1]
    host = host.reshape(nfreq_t, -1, ny_t, nx_t)
    data = np.ascontiguousarray(np.moveaxis(host, 1, -1))
    # Freeze: lets the digest memo skip per-call content revalidation
    # (immutable-owner fast path in core/hashing.py).
    data.setflags(write=False)
    nbeampix = ny_t * nx_t
    is_power = gb.beam_type == "power"
    # The requested feed: a PowerBeam wrapper carries its own selection
    # (the engine calls prepare without use_feed, so reading the argument
    # here would silently evaluate the x feed for use_feed='y' sims).
    want_feed = inner.use_feed if isinstance(inner, PowerBeam) else use_feed
    labels = getattr(gb, "feeds", None)
    if labels and want_feed in labels:
        feed_idx = labels.index(want_feed)
    elif labels and is_power:
        raise ValueError(
            f"requested feed {want_feed!r} is not present in this beam "
            f"(feeds: {labels})"
        )
    else:
        feed_idx = _FEED_INDEX[want_feed]

    def eval_grid(az, za, fv, fi):
        dslice = jnp.take(jnp.asarray(data), fi, axis=0)  # (ny, nx, chflat)
        yy = (za - za0) / dza
        if wrap:
            xx = jnp.mod(az - az0, 2 * jnp.pi) / daz
        else:
            xx = (az - az0) / daz
        vals = map_coordinates_2d_cl(
            dslice, yy, xx, order=order, wrap_x=wrap
        )  # (nsrc, chflat)
        vals = jnp.moveaxis(vals, 0, -1).reshape(ch_shape + (vals.shape[0],))
        if is_complex:
            vals = vals[0] + 1j * vals[1]
        if is_power:
            pol = min(feed_idx, vals.shape[1] - 1)
            return jnp.real(vals[0, pol])
        return vals

    pb = PreparedBeam(eval_grid, polarized=not is_power, nbeampix=nbeampix)
    # Grid geometry fingerprint + host table so stack_prepared() can fuse
    # same-grid beam lists (eigenbeam bases, per-antenna CST sweeps) into a
    # single batched interpolation.
    pb.stack_spec = (
        tuple(data.shape), az0, daz, za0, dza, bool(wrap), order,
        bool(is_complex), bool(is_power), feed_idx, ch_shape,
    )
    pb.stack_table = data
    return pb


class BatchedPreparedBeams:
    """K same-grid tabulated beams fused into one evaluation closure.

    ``evaluate_all(az, za, freq_value, freq_index, table=None)`` returns
      - polarized: (K, 2, 2, nsrc) complex Jones responses;
      - unpolarized: (K, nsrc) real power responses.

    ``table`` (host copy at ``.table``) may be passed as a traced program
    INPUT: large tables embedded as jit closure constants dominate the HLO
    size and with it the compile time.
    """

    def __init__(self, evaluate_fn, polarized: bool, nbeams: int, table):
        self._fn = evaluate_fn
        self.polarized = polarized
        self.nbeams = nbeams
        self.table = table

    def evaluate_all(self, az, za, freq_value, freq_index, table=None):
        return self._fn(az, za, freq_value, freq_index, table)


_STACK_CACHE: dict = {}
_STACK_CACHE_LIMIT = 8


def stack_prepared(prepared_list) -> BatchedPreparedBeams | None:
    """Fuse compatible gridded :class:`PreparedBeam` s into a batched one.

    Evaluating K tabulated beams sharing one (az, za) grid as a single
    map_coordinates call over a stacked (K, ...) table replaces K gather
    programs per source block with one -- the dominant dispatch cost of the
    eigenbeam basis path (K ~ 8-37 beams, each needed at every block; ref
    docs/beam_decomposition.ipynb). Returns None when the list is shorter
    than 2 or the beams do not share grid geometry / spline order / type
    (the engine then falls back to per-beam evaluation).
    """
    import jax.numpy as jnp

    if len(prepared_list) < 2:
        return None
    specs = [getattr(pb, "stack_spec", None) for pb in prepared_list]
    if any(s is None for s in specs) or len(set(specs)) != 1:
        return None
    (_, az0, daz, za0, dza, wrap, order, is_complex, is_power, feed_idx,
     ch_shape) = specs[0]
    # Cache the stacked result: a fresh np.stack every simulate() call
    # would copy the tables AND defeat the identity-memoized digests the
    # engine's input cache relies on.
    from ..core.hashing import hash_parts

    cache_key = hash_parts(
        (specs[0], tuple(pb.stack_table for pb in prepared_list))
    )
    hit = _cache_get_lru(_STACK_CACHE, cache_key)
    if hit is not None:
        return hit
    K = len(prepared_list)
    # Per-beam tables are channels-last (nfreq, ny, nx, chflat); fuse the
    # beam axis INTO the channel axis so one flat gather serves all K.
    stacked = np.ascontiguousarray(
        np.stack([pb.stack_table for pb in prepared_list], axis=3)
    )  # (nfreq, ny, nx, K, chflat)
    # Freeze owner BEFORE taking the reshape view so the digest memo's
    # immutable-owner fast path applies to the view too.
    stacked.setflags(write=False)
    nfreq_t, ny_t, nx_t = stacked.shape[:3]
    table = stacked.reshape(nfreq_t, ny_t, nx_t, -1)

    def evaluate_all(az, za, fv, fi, table_in=None):
        tab = jnp.asarray(table) if table_in is None else table_in
        dslice = jnp.take(tab, fi, axis=0)  # (ny, nx, K*chflat)
        yy = (za - za0) / dza
        if wrap:
            xx = jnp.mod(az - az0, 2 * jnp.pi) / daz
        else:
            xx = (az - az0) / daz
        vals = map_coordinates_2d_cl(
            dslice, yy, xx, order=order, wrap_x=wrap
        )  # (nsrc, K*chflat)
        vals = jnp.moveaxis(vals, 0, -1).reshape(
            (K,) + ch_shape + (vals.shape[0],)
        )  # (K, [2,] nvec, nfeed, nsrc)
        if is_complex:
            vals = vals[:, 0] + 1j * vals[:, 1]
        if is_power:
            pol = min(feed_idx, vals.shape[2] - 1)
            return jnp.real(vals[:, 0, pol])
        return vals

    out = BatchedPreparedBeams(
        evaluate_all, polarized=not is_power, nbeams=len(prepared_list),
        table=table,
    )
    if len(_STACK_CACHE) >= _STACK_CACHE_LIMIT:
        _STACK_CACHE.pop(next(iter(_STACK_CACHE)))
    _STACK_CACHE[cache_key] = out
    return out


def prepare_beams(beam_list, freqs, polarized, spline_opts=None,
                  interpolation_function="az_za_map_coordinates", use_feed="x"):
    """Prepare every beam in a list (engine entry point)."""
    global _PREPARED_CACHE_LIMIT
    # Per-antenna-beam sims pass O(nants) distinct beams per call; the LRU
    # must hold the whole working set or steady-state calls rebuild every
    # beam. Grow (never shrink) to 2x the largest list seen, capped.
    want = min(2 * len(beam_list), _PREPARED_CACHE_MAX_LIMIT)
    if want > _PREPARED_CACHE_LIMIT:
        _PREPARED_CACHE_LIMIT = want
    return [
        prepare_beam(
            b,
            freqs=freqs,
            polarized=polarized,
            spline_opts=spline_opts,
            interpolation_function=interpolation_function,
            use_feed=use_feed,
        )
        for b in beam_list
    ]
