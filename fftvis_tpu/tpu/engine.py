"""The JAX simulation engine: one jitted tensor program per simulation.

Structural inversion of the reference's CPU engine (ref /root/reference/src/
fftvis/cpu/cpu_simulate.py:534-1071). The reference nests Python loops
(time -> source chunk -> freq -> beam pair) around serial finufft calls; here
the whole simulation is a single XLA program:

    lax.scan over times
      lax.scan over freqs
        lax.scan over source blocks        (static-shape memory control,
                                            replacing coord_mgr.select_chunk
                                            dynamic compaction, ref :939-945)
          batched rotation (matmul)        (replaces ERFA loop + Numba
                                            inplace_rot, ref :937, :961-965)
          beam evaluation (XLA gather)     (replaces pyuvdata interp, ref :975)
          coherency einsum                 (replaces 4 Numba kernels,
                                            ref cpu/beams.py:129-246)
          NUFFT spread accumulation        (replaces finufft, ref :1051)
        FFT + deconvolve + interpolate     (one batched transform for ALL
                                            beam pairs, ref loops at :1030)

Horizon handling is two-stage: sources that never rise during the
simulated times are dropped on the host before planning
(rot.cull_never_visible; ~half of a full-sky catalog for short
observations), and the rest carry a per-time weight mask (below-horizon
contributions are exact zeros) so every shape stays static under jit.

Three transform paths, chosen per simulation by a FLOP model:
  - "type1":  gridded arrays; ES-spread + FFT + mode gather,
  - "type3":  general arrays; ES-spread + FFT + ES-interpolation
              (3D non-coplanar via the low-rank Chebyshev z
              factorization),
  - "direct": exact blocked dense DFT as matmuls -- for small
              (nsrc x nbl) this beats any NUFFT and is error-free; an
              explicitly-requested eps below the fp32 floor runs it in
              compensated double-single arithmetic (tpu/ds.py) for
              fp64-class accuracy in an fp32 engine.

Beam-pair routing (per-antenna beams) is padded and batched into O(1)
graph size when pair sizes are balanced, with a work-optimal per-pair
loop fallback for skewed routings; same-grid tabulated beam lists fuse
into one stacked-table interpolation.

Module layout:
  - this file: host orchestration -- input preparation, caches,
    dispatch, assembly, the async-fetch future;
  - tpu/planning.py: transform-path selection + spreader capacity
    planning (host);
  - tpu/program.py: the :class:`ProgramConfig` static-ingredient
    dataclass, the program builder, and the cache key derived from the
    dataclass fields by construction;
  - tpu/ds_lowering.py: the compensated double-single device lowerings.
"""

from __future__ import annotations

import copy as _copy
import logging
import os

import numpy as np

from ..beams.interface import BeamInterface, prepare_beams, stack_prepared
from ..coords.erfa_lite import TelescopeLocation, times_to_jd
from ..coords.rotation import SourceRotation
from ..core import coherency as coh_mod
from ..core import utils as core_utils
from ..core.beams import plan_beam_pairs
from ..core.hashing import beam_fingerprint as _beam_fingerprint
from ..core.hashing import cache_get_lru as _cache_get_lru
from ..core.hashing import consistent_inputs as _consistent_inputs
from ..core.hashing import hash_parts as _hash_parts
from ..core.simulate import SimulationEngine, default_accuracy_dict, resolve_precision
from ..core.utils import speed_of_light
from . import planning as _planning
from .ds_lowering import split_ds_hosts
from .planning import _SimPlan
from .planning import device_memory_limit as _device_memory_limit
from .program import (
    ProgramConfig,
    build_program,
    choose_freq_vmap,
)
from .program import cache_key as _program_cache_key

logger = logging.getLogger(__name__)

TWO_PI = 2.0 * np.pi


# Compiled-program cache. Rebuilding jax.jit(program) on every simulate()
# call would retrace AND recompile each time (the closures are fresh
# objects); production sweeps call simulate_vis repeatedly with the same
# configuration, so cache the jitted runner keyed by a fingerprint of every
# static ingredient of the traced program (tpu/program.py:cache_key).
_PROGRAM_CACHE: "dict[str, object]" = {}
_PLAN_CACHE: "dict[str, object]" = {}
_PROGRAM_CACHE_LIMIT = 16


def _cache_store(key: str, run) -> None:
    if len(_PROGRAM_CACHE) >= _PROGRAM_CACHE_LIMIT:
        _PROGRAM_CACHE.pop(next(iter(_PROGRAM_CACHE)))
    _PROGRAM_CACHE[key] = run


_INPUT_CACHE: "dict[str, object]" = {}
# Each simulate() configuration now caches ~7 device inputs (eq/coh/valid/
# beamtab plus the KB-scale mats/abvel/freqs/banding arrays); 32 entries
# keep a handful of alternating configurations resident without thrash.
# Entries are device buffers; the host cost is just the dict.
_INPUT_CACHE_LIMIT = 32


def _cached_device_put(build, key_parts):
    """Device-put with content caching for large time-independent inputs.

    ``key_parts`` hashes the RAW inputs (cheap: identity-memoized digests);
    ``build`` runs only on a miss, so steady-state sweep calls skip the
    astype/pad/stack host copies entirely.
    """
    import jax.numpy as jnp

    key = _hash_parts(key_parts)
    hit = _cache_get_lru(_INPUT_CACHE, key)
    if hit is not None:
        return hit
    dev = jnp.asarray(build() if callable(build) else build)
    if len(_INPUT_CACHE) >= _INPUT_CACHE_LIMIT:
        _INPUT_CACHE.pop(next(iter(_INPUT_CACHE)))
    _INPUT_CACHE[key] = dev
    return dev


def _matmul_precision(f32_pipeline: bool = True) -> str:
    """Engine-wide matmul precision (traced into the program).

    'float32' (full IEEE fp32 on the GPU) is the default and the accuracy
    contract: a plain float32 matmul on the GPU may run in TF32 (~1e-3
    relative), far above the 1e-5 gate. FFTVIS_MATMUL_PRECISION accepts
    any jax.default_matmul_precision value; on an H100 'high' lowers to
    the same TF32 GEMM as 'tensorfloat32' (PERF.md), so it is an opt-in
    only for accuracy budgets of ~1e-3. fp64 pipelines (CPU backends at
    precision=2) ignore the override: demoting f64 matmul passes would
    silently break the fp64 contract.
    """
    if not f32_pipeline:
        return "float32"
    return os.environ.get("FFTVIS_MATMUL_PRECISION", "float32")


def _with_f32_matmuls(fn, f32_pipeline: bool = True):
    """Wrap a callable so tracing/compilation sees the engine precision."""
    import functools

    import jax

    prec = _matmul_precision(f32_pipeline)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision(prec):
            return fn(*args, **kwargs)

    return wrapped


class VisibilityFuture:
    """Handle to an in-flight simulation (``async_fetch=True``).

    The jitted program has been dispatched and its device-to-host copy
    started (``jax.Array.copy_to_host_async``); ``result()`` blocks until
    the bytes arrive and assembles the final visibility array. Issuing
    several simulations before collecting any result pipelines their D2H
    transfers behind each other's dispatch and compute.
    ``np.asarray(future)`` is equivalent to ``future.result()``.
    """

    def __init__(self, device_out, assemble):
        import threading

        self._dev = device_out
        self._assemble = assemble
        self._result = None
        # result() must be safe to call from several collector threads on
        # the SAME future (the pipelined consumption pattern makes that
        # easy to do by accident): without the lock, the losing thread
        # would fetch/assemble a second time after the winner released
        # the buffers.
        self._lock = threading.Lock()
        try:  # start the D2H stream now (best effort)
            self._dev.copy_to_host_async()
        except Exception:  # pragma: no cover - backend without async copy
            pass

    @classmethod
    def from_result(cls, value: np.ndarray) -> "VisibilityFuture":
        """An already-resolved future (paths that cannot defer the fetch)."""
        import threading

        fut = cls.__new__(cls)
        fut._dev = None
        fut._assemble = None
        fut._result = value
        fut._lock = threading.Lock()
        return fut

    _warned_no_poll = False

    def done(self) -> bool:
        """True when the device computation has finished (transfer may
        still be in flight; ``result()`` can briefly block regardless)."""
        if self._result is not None or self._dev is None:
            return True
        try:
            return bool(self._dev.is_ready())
        except Exception:  # pragma: no cover
            # Backend without is_ready(): "cannot tell" must not read as
            # "ready" -- a poller would collect early and block for the
            # full compute, defeating the pipelining. result() still works,
            # but a done()-polling consumer degrades to serial collection;
            # say so once instead of silently always returning False.
            if not VisibilityFuture._warned_no_poll:
                VisibilityFuture._warned_no_poll = True
                logger.warning(
                    "VisibilityFuture.done(): this backend's arrays do not "
                    "support is_ready(); done() will always report False. "
                    "Polling consumers degrade to serial result() "
                    "collection (results themselves are unaffected)."
                )
            return False

    def result(self) -> np.ndarray:
        with self._lock:
            if self._result is None:
                stacked = self._fetch()
                self._result = self._assemble(stacked)
                # Release the device buffer AND the assembly closure (it
                # pins MB-scale engine locals -- pair routing tables,
                # index arrays).
                self._dev = None
                self._assemble = None
        return self._result

    def _fetch(self) -> np.ndarray:
        """D2H copy of the device output: a plain ``np.asarray``. A
        device-side flatten before the copy would queue behind later
        simulations' compute in a deep async pipeline (head-of-line
        blocking).
        """
        return np.asarray(self._dev)

    def __array__(self, dtype=None, copy=None):
        res = self.result()
        out = res if dtype is None else res.astype(dtype, copy=False)
        if copy and out is res:
            # NumPy 2 semantics: copy=True must not alias the memoized
            # result (callers may mutate the returned array in place).
            out = res.copy()
        elif copy is False and out is not res:
            raise ValueError(
                "dtype conversion requires a copy (copy=False requested)"
            )
        return out


class TPUSimulationEngine(SimulationEngine):
    """JAX/XLA visibility simulation engine (GPU or CPU; fp32 or fp64)."""

    def __init__(
        self,
        nufft_mode: str = "auto",
        mesh=None,
        time_axis: str = "time",
        source_axis: str = "source",
        freq_axis: str = "freq",
    ):
        """Parameters
        ----------
        nufft_mode
            'auto' (FLOP-model selection), or force 'type1'/'type3'/'direct'.
        mesh
            Optional jax.sharding.Mesh. When given, the simulation runs as
            one shard_map program: times data-parallel over ``time_axis``,
            sources sharded over ``source_axis`` with a psum of the NUFFT
            fine-grid (or direct partial sums) as the only collective --
            the SPMD equivalent of the reference's Ray fan-out +
            shared-memory store (ref cpu_simulate.py:714-837).
        """
        if nufft_mode not in ("auto", "type1", "type3", "direct"):
            raise ValueError(f"invalid nufft_mode {nufft_mode!r}")
        self.nufft_mode = nufft_mode
        self.mesh = mesh
        self.time_axis = time_axis
        self.source_axis = source_axis
        self.freq_axis = freq_axis

    # ------------------------------------------------------------------
    def simulate(self, *args, **kwargs) -> np.ndarray | VisibilityFuture:
        # One simulate() call is single-threaded and never mutates its
        # input arrays midway: let the digest memo revalidate each hashed
        # array at most once per call (MB-scale flux/position checksums
        # repeated across plan/program/input cache keys were a third of
        # the steady-state host wall).
        with _consistent_inputs():
            return self._simulate_impl(*args, **kwargs)

    def _simulate_impl(
        self,
        ants: dict,
        freqs: np.ndarray,
        fluxes: np.ndarray,
        beam_list: list,
        ra: np.ndarray,
        dec: np.ndarray,
        times,
        telescope_loc,
        baselines: list | None = None,
        beam_idx: np.ndarray | None = None,
        precision: int = 2,
        polarized: bool = False,
        eps: float | None = None,
        upsample_factor=None,
        beam_spline_opts: dict | None = None,
        flat_array_tol: float = 1e-6,
        interpolation_function: str = "az_za_map_coordinates",
        nprocesses=1,
        nthreads=None,
        coord_method: str = "CoordinateRotationERFA",
        coord_method_params: dict | None = None,
        force_use_ray: bool = False,
        force_use_type3: bool = False,
        trace_mem: bool = False,
        enable_memory_monitor: bool = False,
        nchunks: int = 1,
        source_buffer: float = 1.0,
        beam_coefs: np.ndarray | None = None,
        return_program: bool = False,
        async_fetch: bool = False,
    ) -> np.ndarray | VisibilityFuture:
        import jax
        import jax.numpy as jnp

        del nprocesses, nthreads, force_use_ray, source_buffer  # host-pool knobs
        coord_method_params = coord_method_params or {}
        # Reference parity (ref core/simulate.py:118-126): the known
        # CoordinateRotation kwargs are accepted; all but
        # ``include_aberration`` are documented no-ops here (this engine
        # computes the exact per-time rotation chain up front, so ERFA's
        # BCRS refresh cadence and the dynamic-compaction buffer have no
        # analogue). Unknown keys raise -- a typo'd key silently swallowed
        # would be a debugging trap for drop-in callers.
        _known_cmp = {
            "include_aberration",  # honored: toggles annual aberration
            "update_bcrs_every",  # no-op: rotations are exact per time
            "source_buffer",  # no-op: static-shape masking, no compaction
            "chunk_size",  # no-op: source blocking is planned by HBM budget
        }
        _unknown_cmp = set(coord_method_params) - _known_cmp
        if _unknown_cmp:
            raise ValueError(
                f"unknown coord_method_params keys {sorted(_unknown_cmp)}; "
                f"known keys are {sorted(_known_cmp)} (only "
                "'include_aberration' changes behavior on this engine)"
            )

        freqs = np.atleast_1d(np.asarray(freqs, dtype=float))
        nfreqs = freqs.size
        real_dtype, complex_dtype = resolve_precision(precision)
        # The wrapper pre-fills the default eps, so "explicit" means a value
        # differing from this precision's default.
        eps_explicit = eps is not None and eps != default_accuracy_dict[precision]
        if eps is None:
            eps = default_accuracy_dict[precision]
        # An eps beyond the compute precision only inflates the kernel width.
        # (The precision=2-on-GPU default case is covered by the one-time
        # resolve_precision warning; only an explicitly requested eps gets a
        # per-call notice.)
        eps_floor = 5e-7 if real_dtype == np.float32 else 1e-13
        # An explicitly-requested eps beyond fp32 selects the compensated
        # double-single DIRECT path (tpu/ds.py): fp64-class phase/
        # accumulation accuracy (~1e-7 end to end, beam/flux-limited) on
        # hardware with no float64 -- the honest answer to the reference's
        # precision=2 / eps=1e-13 contract. FFTVIS_DS=1 forces it.
        use_ds = real_dtype == np.float32 and (
            (precision == 2 and eps_explicit and eps < eps_floor)
            or os.environ.get("FFTVIS_DS") == "1"
        )
        if eps_explicit and eps < eps_floor and not use_ds:
            logger.warning(
                "requested NUFFT eps=%.1e is below what %s can resolve; "
                "using eps=%.1e",
                eps,
                np.dtype(real_dtype).name,
                eps_floor,
            )
        eps = max(eps, eps_floor)

        # None means the default sigma=2. (An auto-1.25 variant for f32
        # type-3 shrinks the fine grid but loses up to 5e-4 accuracy,
        # config-dependently -- see planning.plan_transform's docstring.
        # Not safe as a default.)
        if upsample_factor is None:
            upsample_factor = 2

        nbeam = len(beam_list)
        nant = len(ants)
        beam_idx = core_utils.validate_beam_idx(beam_idx, beam_coefs, nbeam, nant)
        use_basis = beam_coefs is not None
        nfeeds = 2 if polarized else 1

        if baselines is None:
            # Redundancy grouping is a pure function of the antenna layout
            # and loops all O(nant^2) pairs in Python: cache the
            # representative-baseline list across simulate() calls.
            rkey = _hash_parts(("reds-v1", tuple(map(repr, ants)), np.array(
                [np.asarray(v, dtype=float) for v in ants.values()])))
            baselines = _cache_get_lru(_PLAN_CACHE, rkey)
            if baselines is None:
                reds = core_utils.get_pos_reds(ants, include_autos=True)
                baselines = [red[0] for red in reds]
                if len(_PLAN_CACHE) >= _PROGRAM_CACHE_LIMIT:
                    _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
                _PLAN_CACHE[rkey] = baselines
        nbl = len(baselines)
        antnums = list(ants.keys())
        # Canonical integer form of the baseline list: hashing/caching must
        # not walk 10^4-10^5 Python tuples element by element (that alone
        # cost ~0.2 s/call on the gridded headline workload). The Python
        # index loop itself costs ~20 ms/call at 63k baselines, so the
        # conversion is memoized on the CONTENT of (antnums, baselines):
        # the dict key is the tuple-ized input (hash + equality both run at
        # C speed, ~2 ms), so a stale hit is impossible, and the returned
        # array keeps a stable identity across calls -- which also lets the
        # digest identity memo skip re-hashing it in pp_key/plan_key below.
        bl_memo_key = (tuple(antnums), tuple(baselines))
        try:
            bl_index_arr = _cache_get_lru(_PLAN_CACHE, bl_memo_key)
        except TypeError:  # ndarray / list-of-list elements are unhashable
            bl_memo_key = (
                tuple(antnums),
                tuple((b[0], b[1]) for b in baselines),
            )
            bl_index_arr = _cache_get_lru(_PLAN_CACHE, bl_memo_key)
        if bl_index_arr is None:
            ant_index = {a: i for i, a in enumerate(antnums)}
            bl_index_arr = np.array(
                [(ant_index[b0], ant_index[b1]) for b0, b1 in baselines],
                dtype=np.int64,
            ).reshape(nbl, 2)
            bl_index_arr.setflags(write=False)
            if len(_PLAN_CACHE) >= _PROGRAM_CACHE_LIMIT:
                _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
            _PLAN_CACHE[bl_memo_key] = bl_index_arr

        fluxes_arr = np.asarray(fluxes)
        polarized_sky = coh_mod.classify_sky(fluxes_arr, polarized_beam=polarized)

        # The coordinate chain (per-time ERFA-class matrices) and the static
        # horizon cull are pure functions of (sky, times, site): cache the
        # culled SourceRotation across simulate() calls of a sweep (~6 ms
        # per call at nside-64 scale on the host).
        # Each call gets a SHALLOW copy: horizon banding later assigns a
        # permuted eq_vectors onto the object (a new array, no in-place
        # mutation), which must not leak into the pristine cached instance
        # -- the banding plan cache keys on the pristine array identity.
        _include_ab = coord_method_params.get("include_aberration", True)
        rot_key = _hash_parts(
            (
                "rot-v1", np.asarray(ra), np.asarray(dec), times_to_jd(times),
                repr(TelescopeLocation.from_any(telescope_loc)),
                coord_method, bool(_include_ab),
            )
        )
        rot = _cache_get_lru(_PLAN_CACHE, rot_key)
        if rot is None:
            rot = SourceRotation(
                ra, dec, times, telescope_loc, coord_method=coord_method,
                include_aberration=_include_ab,
            )
            # Static horizon culling: sources below the horizon at every
            # simulated time are exact zeros (the device mask kills them);
            # dropping them before planning shrinks every downstream shape
            # -- the static-shape analogue of the reference's per-chunk
            # dynamic compaction (ref cpu_simulate.py:940-945).
            rot._src_keep = rot.cull_never_visible()
            if rot._src_keep is not None:
                logger.info(
                    "horizon culling: %d / %d sources never rise during "
                    "the simulated times; dropped before planning",
                    rot._src_keep.size - rot.nsrc, rot._src_keep.size,
                )
            # Freeze the engine-owned rotation arrays: cache keys hash them
            # every simulate() call, and a frozen (immutable-owner) array
            # gets a one-time digest instead of a per-call CRC revalidation
            # (~MB-scale on large catalogs -- measured ~3 ms/call of pure
            # checksum on the gridded sweep before this).
            rot.eq_vectors.setflags(write=False)
            rot.matrices.setflags(write=False)
            if rot.aberration is not None:
                rot.aberration.setflags(write=False)
            if len(_PLAN_CACHE) >= _PROGRAM_CACHE_LIMIT:
                _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
            _PLAN_CACHE[rot_key] = rot
        src_keep = rot._src_keep
        rot = _copy.copy(rot)
        ntimes = rot.ntimes
        nsrc = rot.nsrc

        # ---------------- pair routing / basis channels ----------------
        # User-provided beam_coefs follow the reference's k<=l half-list
        # plus transpose-reuse contraction (ref cpu_simulate.py:423-468);
        # the auto-rank path below selects its own channel-list semantics.
        basis_kl_sym = True
        # User-provided beam_coefs keep the reference's basis semantics
        # (no flip bookkeeping, ref cpu_simulate.py:442-458); only the
        # auto-rank substitution below must replicate the per-antenna
        # flipped-baseline convention.
        basis_flip_transpose = None
        if use_basis:
            K = nbeam
            kl_pairs = [(k, l) for k in range(K) for l in range(k, K)]
            pair_plan = None
            npairs = len(kl_pairs)
            flipped_global = np.zeros(nbl, dtype=bool)
            ant1_idx = bl_index_arr[:, 0]
            ant2_idx = bl_index_arr[:, 1]
        else:
            # Pair routing is a pure function of (ants, baselines, beam_idx)
            # and loops the full baseline list in Python: cache it.
            pp_key = _hash_parts(
                (tuple(map(repr, antnums)), bl_index_arr,
                 None if beam_idx is None else np.asarray(beam_idx))
            )
            cached_pp = _cache_get_lru(_PLAN_CACHE, pp_key)
            if cached_pp is None:
                pair_plan = plan_beam_pairs(antnums, baselines, beam_idx)
                flipped_global = np.zeros(nbl, dtype=bool)
                for sel, fl in zip(pair_plan.bls_idxs, pair_plan.flipped):
                    flipped_global[sel] = fl
                flipped_global.setflags(write=False)  # one-time digest
                _PLAN_CACHE[pp_key] = (pair_plan, flipped_global)
            else:
                pair_plan, flipped_global = cached_pp
            npairs = pair_plan.npairs
            kl_pairs = None

        # Accuracy-controlled automatic rank compression (core/auto_rank.py):
        # per-antenna tabulated beam lists are usually a near-low-rank
        # family, and the transform cost is linear in the channel count
        # (npairs x nfeeds^2). When an SVD of the stacked tables reaches a
        # residual of eps/8 at K eigenbeams with a >= 2x channel-count win,
        # switch to the (exact-contraction) basis path with per-antenna
        # coefficients. Polarized only (the unpolarized pair weight
        # sqrt(B_i B_j) is not bilinear in the tables); skipped for the DS
        # path (its contract is exactness) and for fp64-class eps (the
        # required rank approaches full). FFTVIS_AUTO_RANK=0 disables.
        if (
            not use_basis
            and polarized
            and not use_ds
            and npairs >= 8
            and eps >= 1e-9
            and os.environ.get("FFTVIS_AUTO_RANK", "") != "0"
        ):
            from ..core.auto_rank import plan_auto_rank

            arp = plan_auto_rank(
                beam_list,
                tol=eps / 8.0,
                npairs=npairs,
                allow_sym=not polarized_sky,
            )
            if arp is not None:
                logger.info(
                    "auto-rank: %d-pair per-antenna routing compressed to "
                    "K=%d eigenbeams (%d -> %d channels, %s channel list, "
                    "residual %.2e)",
                    npairs, arp.K, npairs * nfeeds**2,
                    len(arp.kl_pairs) * nfeeds**2,
                    "symmetric" if arp.kl_sym else "ordered", arp.residual,
                )
                beam_list = [BeamInterface(eb) for eb in arp.eigenbeams]
                nbeam = arp.K
                use_basis = True
                basis_kl_sym = arp.kl_sym
                kl_pairs = list(arp.kl_pairs)
                npairs = len(kl_pairs)
                pair_plan = None
                # Auto-rank must be a TRANSPARENT substitute for the
                # per-antenna path, including the reference's flipped-
                # baseline convention (conj without feed swap, ref
                # cpu_simulate.py:298-300): on baselines the pair routing
                # canonicalized by flipping, that convention returns the
                # feed TRANSPOSE of the plain A_i^H C A_j result (exactly:
                # conj(V_(j,i)(-b)) = V_(i,j)(b)^T for Hermitian sky
                # coherency). The basis contraction computes the plain
                # result, so it must transpose those baselines to match --
                # for distinct complex tables the two differ at O(cross-pol
                # phase), 5e-2 on structured-beam arrays (the
                # structured beamfits asset caught this).
                basis_flip_transpose = flipped_global
                flipped_global = np.zeros(nbl, dtype=bool)
                ant1_idx = bl_index_arr[:, 0]
                ant2_idx = bl_index_arr[:, 1]
                coefs_ant = arp.coefs[np.asarray(beam_idx)]  # (nant, K)
                beam_coefs = np.repeat(
                    coefs_ant[:, :, None].astype(np.complex128), nfreqs,
                    axis=2,
                )

        # Padded-vs-loop pair routing decision (details in
        # tpu/program.py's routing-table construction); needed early for
        # direct-path block sizing.
        pad_routing = False
        m_max = 0
        if not use_basis and npairs > 1:
            m_max = max(len(s) for s in pair_plan.bls_idxs)
            pad_routing = npairs * m_max <= 4 * nbl or npairs > 32

        if use_ds:
            logger.info(
                "eps below the fp32 floor: forcing the EXACT direct path "
                "with compensated double-single arithmetic (~1e-7 "
                "end-to-end; beam/flux inputs are f32)"
            )

        # ---------------- geometry / transform planning ----------------
        # Host planning is itself cached: the kernel-FT quadrature and
        # griddability analysis are pure functions of the array geometry.
        import jax as _jax

        plan_key = _hash_parts(
            (
                "plan-v1",
                use_ds,
                np.array([np.asarray(ants[a], dtype=float) for a in ants]),
                bl_index_arr,
                float(np.max(freqs)),
                float(eps),
                float(upsample_factor),
                float(flat_array_tol),
                bool(force_use_type3),
                flipped_global,
                nsrc,
                nfeeds,
                npairs,
                self.nufft_mode,
                _jax.default_backend(),
                os.environ.get("FFTVIS_TYPE1", "auto"),
            )
        )
        plan = _cache_get_lru(_PLAN_CACHE, plan_key)
        if plan is None:
            plan = self._plan_transform(
                ants, baselines, freqs, eps, upsample_factor, flat_array_tol,
                force_use_type3, flipped_global, nbl, nsrc, nfeeds, npairs,
                mode_override="direct" if use_ds else None,
            )
            if len(_PLAN_CACHE) >= _PROGRAM_CACHE_LIMIT:
                _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
            _PLAN_CACHE[plan_key] = plan
        # Always work on a per-call copy: nsrc-derived blocking fields are
        # (re)set below, and the strip-spreader config must not leak into
        # the cached plan or into programs returned by earlier calls.
        plan = _SimPlan(**{**plan.__dict__})

        # Double-single COORDINATES for the fp32 type-1 path: the dominant
        # fp32 error of the gridded transform is the source-position chain
        # (topo rotation -> lattice coords -> grid coordinate mod), whose
        # ~|value| * 2^-24 rounding turns into ~6e-5 rad of phase noise at
        # HERA-331 scale, a relative vis error at the north-star 1e-5 gate.
        # Computing just the coordinates in two-float arithmetic (O(nsrc)
        # work, beams/coherency stay f32) restores ~ulp(1) fractional grid
        # positions. On by default on the GPU, off on the CPU test backend
        # (planning.ds_coords_default). FFTVIS_DS_COORDS=1 forces on
        # (mechanics tests), =0 disables.
        _dsc_env = os.environ.get("FFTVIS_DS_COORDS", "")
        ds_coords = (
            not use_ds
            and real_dtype == np.float32
            and plan.mode in ("type1", "type3")
            and (
                _dsc_env == "1"
                or (_dsc_env != "0" and _planning.ds_coords_default())
            )
        )

        # Mesh geometry (SPMD): times data-parallel, sources psum-sharded.
        mesh = self.mesh
        n_tdev = int(mesh.shape.get(self.time_axis, 1)) if mesh is not None else 1
        n_sdev = int(mesh.shape.get(self.source_axis, 1)) if mesh is not None else 1
        n_fdev = int(mesh.shape.get(self.freq_axis, 1)) if mesh is not None else 1

        # Frequency padding for the sharded axis (padded channels reuse the
        # last frequency -- beams stay in range -- and are sliced off after).
        nf_pad = int(np.ceil(nfreqs / n_fdev)) * n_fdev
        freqs_padded = np.concatenate(
            [freqs, np.full(nf_pad - nfreqs, freqs[-1])]
        )
        nfreqs_local = nf_pad // n_fdev

        # Source blocking (static-shape replacement for source chunking).
        nchunks = max(1, min(int(nchunks), nsrc))
        if plan.mode == "direct":
            # The exact path materializes a (block x nbl) phase matrix per
            # scan step; cap its footprint (~12 bytes/element for phase +
            # fringe; ~8x that for the double-single planes + pairwise
            # reduction working set) well below HBM.
            budget = int(_device_memory_limit() // 12)
            # DS materializes (C, block, nbl) two-float temporaries for the
            # vectorized channel products; scale the budget accordingly.
            _C_ds = npairs * nfeeds**2
            per_elem = (96 * max(_C_ds, 1)) if use_ds else 12
            eff_bl = npairs * m_max if pad_routing else nbl
            if use_ds:
                eff_bl = nbl  # DS accumulates every channel at all baselines
            max_block = max(
                256 if use_ds else 1024, budget // max(eff_bl * per_elem, 1)
            )
            nchunks = max(nchunks, -(-nsrc // (max_block * n_sdev)))
            nchunks = min(nchunks, nsrc)
        elif plan.mode == "type1":
            # Device efficiency, not memory: ~4k-source blocks under
            # lax.scan bound the type-1 spread pipeline's working set for
            # very large catalogs (the block size has not been swept on
            # the GPU). Type-1 only: the per-block work is
            # occupancy-proportional there, whereas the type-3 strip/tile
            # scans cost their static capacity per block. Engages only for
            # catalogs far past the efficiency target.
            tgt_blk = int(os.environ.get("FFTVIS_BLOCK", "4096"))
            if tgt_blk > 0 and nsrc > 32 * tgt_blk * n_sdev:
                nchunks = max(nchunks, -(-nsrc // (tgt_blk * n_sdev)))
        block = int(np.ceil(nsrc / (nchunks * n_sdev)))
        nsrc_pad = block * nchunks * n_sdev
        plan.nsrc_pad, plan.nblocks, plan.block = nsrc_pad, nchunks, block

        # Per-time horizon-band block skipping (long observations): with
        # sources ordered always-up-first then by RA, only the blocks that
        # hold any above-horizon source at time t are scanned -- the
        # static-shape analogue of the reference's dynamic per-chunk
        # compaction (ref cpu_simulate.py:940-945), skipping beam
        # evaluation + coherency + spreading for the invisible sky. Planned
        # exactly on the host (coords/banding.py) and cached; engages only
        # when >= 15% of (time, block) instances drop. The source axis must
        # be unsharded (the block table is a global-order construct).
        #
        # Two execution shapes:
        # - type1/direct/DS: scan over the K per-time active blocks
        #   (banded_body; per-block work is occupancy-proportional there).
        # - type3: COMPACTION -- gather the K active blocks into one
        #   contiguous (K*block) axis (a lax.scan of dynamic slices) and
        #   run the normal pipeline once on it. A banded block SCAN would
        #   pay the spread's O(grid) post-pass once per block call;
        #   compaction pays exactly one spread + post-pass per (time,
        #   freq) while beam eval, coherency, pre-phase, bin-sort and
        #   spread all pay K*block instead of nsrc. Requires a spread
        #   whose cost is occupancy-proportional at (K*block)-source
        #   calls (_type3_compact_ok): the capacity-planned strip/tiled
        #   XLA scans are excluded.
        _c_weights = (len(kl_pairs) if use_basis else npairs) * nfeeds**2
        band = None
        band_compact = False
        if (
            n_sdev == 1
            and ntimes >= 8
            and nsrc >= 4096
            # use_ds forces mode_override="direct", already matched here.
            and plan.mode in ("type1", "direct", "type3")
            and os.environ.get("FFTVIS_BAND", "") != "0"
        ):
            from ..coords.banding import plan_horizon_bands

            # Banding needs block granularity (the skip resolution is one
            # block), but per-scan-step fixed cost dominates for small
            # blocks (tiny einsums/matmuls); 4096 sources per block is the
            # default.
            _band_tgt = int(os.environ.get("FFTVIS_BAND_BLOCK", "4096"))
            nb_try = min(max(plan.nblocks, nsrc // _band_tgt, 8), nsrc)
            blk_try = int(np.ceil(nsrc / nb_try))
            pad_try = blk_try * nb_try
            _compact = plan.mode == "type3" and not use_ds
            _viable = (not _compact) or _planning.type3_compact_ok(plan)
            bkey = _hash_parts(
                (
                    "band-v1",
                    rot.eq_vectors,
                    rot.matrices,
                    None if rot.aberration is None else rot.aberration,
                    blk_try,
                    nb_try,
                    pad_try,
                )
            )
            cached_band = _cache_get_lru(_PLAN_CACHE, bkey)
            if cached_band is None:
                cached_band = "miss"
            if not _viable:
                cached_band = (None, None)  # capacity-planned type-3 spread
            if isinstance(cached_band, str):
                band = plan_horizon_bands(rot, blk_try, nb_try, pad_try)
                banded_eq = None
                if band is not None:
                    # Materialize the permuted catalog ONCE and cache it
                    # frozen alongside the plan: a fresh fancy-indexed
                    # array per call would defeat the identity-keyed
                    # digest memo and re-hash multi-MB every simulate().
                    banded_eq = rot.eq_vectors[:, band[0]]
                    banded_eq.setflags(write=False)
                if len(_PLAN_CACHE) >= _PROGRAM_CACHE_LIMIT:
                    _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
                _PLAN_CACHE[bkey] = (band, banded_eq)
            else:
                band, banded_eq = cached_band
            if band is not None:
                rot.eq_vectors = banded_eq
                plan.nsrc_pad, plan.nblocks, plan.block = pad_try, nb_try, blk_try
                nsrc_pad = pad_try
                band_compact = _compact
                logger.info(
                    "horizon banding engaged: %d of %d source blocks "
                    "%s per time",
                    band[1].shape[1], nb_try,
                    "compacted" if band_compact else "scanned",
                )
        band_perm = None if band is None else band[0]
        banded = band is not None
        K_band = int(band[1].shape[1]) if banded else 0

        # The capacity-planned XLA spreaders (FFTVIS_SPREADER=tiled/strip)
        # take a static per-tile capacity from a host-side sliding-window
        # bound over the (exactly known) rotated source coordinates.
        _planning.configure_strip_spreader(plan, rot, freqs)

        nt_pad = int(np.ceil(ntimes / n_tdev)) * n_tdev

        # ---------------- prepared beams ----------------
        prepared = prepare_beams(
            beam_list,
            freqs=freqs,
            polarized=polarized,
            spline_opts=beam_spline_opts,
            interpolation_function=interpolation_function,
        )
        # Same-grid tabulated beam lists (eigenbeam bases, per-antenna CST
        # sweeps) fuse into ONE stacked-table interpolation (see
        # tpu/program.py); stack_prepared returns None for mixed lists.
        batched_beams = stack_prepared(prepared)

        # ---------------- device inputs ----------------
        def pad_src(arr, fill=0.0):
            pad = nsrc_pad - nsrc
            if pad == 0:
                return arr
            widths = [(0, 0)] * arr.ndim
            widths[0] = (0, pad)
            return np.pad(arr, widths, constant_values=fill)

        def _build_eq():
            eq = rot.eq_vectors.astype(real_dtype)  # (3, nsrc)
            if nsrc_pad > nsrc:
                # Pad with valid unit vectors (zenith-ish): zero-padding
                # would produce 0/0 NaNs in the aberration normalization,
                # and NaN * 0 masking is still NaN.
                pad_vecs = np.zeros((3, nsrc_pad - nsrc), dtype=real_dtype)
                pad_vecs[2] = 1.0
                eq = np.concatenate([eq, pad_vecs], axis=1)
            return eq

        coh_was_complex = polarized_sky  # IQUV coherency is (.., 2, 2) complex

        def _build_coh():
            fl = fluxes_arr if src_keep is None else fluxes_arr[src_keep]
            if band_perm is not None:  # horizon-band source reordering
                fl = fl[band_perm]
            coherency = coh_mod.build_coherency(fl, polarized_sky)
            ch = pad_src(
                coherency.astype(complex_dtype if polarized_sky else real_dtype)
            )
            if nf_pad > nfreqs:  # pad the (sharded) freq axis; sliced after
                widths = [(0, 0)] * ch.ndim
                widths[1] = (0, nf_pad - nfreqs)
                ch = np.pad(ch, widths)
            # Complex buffers cannot cross host<->device on this runtime:
            # ship stacked (re, im) planes.
            return np.stack([ch.real, ch.imag]) if polarized_sky else ch

        def _build_valid():
            valid = np.zeros(nsrc_pad, dtype=real_dtype)
            valid[:nsrc] = 1.0
            return valid

        tg_ds_host = lat_ds_host = k2pi_c_ds = freqs_ds_host = None
        if use_ds or ds_coords:
            # Double-single host constants (tpu/ds_lowering.py) plus the
            # DS-split per-time matrices and source vectors.
            from . import ds as _ds

            tg_ds_host, lat_ds_host, k2pi_c_ds, freqs_ds_host = split_ds_hosts(
                plan, freqs_padded, use_ds, speed_of_light
            )

            def _build_eq_ds():
                eq = rot.eq_vectors  # float64
                if nsrc_pad > nsrc:
                    pad_vecs = np.zeros((3, nsrc_pad - nsrc))
                    pad_vecs[2] = 1.0
                    eq = np.concatenate([eq, pad_vecs], axis=1)
                return np.stack(_ds.split64(eq), axis=-1)  # (3, n, 2)

            mats64 = rot.matrices
            abvel64 = (
                rot.aberration
                if rot.aberration is not None
                else np.zeros((ntimes, 3))
            )
            if nt_pad > ntimes:
                mats64 = np.concatenate(
                    [mats64, np.broadcast_to(np.eye(3), (nt_pad - ntimes, 3, 3))]
                )
                abvel64 = np.concatenate(
                    [abvel64, np.zeros((nt_pad - ntimes, 3))]
                )
            mats_host = np.stack(_ds.split64(mats64), axis=-1)  # (nt, 3, 3, 2)
            abvel_host = np.stack(_ds.split64(abvel64), axis=-1)  # (nt, 3, 2)

        else:
            mats_host = rot.matrices.astype(real_dtype)  # (nt, 3, 3)
            if rot.aberration is not None:
                abvel_host = rot.aberration.astype(real_dtype)
            else:
                abvel_host = np.zeros((ntimes, 3), dtype=real_dtype)
            if nt_pad > ntimes:
                pad_mats = np.broadcast_to(
                    np.eye(3, dtype=real_dtype), (nt_pad - ntimes, 3, 3)
                )
                mats_host = np.concatenate([mats_host, pad_mats], axis=0)
                abvel_host = np.concatenate(
                    [abvel_host, np.zeros((nt_pad - ntimes, 3), dtype=real_dtype)],
                    axis=0,
                )
        # Closure constants stay NumPy: jit embeds host arrays directly into
        # the program, whereas eagerly-created device arrays must round-trip
        # through the host at trace time.
        freqs_dev = freqs_padded.astype(real_dtype)

        coefs_host = ant1_dev = ant2_dev = None
        if use_basis:
            coefs_host = beam_coefs.astype(complex_dtype)
            ant1_dev = np.asarray(ant1_idx)
            ant2_dev = np.asarray(ant2_idx)

        # ---------------- the jitted program ----------------
        freq_vmap = choose_freq_vmap(
            plan, npairs, nfeeds, pad_routing, m_max, use_ds, band_compact,
            K_band, nbl, nfreqs_local,
        )

        cfg = ProgramConfig(
            plan=plan,
            use_ds=use_ds,
            ds_coords=ds_coords,
            banded=banded,
            band_compact=band_compact,
            K_band=K_band,
            real_dtype=real_dtype,
            complex_dtype=complex_dtype,
            eps=float(eps),
            upsample_factor=float(upsample_factor),
            matmul_precision=_matmul_precision(real_dtype == np.float32),
            freq_vmap=freq_vmap,
            nbl=nbl,
            nfeeds=nfeeds,
            npairs=npairs,
            nfreqs=nfreqs,
            nf_pad=nf_pad,
            nfreqs_local=nfreqs_local,
            nt_pad=nt_pad,
            n_fdev=n_fdev,
            polarized=bool(polarized),
            polarized_sky=bool(polarized_sky),
            pair_plan=pair_plan,
            flipped_global=flipped_global,
            pad_routing=pad_routing,
            m_max=m_max,
            use_basis=bool(use_basis),
            basis_kl_sym=bool(basis_kl_sym),
            kl_pairs=tuple(kl_pairs) if use_basis else None,
            basis_flip_transpose=basis_flip_transpose,
            coefs_host=coefs_host,
            ant1_dev=ant1_dev,
            ant2_dev=ant2_dev,
            prepared=prepared,
            batched_beams=batched_beams,
            beam_fps=tuple(_beam_fingerprint(b) for b in beam_list),
            spline_opts_repr=repr(beam_spline_opts),
            interpolation_function=interpolation_function,
            freqs_dev=freqs_dev,
            tg_ds_host=tg_ds_host,
            lat_ds_host=lat_ds_host,
            k2pi_c_ds=k2pi_c_ds,
            freqs_ds_host=freqs_ds_host,
            mesh=mesh,
            time_axis=self.time_axis,
            source_axis=self.source_axis,
            freq_axis=self.freq_axis,
        )

        # ---------------- program cache ----------------
        cache_key = _program_cache_key(cfg)

        run = _cache_get_lru(_PROGRAM_CACHE, cache_key)
        in_specs_t = None
        if mesh is not None:
            from jax.sharding import PartitionSpec as P

            T, S = self.time_axis, self.source_axis
            F = self.freq_axis if self.freq_axis in mesh.shape else None
            coh_spec = P(None, S, F) if coh_was_complex else P(S, F)
            in_specs_t = (P(T), P(T), P(None, S), coh_spec, P(S), P(F), P())
            if banded:  # per-time active-block tables shard with time
                in_specs_t = in_specs_t + (P(T), P(T))

        if run is None:
            program = build_program(cfg)
            if mesh is None:
                run = jax.jit(program)
            else:
                from jax import shard_map as _shard_map

                run = jax.jit(
                    _shard_map(
                        program,
                        mesh=mesh,
                        in_specs=in_specs_t,
                        out_specs=(
                            P(None, None, T, F) if use_ds else P(None, T, F)
                        ),
                    )
                )
            # A float32 matmul may run in TF32 on the GPU (~1e-3); the
            # NUFFT spread/interp contractions and coherency einsums need
            # full f32.
            run = _with_f32_matmuls(run, real_dtype == np.float32)
            _cache_store(cache_key, run)

        # Multi-process meshes: the mesh spans devices this process
        # cannot address, so inputs must be GLOBAL arrays sharded exactly
        # as the shard_map in_specs demand (every process holds the full
        # host copy and contributes its addressable shards), and the output
        # must be allgathered back to every host. Single-process meshes
        # keep the plain device-put path (pjit reshards locally for free).
        if banded:
            _K_band = int(band[1].shape[1])
            act_idx_host = np.zeros((nt_pad, _K_band), dtype=np.int32)
            act_val_host = np.zeros((nt_pad, _K_band), dtype=np.float32)
            act_idx_host[:ntimes] = band[1]
            act_val_host[:ntimes] = band[2]

        multiproc = mesh is not None and any(
            d.process_index != jax.process_index() for d in mesh.devices.flat
        )
        if multiproc:
            from jax.sharding import NamedSharding

            host_inputs = (
                mats_host,
                abvel_host,
                _build_eq_ds() if (use_ds or ds_coords) else _build_eq(),
                _build_coh(),
                _build_valid(),
                freqs_dev,
                batched_beams.table
                if batched_beams is not None
                else np.zeros(1, dtype=np.float32),
            )
            if banded:
                host_inputs = host_inputs + (act_idx_host, act_val_host)
            inputs = tuple(
                jax.make_array_from_callback(
                    h.shape,
                    NamedSharding(mesh, spec),
                    lambda idx, _h=h: _h[idx],
                )
                for h, spec in zip(host_inputs, in_specs_t)
            )
            if return_program:
                if return_program == "full":
                    return run, inputs, self._program_info(
                        ntimes, nfreqs, polarized, nfeeds, use_ds, use_basis,
                        polarized_sky, src_keep, band_perm, nsrc_pad, nf_pad,
                        real_dtype, complex_dtype, batched_beams, fluxes_arr,
                        bl_index_arr, flipped_global, program_config=cfg,
                    )
                return run, inputs
            from jax.experimental import multihost_utils

            stacked = np.asarray(
                multihost_utils.process_allgather(run(*inputs), tiled=True)
            )
            out = self._assemble_output(
                stacked, use_ds, use_basis, ntimes, nfreqs, npairs, nfeeds,
                nbl, flipped_global, pair_plan, beam_coefs, ant1_idx if use_basis else None,
                ant2_idx if use_basis else None, *cfg_pairs(cfg),
                complex_dtype, polarized, trace_mem,
            )
            if async_fetch:
                # The allgather is collective and blocking; hand back an
                # already-resolved future so callers see a uniform type.
                return VisibilityFuture.from_result(out)
            return out

        # Time-independent inputs (source vectors, coherency, validity mask)
        # are content-cached on device, keyed on the RAW user arrays:
        # parameter sweeps re-call simulate() with the same catalog, and both
        # the host prep copies and the uploads are worth skipping.
        _dt_key = (str(real_dtype), str(complex_dtype))
        # The small per-time inputs (rotation matrices, aberration, freqs,
        # banding schedule) are rebuilt as fresh host arrays every call, so
        # a plain jnp.asarray re-uploads them each time (a device_put
        # dispatch per input per steady-state call).
        # Content-keying them is cheap -- they are KB-scale -- and sweep
        # calls with unchanged times/freqs hit the device cache.
        inputs = (
            _cached_device_put(lambda: mats_host, ("mats", mats_host)),
            _cached_device_put(lambda: abvel_host, ("abvel", abvel_host)),
            _cached_device_put(
                _build_eq_ds if (use_ds or ds_coords) else _build_eq,
                (
                    "eq64" if (use_ds or ds_coords) else "eq",
                    rot.eq_vectors, nsrc_pad, _dt_key,
                ),
            ),
            _cached_device_put(
                _build_coh,
                ("coh", fluxes_arr, src_keep, band_perm, polarized_sky,
                 nsrc_pad, nf_pad, _dt_key),
            ),
            _cached_device_put(
                _build_valid, ("valid", nsrc, nsrc_pad, str(real_dtype))
            ),
            _cached_device_put(lambda: freqs_dev, ("freqs", freqs_dev)),
            # Stacked beam table as a real input (replicated); a tiny dummy
            # when there is no batched table so the program arity is fixed.
            _cached_device_put(
                (lambda: batched_beams.table)
                if batched_beams is not None
                else (lambda: np.zeros(1, dtype=np.float32)),
                ("beamtab", batched_beams.table)
                if batched_beams is not None
                else ("beamtab-none",),
            ),
        )
        if banded:
            inputs = inputs + (
                _cached_device_put(lambda: act_idx_host, ("actidx", act_idx_host)),
                _cached_device_put(lambda: act_val_host, ("actval", act_val_host)),
            )

        if return_program:
            if return_program == "full":
                return run, inputs, self._program_info(
                    ntimes, nfreqs, polarized, nfeeds, use_ds, use_basis,
                    polarized_sky, src_keep, band_perm, nsrc_pad, nf_pad,
                    real_dtype, complex_dtype, batched_beams, fluxes_arr,
                    bl_index_arr, flipped_global, program_config=cfg,
                )
            return run, inputs

        # Deferred assembly must not read USER-owned arrays at result()
        # time: an async caller may mutate beam_coefs in place for the next
        # dispatch (a pattern the content-keyed caches support for sync
        # calls), which would contract this sim's output with the next
        # sim's coefficients. Snapshot at dispatch; engine-derived captures
        # (pair_plan, index arrays) are immutable cached objects.
        coefs_snap = (
            np.array(beam_coefs, copy=True)
            if async_fetch and beam_coefs is not None
            else beam_coefs
        )

        def _assemble(stacked):
            return self._assemble_output(
                stacked, use_ds, use_basis, ntimes, nfreqs, npairs, nfeeds,
                nbl, flipped_global, pair_plan, coefs_snap,
                ant1_idx if use_basis else None,
                ant2_idx if use_basis else None, *cfg_pairs(cfg),
                complex_dtype, polarized, trace_mem,
            )

        if async_fetch:
            return VisibilityFuture(run(*inputs), _assemble)
        return _assemble(np.asarray(run(*inputs)))

    # ------------------------------------------------------------------
    @staticmethod
    def _program_info(
        ntimes, nfreqs, polarized, nfeeds, use_ds, use_basis, polarized_sky,
        src_keep, band_perm, nsrc_pad, nf_pad, real_dtype, complex_dtype,
        batched_beams, fluxes_arr, bl_index_arr, flipped_global,
        program_config=None,
    ) -> dict:
        """Metadata accompanying ``return_program="full"``.

        Describes how the jitted program's input tuple relates to the
        user-level arguments, so a caller (``fftvis_tpu.autodiff``) can
        re-derive the coherency input from fluxes inside a traced function
        and differentiate end to end. Input tuple layout (both the
        single-process and multi-process paths):

            (mats, abvel, eq, coherency, valid, freqs, beam_table[, band...])
        """
        return {
            "ntimes": ntimes,
            "nfreqs": nfreqs,
            "polarized": polarized,
            "nfeeds": nfeeds,
            "use_ds": use_ds,
            "use_basis": use_basis,
            "polarized_sky": polarized_sky,
            "src_keep": src_keep,
            "band_perm": band_perm,
            "nsrc_pad": nsrc_pad,
            "nf_pad": nf_pad,
            "real_dtype": real_dtype,
            "complex_dtype": complex_dtype,
            "coh_index": 3,
            "beam_table_index": 6,
            "has_beam_table": batched_beams is not None,
            "fluxes_shape": tuple(fluxes_arr.shape),
            # (nbl, 2) antenna indices (into ants-dict order) per output
            # baseline, plus the pair-routing flip mask: the differentiable
            # front-end needs both to apply per-antenna gains consistently
            # with the engine's (reference-parity) flipped-baseline feed
            # convention (conj without feed swap, ref cpu_simulate.py:298-300).
            "bl_index": np.asarray(bl_index_arr),
            "flipped": np.asarray(flipped_global, dtype=bool),
            # The full static program configuration (tpu/program.py);
            # feeds the analytic FLOP model (fftvis_tpu.flops) and any
            # caller that needs the traced path's exact shape decisions.
            "program_config": program_config,
        }

    # ------------------------------------------------------------------
    def _assemble_output(
        self, stacked, use_ds, use_basis, ntimes, nfreqs, npairs, nfeeds,
        nbl, flipped_global, pair_plan, beam_coefs, ant1_idx, ant2_idx,
        pair_i, pair_j, complex_dtype, polarized, trace_mem,
    ):
        """Host-side assembly of the fetched program output."""
        if use_ds:
            # (2 reim, 2 hilo, nt, nf, C, nbl): combine the DS planes in
            # float64 on the host -- hi + lo would collapse back to f32 on
            # device -- then flip-conjugate, route pairs / contract
            # eigenbeam coefficients, and apply the reference's feed
            # transpose (ref cpu_simulate.py:298-300), all in float64.
            # Output is complex128, honoring the precision=2 contract as
            # far as the f32 beam/flux inputs allow (~1e-7).
            v = (
                stacked[0, 0].astype(np.float64) + stacked[0, 1]
            ) + 1j * (stacked[1, 0].astype(np.float64) + stacked[1, 1])
            v = v[:ntimes, :nfreqs]  # (nt, nf, C, nbl)
            v = np.where(flipped_global[None, None, None, :], np.conj(v), v)
            per_pair = v.reshape(ntimes, nfreqs, npairs, nfeeds, nfeeds, nbl)
            if use_basis:
                coefs = np.asarray(beam_coefs, dtype=np.complex128)
                c1 = np.conj(coefs[ant1_idx])  # (nbl, K, nfreq)
                c2 = coefs[ant2_idx]
                w_kl = c1[:, pair_i, :] * c2[:, pair_j, :]  # (nbl, P, nf)
                offd = (pair_i != pair_j).astype(np.complex128)
                w_lk = (c1[:, pair_j, :] * c2[:, pair_i, :]) * offd[None, :, None]
                vis = np.einsum("bpF,TFpfgb->TFbgf", w_kl, per_pair)
                vis = vis + np.einsum("bpF,TFpfgb->TFbfg", w_lk, per_pair)
            elif npairs == 1:
                vis = np.transpose(per_pair[:, :, 0], (0, 1, 4, 3, 2))
            else:
                vis = np.empty(
                    (ntimes, nfreqs, nbl, nfeeds, nfeeds), np.complex128
                )
                for p in range(npairs):
                    sel = np.asarray(pair_plan.bls_idxs[p], dtype=np.int64)
                    vis[:, :, sel] = np.transpose(
                        per_pair[:, :, p][..., sel], (0, 1, 4, 3, 2)
                    )
            complex_out = np.complex128
        else:
            vis = (stacked[0] + 1j * stacked[1])[:ntimes, :nfreqs]
            complex_out = complex_dtype

        if trace_mem:
            # The device analogue of the reference's per-worker memray
            # tracker (ref cpu_simulate.py:900-901): a device memory profile.
            from ..profiling import save_device_memory_profile

            try:
                save_device_memory_profile(f"fftvis-devmem-{id(self):x}.prof")
            except Exception as err:  # pragma: no cover
                logger.info("device memory profile unavailable: %s", err)

        # Reference output layout (ref cpu_simulate.py:849-854):
        # polarized (nfreq, nt, nfeeds, nfeeds, nbl), else (nfreq, nt, nbl).
        vis = np.transpose(vis, (1, 0, 3, 4, 2))
        # The astype copy is deliberate even at matching dtype: it returns
        # a C-contiguous array that does NOT pin the (time/freq-padded)
        # combine buffer -- a copy=False transpose view would keep up to
        # nt_pad/nt times the output bytes alive and change the public
        # contiguity contract for a few ms of host time.
        if polarized:
            return vis.astype(complex_out)
        return vis[:, :, 0, 0, :].astype(complex_out)

    # ------------------------------------------------------------------
    # Host planning (tpu/planning.py); thin delegates keep the historical
    # method names used by tests and downstream callers.
    def _plan_tile_classes(
        self, plan, rot, freqs, ty: int, sx: int, cap: int, pad_sources: int
    ):
        return _planning.plan_tile_classes(
            plan, rot, freqs, ty, sx, cap, pad_sources
        )

    def _plan_transform(
        self,
        ants,
        baselines,
        freqs,
        eps,
        upsample_factor,
        flat_array_tol,
        force_use_type3,
        flipped_global,
        nbl,
        nsrc,
        nfeeds,
        npairs,
        mode_override: str | None = None,
    ) -> _SimPlan:
        return _planning.plan_transform(
            self.nufft_mode, ants, baselines, freqs, eps, upsample_factor,
            flat_array_tol, force_use_type3, flipped_global, nbl, nsrc,
            nfeeds, npairs, mode_override=mode_override,
        )

    def _select_gridded_path(
        self, bls_signed, eps, upsample_factor, nsrc, nbl, n_modes, npairs,
        nfeeds, nufft_mode=None,
    ):
        return _planning.select_gridded_path(
            nufft_mode or self.nufft_mode, bls_signed, eps, upsample_factor,
            nsrc, nbl, n_modes, npairs, nfeeds,
        )


def cfg_pairs(cfg: ProgramConfig) -> tuple[np.ndarray, np.ndarray]:
    """Pair-channel (i, j) index arrays of a program config (assembly
    order)."""
    pairs_arr = np.asarray(
        cfg.kl_pairs if cfg.use_basis else list(cfg.pair_plan.pairs),
        dtype=np.int64,
    ).reshape(-1, 2)
    return pairs_arr[:, 0], pairs_arr[:, 1]


# inspect.signature follows __wrapped__: keep the public simulate signature
# introspectable through the consistent-inputs window wrapper.
TPUSimulationEngine.simulate.__wrapped__ = TPUSimulationEngine._simulate_impl
