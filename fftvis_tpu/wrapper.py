"""Public API: ``simulate_vis`` and engine/evaluator factories.

Signature and semantics preserve the reference's matvis-compatible wrapper
(ref /root/reference/src/fftvis/wrapper.py:85-336): same parameter names,
same default-eps-per-precision rule, same beam normalization steps
(frequency pre-interpolation, power-beam conversion for unpolarized sims,
beam_idx/beam_coefs validation with identical error messages), and the same
output shapes. Backend selection maps onto this framework's engines:

    "tpu" (default) / "gpu" / "cpu"
                -> TPUSimulationEngine (JAX: runs on the device JAX
                   selects, an NVIDIA GPU when one is present; every name
                   is kept for drop-in compatibility with reference calls)
    "direct"    -> DirectSimulationEngine (exact oracle)
"""

from __future__ import annotations

import logging
from typing import TYPE_CHECKING, Literal

import numpy as np

from .beams.interface import BeamInterface, prepare_beam_unpolarized
from .core.simulate import SimulationEngine, default_accuracy_dict
from .core.utils import get_desired_chunks, validate_beam_idx

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .tpu.engine import VisibilityFuture

logger = logging.getLogger(__name__)

# Backend names that select the JAX engine (it runs on whatever device JAX
# selects); all three are accepted for drop-in compatibility.
JAX_BACKENDS = ("tpu", "gpu", "cpu")


def create_beam_evaluator(backend: str = "tpu", **kwargs):
    """Create a beam evaluator for the given backend.

    (API parity: ref wrapper.py:16-48.)
    """
    if backend in JAX_BACKENDS:
        from .tpu.beams import TPUBeamEvaluator

        evaluator = TPUBeamEvaluator(**kwargs)
        evaluator.beam_list = []
        evaluator.beam_idx = None
        return evaluator
    raise ValueError(f"Unsupported backend: {backend}")


def create_simulation_engine(backend: str = "tpu", **kwargs) -> SimulationEngine:
    """Create a simulation engine for the given backend.

    (API parity: ref wrapper.py:51-82.)
    """
    if backend in JAX_BACKENDS:
        from .tpu.engine import TPUSimulationEngine

        return TPUSimulationEngine(**kwargs)
    if backend == "direct":
        from .reference.direct_engine import DirectSimulationEngine

        return DirectSimulationEngine(**kwargs)
    raise ValueError(f"Unsupported backend: {backend}")


def prepare_beam_list(
    beam, freqs, polarized, beam_coefs, use_feed, nant, beam_idx
):
    """Normalize user beams into a validated ``BeamInterface`` list.

    The wrapper-level beam preparation (ref wrapper.py:247-283): wrap in
    BeamInterface, pre-interpolate tabulated beams to the simulation
    frequencies, convert to power beams for unpolarized sims, and validate
    ``beam_idx``/``beam_coefs``. Shared by :func:`simulate_vis` and the
    differentiable front-end (``fftvis_tpu.autodiff``).
    """
    _beam_list = beam if isinstance(beam, list) else [beam]
    nbeam = len(_beam_list)
    beam_idx = validate_beam_idx(beam_idx, beam_coefs, nbeam, nant)

    beam_list = []
    for bm in _beam_list:
        bi = bm if isinstance(bm, BeamInterface) else BeamInterface(bm)
        # Pre-interpolate tabulated beams onto the simulation frequencies
        # once, up front (ref wrapper.py:264-269).
        if bi._isuvbeam and bi.beam.Nfreqs > 1:
            bi = BeamInterface(bi.beam.interp_freq(freqs), beam_type=bi.beam_type)

        if not polarized and beam_coefs is None:
            bi = prepare_beam_unpolarized(bi, use_feed=use_feed)
        elif not polarized and beam_coefs is not None:
            raise ValueError(
                "Basis decomposition is not compatible with unpolarized "
                "simulations. Set polarized=True to use beam_coefs."
            )
        beam_list.append(bi)
    return beam_list, beam_idx


def simulate_vis(
    ants: dict,
    fluxes: np.ndarray,
    ra: np.ndarray,
    dec: np.ndarray,
    freqs: np.ndarray,
    times,
    beam,
    telescope_loc,
    beam_idx: np.ndarray = None,
    baselines: list[tuple] = None,
    precision: int = 2,
    polarized: bool = False,
    eps: float = None,
    upsample_factor: Literal[1.25, 2] | None = None,
    beam_spline_opts: dict = None,
    use_feed: str = "x",
    flat_array_tol: float = 1e-6,
    interpolation_function: str = "az_za_map_coordinates",
    nprocesses: int | None = 1,
    nthreads: int | None = None,
    coord_method: str = "CoordinateRotationERFA",
    coord_method_params: dict | None = None,
    force_use_type3: bool = False,
    force_use_ray: bool = False,
    trace_mem: bool = False,
    backend: str = "tpu",
    max_memory: int | float = np.inf,
    min_chunks: int = 1,
    source_buffer: float = 1.0,
    beam_coefs: np.ndarray = None,
    mesh=None,
    async_fetch: bool = False,
) -> np.ndarray | VisibilityFuture:
    """Simulate interferometric visibilities.

    Parameters mirror the reference exactly (ref wrapper.py:85-233); see
    that docstring's semantics. Summary of the essentials:

    ants
        {antenna: (x, y, z) ENU position in meters}.
    fluxes
        (nsrc, nfreq) Stokes-I, or (nsrc, nfreq, 4) full Stokes (requires
        ``polarized=True``). Stokes I is split between the two linear
        polarizations (factor 0.5).
    ra, dec
        ICRS source positions, radians.
    freqs, times
        Hz; Julian dates (array) or an astropy-Time-like object.
    beam
        One beam (shared by all antennas), or a list of beams with
        ``beam_idx``, or eigenbeam bases with ``beam_coefs``.
    telescope_loc
        TelescopeLocation, EarthLocation-like, or (lat, lon[, height]) in
        radians/meters.
    baselines
        Optional (ai, aj) pairs; defaults to one representative per
        redundant group including autos.
    precision
        1 -> float32/complex64; 2 -> float64/complex128 on the CPU with
        jax x64 enabled; on the GPU the engine computes in fp32 either way.
    polarized
        If True the output carries the 2x2 feed matrix.
    eps
        NUFFT accuracy; default 6e-8 (precision 1) / 1e-13 (precision 2).
    upsample_factor
        NUFFT fine-grid oversampling sigma, 1.25 or 2 (reference parity,
        ref wrapper.py:99); None (the default) means 2. sigma=1.25
        shrinks the fine grid 2.6x, but on f32 pipelines its accuracy is
        config-dependent
        (up to ~5e-4 relative, from kernel/deconvolution dynamic range
        at the narrower band) -- use it only when that error class is
        acceptable or on fp64 backends.
    async_fetch
        If True, return a ``VisibilityFuture`` immediately after the
        device program is dispatched and its device-to-host copy started;
        call ``.result()`` (or ``np.asarray``) to collect. Issuing several
        simulations before collecting pipelines their output transfers
        behind each other's compute and dispatch.

    Notes
    -----
    **Automatic eigenbeam rank compression (auto-rank).** Polarized sims
    with per-antenna beam lists (>= 8 distinct beam pairs, fp32-class
    ``eps``) are automatically screened for low-rank structure: when an
    SVD of the stacked beam tables reaches a residual of ``eps / 8`` at
    rank K with a >= 2x channel-count reduction, the engine substitutes K
    eigenbeams plus per-antenna coefficients (an exact contraction of the
    compressed family). The substitution changes answers only within the
    ``eps / 8`` residual bound -- inside the accuracy already requested
    via ``eps`` -- and logs at INFO when it engages. Set the environment
    variable ``FFTVIS_AUTO_RANK=0`` to disable it. See ``docs/api.md``.

    Returns
    -------
    np.ndarray
        (nfreqs, ntimes, nbls) complex, or (nfreqs, ntimes, 2, 2, nbls)
        when polarized. With ``async_fetch=True``, a ``VisibilityFuture``
        resolving to that array.
    """
    if eps is None:
        eps = default_accuracy_dict[precision]

    ants = {k: np.asarray(v) for k, v in ants.items()}

    nant = len(ants)
    freqs = np.atleast_1d(np.asarray(freqs, dtype=float))
    beam_list, beam_idx = prepare_beam_list(
        beam, freqs, polarized, beam_coefs, use_feed, nant, beam_idx
    )

    nax = nfeed = 2 if polarized else 1

    # Source chunking from the memory model. On accelerators the budget is
    # device HBM rather than host RAM (ref wrapper.py:292-302 uses psutil).
    nchunks, _ = get_desired_chunks(
        min(max_memory, _available_memory()),
        min_chunks,
        [b.beam for b in beam_list],
        nax,
        nfeed,
        nant,
        len(fluxes),
        precision,
        source_buffer=source_buffer,
    )

    # Honor the reference's nprocesses knob in spirit: with no explicit mesh
    # and several devices available, parallelize times across a device mesh
    # (the reference fans freq x time chunks out to that many processes;
    # ref wrapper.py:188-191, cpu_simulate.py:711-714).
    if (
        mesh is None
        and backend in JAX_BACKENDS
        and nprocesses is not None
        and nprocesses > 1
    ):
        try:
            import jax

            ndev = len(jax.devices())
            # Cap the time axis at ntimes: a larger mesh only pads the time
            # axis and burns devices on throwaway work.
            from .coords.erfa_lite import times_to_jd

            ntimes_here = int(times_to_jd(times).size)
            nfreqs_here = int(np.atleast_1d(freqs).size)
            n_use = min(int(nprocesses), ndev)
            if ndev > 1 and n_use > 1:
                from .parallel.mesh import auto_mesh

                # The reference's nprocesses fans freq x time chunks out to
                # that many workers (get_task_chunks); auto_mesh applies
                # the same partitioner to pick the (time, freq) axis split.
                mesh = auto_mesh(
                    n_use, ntimes=ntimes_here, nfreqs=nfreqs_here
                )
                if mesh.devices.size <= 1:
                    mesh = None  # workload too small to shard
                else:
                    logger.info(
                        "nprocesses=%d mapped to a (%d time x %d freq) "
                        "device mesh (%d devices available, %d times x %d "
                        "freqs)",
                        nprocesses, mesh.shape["time"], mesh.shape["freq"],
                        ndev, ntimes_here, nfreqs_here,
                    )
        except Exception:  # pragma: no cover
            logger.warning(
                "nprocesses=%d requested but device-mesh construction "
                "failed; running unsharded", nprocesses, exc_info=True,
            )
            mesh = None

    engine_kwargs = {}
    if mesh is not None:
        if backend not in JAX_BACKENDS:
            raise ValueError("mesh sharding requires the JAX engine backend")
        engine_kwargs["mesh"] = mesh
    engine = create_simulation_engine(backend=backend, **engine_kwargs)

    sim_kwargs = dict(
        ants=ants,
        freqs=freqs,
        fluxes=np.asarray(fluxes),
        beam_list=beam_list,
        beam_idx=beam_idx,
        ra=np.asarray(ra, dtype=float),
        dec=np.asarray(dec, dtype=float),
        times=times,
        telescope_loc=telescope_loc,
        baselines=baselines,
        precision=precision,
        polarized=polarized,
        eps=eps,
        upsample_factor=upsample_factor,
        beam_spline_opts=beam_spline_opts,
        flat_array_tol=flat_array_tol,
        interpolation_function=interpolation_function,
        nprocesses=nprocesses,
        nthreads=nthreads,
        coord_method=coord_method,
        coord_method_params=coord_method_params,
        force_use_type3=force_use_type3,
        force_use_ray=force_use_ray,
        trace_mem=trace_mem,
        nchunks=nchunks,
        source_buffer=source_buffer,
        beam_coefs=beam_coefs,
    )
    if async_fetch:
        from .tpu.engine import TPUSimulationEngine, VisibilityFuture

        if isinstance(engine, TPUSimulationEngine):
            return engine.simulate(async_fetch=True, **sim_kwargs)
        # Backends without a deferred-fetch path run synchronously and
        # hand back an already-resolved future (uniform caller type).
        return VisibilityFuture.from_result(engine.simulate(**sim_kwargs))
    return engine.simulate(**sim_kwargs)


def _available_memory() -> float:
    """Device-or-host memory budget in bytes."""
    try:
        import jax

        dev = jax.devices()[0]
        stats = dev.memory_stats()
        if stats and "bytes_limit" in stats:
            return float(stats["bytes_limit"] - stats.get("bytes_in_use", 0))
    except Exception:
        pass
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemAvailable"):
                    return float(line.split()[1]) * 1024.0
    except OSError:  # pragma: no cover
        pass
    return 8 * 1024**3  # pragma: no cover
