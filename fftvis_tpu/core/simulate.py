"""Simulation engine abstraction.

Parity target: /root/reference/src/fftvis/core/simulate.py (SimulationEngine
ABC :22, default_accuracy_dict :16-19). The abstract surface is the same two
methods; the chunking contract differs because here "a chunk" is a
statically-shaped jitted block over (times x freqs), not a Ray task.
"""

from __future__ import annotations

import logging
from abc import ABC, abstractmethod
from typing import Literal

import numpy as np

logger = logging.getLogger(__name__)

# Default NUFFT accuracy per precision level {1: fp32, 2: fp64}
# (ref core/simulate.py:16-19).
default_accuracy_dict = {1: 6e-8, 2: 1e-13}


class SimulationEngine(ABC):
    """Abstract visibility simulation engine.

    Concrete engines: :class:`fftvis_tpu.tpu.engine.TPUSimulationEngine`
    (the JAX/XLA production path) and
    :class:`fftvis_tpu.reference.direct_engine.DirectSimulationEngine`
    (the in-repo exact oracle, standing in for matvis in the reference's
    cross-validation test pattern).
    """

    @abstractmethod
    def simulate(
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
        upsample_factor: Literal[1.25, 2] | None = None,
        beam_spline_opts: dict | None = None,
        flat_array_tol: float = 1e-6,
        interpolation_function: str = "az_za_map_coordinates",
        nprocesses: int | None = 1,
        nthreads: int | None = None,
        coord_method: str = "CoordinateRotationERFA",
        coord_method_params: dict | None = None,
        force_use_ray: bool = False,
        force_use_type3: bool = False,
        trace_mem: bool = False,
        enable_memory_monitor: bool = False,
        nchunks: int = 1,
        source_buffer: float = 1.0,
        beam_coefs: np.ndarray | None = None,
    ) -> np.ndarray:
        """Simulate visibilities.

        Returns (nfreqs, ntimes, nbls) complex for unpolarized simulations or
        (nfreqs, ntimes, 2, 2, nbls) for polarized ones, matching the
        reference output contract (ref cpu_simulate.py:849-854).
        """

    def _evaluate_vis_chunk(self, *args, **kwargs):  # pragma: no cover
        """Reference-API compatibility hook.

        The reference fans chunks out to Ray workers
        (ref core/simulate.py:147-221); the JAX engine instead compiles one
        program per (time-block x freq) and shards it over the device mesh,
        so per-chunk evaluation is not part of the public contract here.
        """
        raise NotImplementedError(
            "JAX engines evaluate jitted blocks, not host-side chunks."
        )


def resolve_precision(precision: int):
    """Map the API precision level to usable dtypes on the current backend.

    precision 2 = float64/complex128 when running on CPU with x64 enabled
    (tests, oracle). On an accelerator the engine computes in
    float32/complex64 either way (an fp64 engine on the GPU is not built
    yet) -- the type-3 transform keeps phases accurate by centering
    coordinate ranges before any large product is formed.
    """
    import jax

    if precision not in (1, 2):
        raise ValueError("precision must be 1 or 2")
    if precision == 1:
        return np.float32, np.complex64
    x64 = jax.config.jax_enable_x64
    platform = jax.default_backend()
    if x64 and platform == "cpu":
        return np.float64, np.complex128
    _warn_precision_degraded(platform, x64)
    return np.float32, np.complex64


_precision_warned = False


def _warn_precision_degraded(platform: str, x64: bool) -> None:
    """One-time notice that precision=2 resolves to fp32 on this backend.

    Reference users requesting fp64 (default eps 1e-13) would otherwise get
    ~1e-6-level results with no runtime signal (advisor round-1 finding)."""
    global _precision_warned
    if _precision_warned:
        return
    _precision_warned = True
    reason = (
        "the engine's accelerator path computes in fp32"
        if platform != "cpu"
        else "jax x64 mode is disabled"
    )
    logger.warning(
        "precision=2 degrades to float32/complex64 on this backend (%s; %s): "
        "NUFFT eps is floored to ~5e-7 and results are accurate to ~1e-6 "
        "relative, not the fp64 default 1e-13. For fp64-class phase/"
        "accumulation accuracy, request eps below 5e-7 explicitly (e.g. "
        "eps=1e-10) or set FFTVIS_DS=1: the engine then runs the exact "
        "direct path with compensated double-single arithmetic "
        "(complex128 output, ~1e-6..1e-7 end to end, f32-beam-limited).",
        platform,
        reason,
    )
