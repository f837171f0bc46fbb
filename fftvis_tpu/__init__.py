"""fftvis-tpu: a JAX interferometric visibility simulator.

A from-scratch JAX/XLA framework with the capabilities of fftvis
(tyler-a-cox/fftvis): NUFFT-accelerated visibility simulation from point
sources or pixelized skies, with analytic / tabulated / per-antenna /
eigenbeam primary beams, polarized or unpolarized, on one NVIDIA GPU or
sharded over a mesh of them.
"""

import logging as _logging
import os as _os

# Cache directory when JAX_COMPILATION_CACHE_DIR is not set: a fixed path
# at the checkout root (the path is part of the cache key).
COMPILE_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache",
)


def _enable_compile_cache() -> None:
    """Persistent XLA compilation cache (disable: FFTVIS_NO_COMPILE_CACHE=1).

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and the
    package sets no directory; otherwise the cache is
    :data:`COMPILE_CACHE_DIR`. A failure to enable it is logged.
    """
    if _os.environ.get("FFTVIS_NO_COMPILE_CACHE") or _os.environ.get(
        "JAX_COMPILATION_CACHE_DIR"
    ):
        return
    try:
        import jax

        _os.makedirs(COMPILE_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except Exception:
        _logging.getLogger(__name__).warning(
            "persistent compilation cache not enabled at %s",
            COMPILE_CACHE_DIR, exc_info=True,
        )


_enable_compile_cache()

from . import beams, coords, geometry, nufft, parallel
from .autodiff import build_differentiable_direct_sim, build_differentiable_sim
from .checkpoint import simulate_vis_checkpointed
from .core.beam_basis import compute_beam_basis
from .core.simulate import SimulationEngine, default_accuracy_dict
from .coords import TelescopeLocation
from .reference.direct_engine import DirectSimulationEngine
from .tpu.beams import TPUBeamEvaluator
from .tpu.engine import TPUSimulationEngine, VisibilityFuture
from .wrapper import create_beam_evaluator, create_simulation_engine, simulate_vis

__version__ = "0.5.0"

__all__ = [
    "simulate_vis",
    "simulate_vis_checkpointed",
    "build_differentiable_sim",
    "build_differentiable_direct_sim",
    "create_simulation_engine",
    "create_beam_evaluator",
    "compute_beam_basis",
    "SimulationEngine",
    "TPUSimulationEngine",
    "VisibilityFuture",
    "DirectSimulationEngine",
    "TPUBeamEvaluator",
    "TelescopeLocation",
    "default_accuracy_dict",
    "beams",
    "coords",
    "geometry",
    "nufft",
    "parallel",
]
