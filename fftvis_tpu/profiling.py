"""Profiling hooks: XLA traces and device memory profiles.

Device replacement for the reference's cProfile/line_profiler/memray
tracing stack (ref cli.py:109-159, cpu_simulate.py:900-901): wall-clock
profiling of a jitted program means capturing an XLA trace, and memory
tracing means device memory profiles -- both via jax.profiler.
"""

from __future__ import annotations

import contextlib
import logging
import time

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def xla_trace(logdir: str | None):
    """Capture a jax.profiler trace (viewable in TensorBoard/Perfetto).

    No-op when ``logdir`` is None.
    """
    if logdir is None:
        yield
        return
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
        logger.info("XLA trace written to %s", logdir)


def save_device_memory_profile(path: str) -> None:
    """Write a pprof-format device memory snapshot."""
    import jax

    jax.profiler.save_device_memory_profile(path)
    logger.info("Device memory profile written to %s", path)


@contextlib.contextmanager
def timed(label: str, sync: bool = True):
    """Wall-clock a block; synchronizes outstanding device work first."""
    import jax

    if sync:
        (jax.device_put(0.0) + 0).block_until_ready()
    t0 = time.perf_counter()
    yield
    if sync:
        (jax.device_put(0.0) + 0).block_until_ready()
    logger.info("%s: %.3f s", label, time.perf_counter() - t0)
