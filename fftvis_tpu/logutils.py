"""Memory reporting and progress logging.

Parity target: /root/reference/src/fftvis/logutils.py (RSS/shared reporting,
tracemalloc peaks, per-integration ETA logging), extended with device
memory statistics from the JAX runtime -- the quantity that actually matters
on the GPU.
"""

from __future__ import annotations

import logging
import time
import tracemalloc

logger = logging.getLogger(__name__)


def human_readable_size(size: float, decimal_places: int = 2) -> str:
    """Bytes -> '12.34 MB' style string."""
    for unit in ["B", "KB", "MB", "GB", "TB", "PB"]:
        if size < 1024.0 or unit == "PB":
            break
        size /= 1024.0
    return f"{size:.{decimal_places}f} {unit}"


def host_memory() -> dict:
    """Host RSS/available memory in bytes (psutil-free)."""
    out = {}
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS"):
                    out["rss"] = int(line.split()[1]) * 1024
    except OSError:  # pragma: no cover
        pass
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemAvailable"):
                    out["available"] = int(line.split()[1]) * 1024
    except OSError:  # pragma: no cover
        pass
    return out


def device_memory() -> dict:
    """Per-device HBM stats from the JAX runtime (empty if unsupported)."""
    try:
        import jax

        stats = {}
        for d in jax.devices():
            s = d.memory_stats()
            if s:
                stats[str(d)] = {
                    "in_use": s.get("bytes_in_use"),
                    "limit": s.get("bytes_limit"),
                }
        return stats
    except Exception:  # pragma: no cover
        return {}


def printmem(pr=None, msg: str = "") -> None:
    """Log current host + device memory usage."""
    host = host_memory()
    parts = [msg]
    if "rss" in host:
        parts.append(f"host rss={human_readable_size(host['rss'])}")
    for dev, s in device_memory().items():
        if s.get("in_use") is not None:
            parts.append(f"{dev} hbm={human_readable_size(s['in_use'])}")
    logger.info(" | ".join(p for p in parts if p))


def memtrace(highest_memory: float, msg: str = "") -> float:
    """tracemalloc checkpoint: log and return the running peak (bytes)."""
    if not tracemalloc.is_tracing():
        tracemalloc.start()
    current, peak = tracemalloc.get_traced_memory()
    if peak > highest_memory:
        logger.info(
            "%s: traced current=%s peak=%s",
            msg or "memtrace",
            human_readable_size(current),
            human_readable_size(peak),
        )
        highest_memory = peak
    return highest_memory


def log_progress(start_time: float, prev_time: float, iters: int, niters: int,
                 pr=None, last_label: str = "") -> tuple[float, str]:
    """Per-iteration progress/ETA logging.

    Returns (now, label) so callers can chain. (The reference's version
    returns an undefined variable -- ref logutils.py:86; fixed here.)
    """
    now = time.time()
    dt = now - prev_time
    total = now - start_time
    eta = (niters - iters) * total / max(iters, 1)
    label = (
        f"{iters}/{niters} in {total:.1f}s (+{dt:.1f}s), eta {eta:.1f}s"
    )
    rss = host_memory().get("rss")
    if rss is not None:
        label += f", rss {human_readable_size(rss)}"
    logger.info(label)
    return now, label
