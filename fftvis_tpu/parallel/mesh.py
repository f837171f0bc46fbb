"""Device-mesh parallelism for visibility simulation.

SPMD replacement for the reference's Ray process fan-out + plasma
shared-memory object store (ref /root/reference/src/fftvis/cpu/
cpu_simulate.py:714-837): instead of serializing inputs into a host object
store and stitching per-process results, the simulation is ONE SPMD program
over a jax.sharding.Mesh --

  - the ``time`` axis is data-parallel (each device owns a block of
    integration times; the analogue of the reference's freq x time
    ``get_task_chunks`` fan-out, ref core/utils.py:122-187);
  - the ``source`` axis shards giant skies; each shard spreads its sources
    onto a local NUFFT fine grid and a single ``psum`` (NVLink on one host) reduces the
    grids before the FFT (SURVEY section 5's natural all-reduce point).

Multi-host clusters: call :func:`init_distributed` before building the
mesh; device order from ``jax.devices()`` then spans hosts, the engine
ships inputs as global arrays, and the output is allgathered on every
host (tested with a two-process forced-CPU-device rig in
tests/test_multihost.py).
"""

from __future__ import annotations

import numpy as np


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
):
    """Initialize the multi-process runtime before building a mesh.

    Replacement for the reference's Ray cluster bring-up (ref
    cpu_simulate.py:714-769): after this, ``jax.devices()`` spans every
    process's devices (GPUs across hosts; forced-CPU-device test rigs over
    TCP), :func:`make_mesh` lays mesh axes across them, and
    ``TPUSimulationEngine`` ships inputs as global arrays and allgathers
    the output on every host (engine ``multiproc`` path).

    Pass ``coordinator_address`` ("host:port" of process 0),
    ``num_processes``, and this process's ``process_id`` unless the
    cluster environment lets JAX detect them. Idempotent:
    re-initialization is a no-op.
    """
    import jax

    if jax.distributed.is_initialized():
        return  # idempotent
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def make_mesh(time: int = 1, source: int = 1, freq: int = 1, devices=None):
    """Build a (time, freq, source) mesh over the available devices.

    ``time * freq * source`` must not exceed (and will use exactly that many
    of) the available devices. Axes of size 1 still appear in the mesh but
    carry no sharding.
    """
    import jax
    from jax.sharding import Mesh

    if devices is None:
        devices = jax.devices()
    need = time * source * freq
    if need > len(devices):
        raise ValueError(
            f"mesh ({time} time x {freq} freq x {source} source = {need}) "
            f"exceeds {len(devices)} available devices"
        )
    arr = np.asarray(devices[:need]).reshape(time, freq, source)
    return Mesh(arr, axis_names=("time", "freq", "source"))


def auto_mesh(
    n_devices: int | None = None,
    prefer_time: bool = True,
    ntimes: int | None = None,
    nfreqs: int | None = None,
):
    """Factor the device count into a mesh.

    With the workload dimensions given, the reference's freq x time task
    partitioner (``get_task_chunks``, ref core/utils.py:122-187) chooses
    the (time, freq) axis split -- each of its per-process blocks maps to
    one device. Otherwise: times are the cheapest axis to scale (fully
    independent blocks), so all devices go to ``time``; set
    ``prefer_time=False`` to split evenly for source-heavy problems.
    """
    import jax

    n = n_devices or len(jax.devices())
    if ntimes is not None and nfreqs is not None and n > 1:
        from ..core.utils import get_task_chunks

        nproc, _, _, nf, _ = get_task_chunks(n, nfreqs, ntimes)
        if nproc > 1:
            # Axes never exceed the workload dims: a time axis above
            # ntimes pads identity-rotation throwaway work onto whole
            # devices (the engine slices it off, but the FLOPs are spent).
            nfc = min(max(1, int(np.ceil(nfreqs / nf))), n, max(nfreqs, 1))
            ntc = min(max(1, n // nfc), max(ntimes, 1))
            return make_mesh(time=ntc, freq=nfc)
        # The partitioner's 2x-tasks rule models per-PROCESS overhead; an
        # SPMD mesh has none, so small workloads still shard over time
        # (capped at ntimes) rather than running on one device.
        return make_mesh(time=min(n, max(ntimes, 1)))
    if prefer_time:
        return make_mesh(time=n, source=1)
    t = int(np.floor(np.sqrt(n)))
    while n % t:
        t -= 1
    return make_mesh(time=t, source=n // t)


def simulate_vis_sharded(*args, mesh=None, **kwargs):
    """``simulate_vis`` over a device mesh (see :func:`make_mesh`).

    Accepts every ``fftvis_tpu.simulate_vis`` argument; ``mesh`` defaults
    to an :func:`auto_mesh` over all devices, shaped by the workload's
    (ntimes, nfreqs) when those are inferable from the arguments.
    """
    from ..wrapper import simulate_vis

    if mesh is None:
        ntimes = nfreqs = None
        try:
            from ..coords.erfa_lite import times_to_jd

            if kwargs.get("times") is not None:
                ntimes = int(times_to_jd(kwargs["times"]).size)
            if kwargs.get("freqs") is not None:
                nfreqs = int(np.atleast_1d(kwargs["freqs"]).size)
        except Exception:  # pragma: no cover - exotic time types
            pass
        mesh = auto_mesh(ntimes=ntimes, nfreqs=nfreqs)
    return simulate_vis(*args, backend="tpu", mesh=mesh, **kwargs)
