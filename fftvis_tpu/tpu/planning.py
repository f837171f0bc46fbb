"""Host-side transform planning for the simulation engine.

Everything here runs once per configuration on the host: choosing the
transform path (type-1 / type-3 / direct) from a FLOP model, building the
executor plans, and deriving the binned-spreader capacities from rigorous
sliding-window bounds over the (exactly known) rotated source coordinates.
The jitted program itself is built in :mod:`fftvis_tpu.tpu.program`.

Structural counterpart of the reference's griddability decision and
path selection (ref /root/reference/src/fftvis/cpu/cpu_simulate.py:634-681),
re-shaped for static-shape XLA execution.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import numpy as np

from ..core import utils as core_utils
from ..core.antenna_gridding import check_antpos_griddability
from ..core.utils import speed_of_light
from ..nufft.transform import (
    Type1Executor,
    Type3Executor,
    Type3LowrankZExecutor,
    fit_plan_precorr,
    plan_type1,
    plan_type3,
    plan_type3_lowrank_z,
)

logger = logging.getLogger(__name__)

TWO_PI = 2.0 * np.pi


@dataclass
class _SimPlan:
    """Static (host-side) configuration baked into the jitted program."""

    mode: str  # 'type1' | 'type3' | 'direct'
    executor: object | None
    targets: np.ndarray | None  # direct mode: (d, nbl) signed targets
    is_coplanar: bool
    rotation_matrix: np.ndarray  # (3, 3) applied to topo for NUFFT coords
    lattice_matrix: np.ndarray | None  # type-1: basis^T (3, 3) scaled
    nsrc_pad: int = 0
    nblocks: int = 1
    block: int = 0


def plan_fingerprint(exec_plan) -> tuple:
    """Full-array fingerprint of a transform plan (repr truncates arrays)."""
    if exec_plan is None:
        return ()
    from ..nufft.transform import Type1ExactPlan, Type1Plan, Type3Plan

    if isinstance(exec_plan, Type1ExactPlan):
        return ("t1x", exec_plan.nf, exec_plan.kmax, exec_plan.gather_idx)
    k = exec_plan.kernel
    if isinstance(exec_plan, Type1Plan):
        return (
            "t1", exec_plan.nf, k.w, k.beta, k.sigma,
            exec_plan.gather_idx, exec_plan.gather_deconv,
        )
    if isinstance(exec_plan, Type3Plan):
        return (
            "t3", exec_plan.nf, k.w, k.beta, k.sigma,
            exec_plan.h, exec_plan.ds, exec_plan.s_center,
            tuple(exec_plan.deconv),
            tuple(exec_plan.tap_idx), tuple(exec_plan.tap_val),
            tuple(exec_plan.ft_xi_max),
        )
    return (repr(exec_plan),)


def zplan_fingerprint(executor) -> tuple:
    """Fingerprint of a lowrank-z executor's z configuration (if any)."""
    zp = getattr(executor, "zplan", None)
    if zp is None:
        return ()
    return (
        "lrz", zp.K, zp.s_center_z, zp.x_center_z, zp.x_half_z, zp.g,
    )


def sim_plan_fingerprint(plan: _SimPlan) -> tuple:
    """Every static ingredient of a ``_SimPlan`` that shapes the traced
    program: path mode, geometry matrices, blocking, the executor's plan
    tables and its (mutable, per-call) strip/tile configuration."""
    return (
        plan.mode,
        plan.is_coplanar,
        plan.nsrc_pad,
        plan.nblocks,
        plan.block,
        plan.rotation_matrix,
        plan.lattice_matrix,
        plan.targets,
        plan_fingerprint(getattr(plan.executor, "plan", None)),
        zplan_fingerprint(plan.executor),
        getattr(plan.executor, "strip_config", None),
        getattr(plan.executor, "tile_config", None),
    )


_MEMORY_LIMIT_CACHE: list = []
# Working-set budget on the CPU test backend (bytes).
HOST_MEMORY_BUDGET = 16 * 1024**3


def device_memory_limit() -> int:
    """Memory budget of the default device in bytes (cached).

    Working-set budgets (direct-path scan footprint, freq-vmap threshold)
    scale with the device. On the GPU this is the allocator's
    ``bytes_limit`` (the share of the card JAX reserved); a GPU that does
    not report it is an error, not a guess. The CPU test backend reports
    no limit, so it gets a fixed host budget, which only shapes blocking.
    """
    if _MEMORY_LIMIT_CACHE:
        return _MEMORY_LIMIT_CACHE[0]
    import jax

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        limit = HOST_MEMORY_BUDGET
    else:
        stats = dev.memory_stats() or {}
        if not stats.get("bytes_limit"):
            raise RuntimeError(
                f"device {dev.device_kind!r} reports no memory bytes_limit"
            )
        limit = int(stats["bytes_limit"])
    _MEMORY_LIMIT_CACHE.append(limit)
    return limit


def ds_coords_default() -> bool:
    """Whether the fp32 NUFFT coordinates default to double-single
    arithmetic: on the GPU, off on the CPU test backend.

    On the CPU, XLA's fusion duplicates the error-free transforms'
    subexpressions with one-ulp differences, leaving f32 accuracy with
    extra rounding steps (``FFTVIS_DS_COORDS=1`` forces them on there for
    mechanics tests).
    """
    import jax

    return jax.default_backend() == "gpu"


def type3_compact_ok(plan) -> bool:
    """Whether type-3 spread cost is occupancy-proportional, making
    banding-by-compaction a pure win.

    True for every spreader but the capacity-planned strip/tiled XLA
    scans: their per-call cost is the static capacity, and their host-side
    occupancy bounds assume calls of one source block (a compacted
    mega-block could exceed the per-tile capacity clamp and silently drop
    sources).
    """
    ex = plan.executor
    if ex is None or getattr(ex, "plan", None) is None:
        return False
    return os.environ.get("FFTVIS_SPREADER", "auto") not in ("strip", "tiled")


def configure_strip_spreader(plan, rot, freqs) -> None:
    """Set binned-spreader capacities on a type-3 executor.

    Only for the capacity-planned XLA scans, which
    FFTVIS_SPREADER={tiled,strip} select: the (y, x) tiled spreader or
    the dense-in-y strip form. Capacities are rigorous bounds:
    the maximum number of sources in ANY window of one tile/strip's
    physical size (at the widest, lowest-frequency scaling), computed
    per time from the same rotation chain the device uses --
    alignment-independent, so fp32 jitter at tile edges cannot exceed
    them.
    """
    from ..nufft.transform import pick_strip_width, pick_tile_shape

    if plan.mode != "type3" or plan.executor is None:
        return
    # Never mutate a shared executor: cached plans and programs returned
    # via return_program=True close over the executor, so each simulate()
    # call gets its own instance (the underlying plan is immutable).
    plan.executor = plan.executor.fresh_copy()
    # .plan is the (inner) 2D spread plan for both Type3Executor and
    # Type3LowrankZExecutor, so the strip capacity logic below applies
    # to the 3D lowrank path unchanged.
    eplan = plan.executor.plan
    if eplan.d != 2:
        plan.executor.strip_config = None
        return
    mode_env = os.environ.get("FFTVIS_SPREADER", "auto")
    if mode_env not in ("strip", "tiled"):
        plan.executor.strip_config = None
        plan.executor.tile_config = None
        return

    scale_min = TWO_PI * float(np.min(freqs)) / speed_of_light
    # Padding sources land at one fixed location; account for them.
    # Each spread call sees one source BLOCK, so the block size caps it.
    pad_sources = max(plan.nsrc_pad - rot.nsrc, 0)

    if mode_env == "strip":
        # Legacy dense-in-y strip form (kept for comparison): 1D
        # sliding-window capacity over the axis-1 coordinates.
        strip = pick_strip_width(eplan.nf[1])
        width_hat = strip * eplan.h[1] / scale_min * 1.05
        cap = 0
        for t in range(rot.ntimes):
            topo = rot.topo_at(t)  # (3, nsrc) float64, device chain
            y = (plan.rotation_matrix @ topo)[1]
            ys = np.sort(y)
            hi = np.searchsorted(ys, ys + width_hat, side="right")
            cap = max(cap, int((hi - np.arange(ys.size)).max()))
        cap = max(16, min(cap + pad_sources + 16, plan.block))
        plan.executor.strip_config = (strip, cap)
        logger.info(
            "type-3 strip spreader: strip=%d capacity=%d (nf=%s)",
            strip, cap, eplan.nf,
        )
        return

    # Tiled spreader (the production large-grid path): 2D sliding-window
    # capacity via a half-window histogram -- any aligned (wy, wx) tile
    # is covered by a 3x3 block of half-window bins, so the max 3x3 sum
    # is a rigorous, alignment- and frequency-scaling-independent bound.
    ty, sx = pick_tile_shape(eplan.nf, eplan.kernel.w, 2)
    wy = ty * eplan.h[0] / scale_min * 1.05
    wx = sx * eplan.h[1] / scale_min * 1.05
    cap = 0
    for t in range(rot.ntimes):
        topo = rot.topo_at(t)  # (3, nsrc) float64, device chain
        xr = plan.rotation_matrix @ topo
        by = np.floor(xr[0] / (wy / 2)).astype(np.int64)
        bx = np.floor(xr[1] / (wx / 2)).astype(np.int64)
        by -= by.min()
        bx -= bx.min()
        H = np.zeros((int(by.max()) + 3, int(bx.max()) + 3), dtype=np.int64)
        np.add.at(H, (by, bx), 1)
        S = (
            H[:-2, :-2] + H[:-2, 1:-1] + H[:-2, 2:]
            + H[1:-1, :-2] + H[1:-1, 1:-1] + H[1:-1, 2:]
            + H[2:, :-2] + H[2:, 1:-1] + H[2:, 2:]
        )
        cap = max(cap, int(S.max()))
    cap = max(16, min(cap + pad_sources + 16, plan.block))
    classes = plan_tile_classes(plan, rot, freqs, ty, sx, cap, pad_sources)
    plan.executor.tile_config = (ty, sx, cap, classes)
    logger.info(
        "type-3 tiled spreader: tile=(%d, %d) capacity=%d (nf=%s)%s",
        ty, sx, cap, eplan.nf,
        ""
        if classes is None
        else " balanced classes "
        + "+".join(f"{len(i)}x{c}" for i, c in classes),
    )


def plan_tile_classes(
    plan, rot, freqs, ty: int, sx: int, cap: int, pad_sources: int
):
    """Balanced-occupancy schedule for the tiled spreader.

    Per-tile work in the tile scan is proportional to the CLASS
    capacity regardless of occupancy, and transform-space skies cluster
    hard (the sin-projection piles sources at the horizon rim), so a
    single global capacity wastes 5-20x FLOPs on near-empty tiles.
    This computes rigorous per-tile occupancy bounds by replaying the
    device's exact grid mapping (u = mod(x/h, nf), per source block,
    with a jitter margin) over every (time, freq) instance, then
    partitions tiles into <=4 capacity classes by dynamic programming.
    Returns None (single-class) when the planning cost or payoff is
    not worth it.
    """
    eplan = plan.executor.plan
    nfy, nfx = int(eplan.nf[0]), int(eplan.nf[1])
    nty, ntx = -(-nfy // ty), -(-nfx // sx)
    ntiles = nty * ntx
    n_inst = rot.ntimes * len(freqs)
    if n_inst > 1024 or ntiles < 8 or ntiles > 4096:
        return None

    delta = 4.0  # cells; covers device-fp32 vs host-fp64 jitter
    scales = TWO_PI * np.asarray(freqs, dtype=float) / speed_of_light
    # Padding sources all land at one point per instance; replay them.
    eq = rot.eq_vectors
    if pad_sources:
        pad_vec = np.zeros((3, pad_sources))
        pad_vec[2] = 1.0
        eq = np.concatenate([eq, pad_vec], axis=1)
    nsrc_pad = plan.nsrc_pad
    if eq.shape[1] < nsrc_pad:  # safety: match the device's padding
        extra = np.zeros((3, nsrc_pad - eq.shape[1]))
        extra[2] = 1.0
        eq = np.concatenate([eq, extra], axis=1)
    block = plan.block
    nchunks = nsrc_pad // block
    offsets = [(0.0, 0.0)] + [
        (dy, dx)
        for dy in (-delta, 0.0, delta)
        for dx in (-delta, 0.0, delta)
        if (dy, dx) != (0.0, 0.0)
    ]

    def _tile_ids(uy, ux, dy, dx):
        tiy = np.clip(
            np.floor(np.mod(uy + dy, nfy) / ty).astype(np.int64), 0, nty - 1
        )
        tix = np.clip(
            np.floor(np.mod(ux + dx, nfx) / sx).astype(np.int64), 0, ntx - 1
        )
        return tiy * ntx + tix

    # B[tile] = max over (time, freq, source-chunk) of (base membership
    # + margin crossings): each spread call sees ONE chunk, so the bound
    # is per chunk, maxed over instances.
    B = np.zeros(ntiles, dtype=np.int64)
    for t in range(rot.ntimes):
        # Replay the device chain (incl. aberration) so the per-tile
        # bounds are exact up to fp32 jitter; delta then only needs to
        # cover that jitter, not a resolution-dependent aberration shift.
        xr = plan.rotation_matrix @ rot.topo_at(t, eq)  # (3, nsrc_pad)
        for s in scales:
            uy = np.mod(xr[0] * s / eplan.h[0], nfy)
            ux = np.mod(xr[1] * s / eplan.h[1], nfx)
            tid_base = _tile_ids(uy, ux, 0.0, 0.0)
            tid_alts = [
                _tile_ids(uy, ux, dy, dx) for dy, dx in offsets[1:]
            ]
            for c0 in range(nchunks):
                sl = slice(c0 * block, (c0 + 1) * block)
                cnt = np.bincount(tid_base[sl], minlength=ntiles)
                for ta in tid_alts:
                    # Only boundary crossings (interior sources would
                    # otherwise count 9x into their own tile).
                    cross = ta[sl][ta[sl] != tid_base[sl]]
                    if cross.size:
                        cnt += np.bincount(cross, minlength=ntiles)
                np.maximum(B, cnt, out=B)

    occupied = np.flatnonzero(B > 0)
    if occupied.size == 0:
        return None
    B = np.minimum(B + 16, cap)  # same slack as the global capacity
    order = occupied[np.argsort(B[occupied])[::-1]]
    vals = B[order].astype(np.int64)

    # Optimal <=4-way partition of the sorted bounds minimizing
    # sum(class_size * class_cap) (class cap = its largest bound).
    # The status-quo cost is ntiles * cap with the GLOBAL
    # alignment-independent capacity -- typically several times looser
    # than these exact-mapping per-tile bounds, so even the one-class
    # schedule usually wins by excluding empty tiles and tightening cap.
    m = vals.size
    single = ntiles * int(cap)
    K = 4
    INF = float("inf")
    dp = [[INF] * (m + 1) for _ in range(K + 1)]
    cut = [[0] * (m + 1) for _ in range(K + 1)]
    for k in range(K + 1):
        dp[k][m] = 0.0
    for k in range(1, K + 1):
        for i in range(m - 1, -1, -1):
            best, bj = INF, m
            for j in range(i + 1, m + 1):
                c = (j - i) * int(vals[i]) + dp[k - 1][j]
                if c < best:
                    best, bj = c, j
            dp[k][i] = best
            cut[k][i] = bj
    if dp[K][0] * 1.3 > single:
        return None  # payoff too small to justify extra scans
    bounds_ids, i, k = [], 0, K
    while i < m and k > 0:
        j = cut[k][i]
        bounds_ids.append((order[i:j].copy(), int(vals[i])))
        i, k = j, k - 1
    return tuple(bounds_ids)


def plan_transform(
    nufft_mode: str,
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
    """Choose the transform path and build its static plan (host).

    sigma (``upsample_factor``) stays at the requested value -- DO NOT
    auto-lower it to 1.25 on f32 pipelines. The fine grid shrinks
    (2/1.25)^2 = 2.6x (the GPU speed-up is not measured), but f32
    accuracy is config-dependently destroyed: the gridded row degrades
    5.8e-6 -> 2.2e-5 (per-mode deconvolution at the |k| = nf/(2 sigma)
    band edge) and a hex-3 24h type-3 config degrades 2.3e-6 -> 5.2e-4
    (NOT rescued by DS coordinates, so it is kernel/deconv dynamic
    range, not coordinate rounding). sigma=1.25 remains available
    explicitly for fp64 pipelines and accuracy-tolerant f32 use.
    """
    nufft_mode = mode_override or nufft_mode
    antvecs = np.array([np.asarray(ants[a], dtype=float) for a in ants])
    fmax = float(np.max(freqs))

    is_gridded = False
    if (
        np.abs(antvecs[:, -1]).max() <= flat_array_tol
        and not force_use_type3
        and nufft_mode != "type3"
    ):
        is_gridded, gridded_pos, basis = check_antpos_griddability(ants)

    if is_gridded:
        bls_int = np.array(
            [gridded_pos[bj] - gridded_pos[bi] for bi, bj in baselines]
        ).T[:2]
        bls_int = np.round(bls_int).astype(np.int64)
        bls_signed = np.where(flipped_global[None, :], -bls_int, bls_int)
        # Lattice transform: source lattice coords = (basis/c)^T topo.
        lattice = (basis / speed_of_light).T
        kmax = max(int(np.max(np.abs(bls_int))), 1)
        n_modes = 2 * kmax + 1

        mode, exec_, targets = select_gridded_path(
            nufft_mode, bls_signed, eps, upsample_factor, nsrc, nbl, n_modes,
            npairs, nfeeds,
        )
        logger.info(
            "Gridded array detected: using %s path (n_modes=%d)", mode, n_modes
        )
        return _SimPlan(
            mode=mode,
            executor=exec_,
            targets=targets,
            is_coplanar=True,
            rotation_matrix=np.eye(3),
            lattice_matrix=lattice,
        )

    # Type-3 (or direct) path: rotate a tilted plane into XY.
    rotation = core_utils.get_plane_to_xy_rotation_matrix(antvecs).T
    rot_ants = (rotation @ antvecs.T).T
    pos = {a: rot_ants[i] for i, a in enumerate(ants)}
    blvec = np.array([pos[bj] - pos[bi] for bi, bj in baselines]).T  # (3, nbl)
    is_coplanar = bool(np.all(np.abs(blvec[2]) <= flat_array_tol))
    d = 2 if is_coplanar else 3
    targets = blvec[:d]
    targets = np.where(flipped_global[None, :], -targets, targets)

    # FLOP model: exact direct vs spread+FFT+interp.
    direct_cost = 8.0 * nsrc * nbl
    x_ext = [TWO_PI * fmax / speed_of_light] * d
    if d == 2:
        # fit_precorr deferred: the chebfit host time is only paid
        # below if the type-3 path wins the cost comparison.
        probe = plan_type3(
            targets, x_extent=x_ext, eps=eps,
            upsample_factor=upsample_factor, fit_precorr=False,
        )
        K = 1
    else:
        # 3D (non-coplanar, finufft nufft3d3 parity; ref cpu/nufft.py:
        # 62-118) via the low-rank-z 2D factorization: a full 3D fine
        # grid does not fit in device memory, so the z
        # phase factors as K Chebyshev modes batched through the 2D
        # spread (transform.plan_type3_lowrank_z). The z range of the
        # rotated upper-hemisphere source coordinates bounds the
        # Chebyshev bandwidth: extremize rot[2] . v over |v| = 1,
        # v_z >= 0 (interior max 1 when the row's z component points
        # up, else on the horizon circle).
        r = rotation[2]
        rxy = float(np.hypot(r[0], r[1]))
        zhi = 1.0 if r[2] >= 0 else rxy
        zlo = -1.0 if r[2] <= 0 else -rxy
        scale = TWO_PI * fmax / speed_of_light
        pad = 1e-3  # aberration + fp slop before the executor's clamp
        try:
            probe_z = plan_type3_lowrank_z(
                targets,
                x_extent=x_ext,
                eps=eps,
                upsample_factor=upsample_factor,
                x_range_z=((zlo - pad) * scale, (zhi + pad) * scale),
                fit_precorr=False,
            )
        except ValueError as err:
            # z bandwidth beyond the low-rank expansion's reach (very
            # tall arrays): the exact direct path is the only accurate
            # option.
            logger.warning(
                "3D type-3 low-rank factorization unavailable (%s); "
                "using the exact direct path", err,
            )
            return _SimPlan(
                mode="direct",
                executor=None,
                targets=targets,
                is_coplanar=is_coplanar,
                rotation_matrix=rotation,
                lattice_matrix=None,
            )
        probe = probe_z.plan2d
        K = probe_z.K
    w = probe.kernel.w
    C = max(1, npairs * nfeeds**2)
    # Spreading is priced at 16 * nsrc * w^2 per channel on every backend.
    # The constant is not calibrated on the GPU (no measurement yet); it
    # decides direct vs NUFFT.
    per_mode = 16.0 * nsrc * w**2
    spread_cost = K * per_mode
    nf_cells = float(np.prod(probe.nf))
    nufft_cost = (
        spread_cost
        + 5.0 * K * nf_cells * np.log2(max(nf_cells, 2)) / C
        + 16.0 * nbl * w**2 * K
    )
    if nufft_mode == "direct" or (
        nufft_mode == "auto" and direct_cost < nufft_cost
    ):
        logger.info(
            "Using exact direct path (cost %.2e < nufft %.2e)",
            direct_cost,
            nufft_cost,
        )
        return _SimPlan(
            mode="direct",
            executor=None,
            targets=targets,  # meters; nufft_coords supplies 2 pi nu / c
            is_coplanar=is_coplanar,
            rotation_matrix=rotation,
            lattice_matrix=None,
        )

    if d == 3:
        executor = Type3LowrankZExecutor(fit_plan_precorr(probe_z))
        logger.info(
            "Using type-3 NUFFT path (3D lowrank-z: nf=%s, w=%d, K=%d)",
            probe.nf, w, K,
        )
    else:
        executor = Type3Executor(fit_plan_precorr(probe))
        logger.info("Using type-3 NUFFT path (nf=%s, w=%d)", probe.nf, w)
    return _SimPlan(
        mode="type3",
        executor=executor,
        targets=None,
        is_coplanar=is_coplanar,
        rotation_matrix=rotation,
        lattice_matrix=None,
    )


def select_gridded_path(
    nufft_mode, bls_signed, eps, upsample_factor, nsrc, nbl, n_modes, npairs,
    nfeeds,
):
    """Gridded arrays: exact factored DFT vs ES type-1.

    The exact separable-DFT executor dominates the dense ES spreader
    everywhere the dense regime applies (strictly fewer MACs, no
    FFT/deconvolution, ~5-7x smaller scan carry, zero truncation
    error -- see Type1ExactExecutor), so it is the default whenever
    the MODE grid fits the dense-spread size class AND the factor
    phases stay f32-error-free (per-axis kmax * nm < 2^23; beyond
    that the integer product k * cell is no longer exact in f32 --
    only extremely elongated lattices hit this). FFTVIS_TYPE1=
    {auto,exact,es} overrides (es keeps the ES + FFT pipeline, e.g.
    for comparison benchmarks).
    """
    from ..nufft.transform import (
        DENSE_GRID_LIMIT,
        Type1ExactExecutor,
        plan_type1_exact,
    )

    if nufft_mode == "direct":
        return "direct", None, bls_signed.astype(float)
    t1_env = os.environ.get("FFTVIS_TYPE1", "auto")
    xplan = plan_type1_exact(bls_signed)
    f32_safe = all(
        k * n < 2**23 for k, n in zip(xplan.kmax, xplan.nf)
    )
    if t1_env == "exact" and not f32_safe:
        logger.warning(
            "FFTVIS_TYPE1=exact forced on a lattice whose factor "
            "phases exceed the f32-exact bound (kmax*nm >= 2^23 on "
            "some axis, mode grid %s); expect degraded accuracy in "
            "float32.", xplan.nf,
        )
    # By default the exact path runs whenever the mode grid fits; the
    # crossover with the ES + FFT pipeline has not been measured on the GPU.
    if t1_env == "exact" or (
        t1_env != "es"
        and f32_safe
        and int(np.prod(xplan.nf)) <= DENSE_GRID_LIMIT
    ):
        logger.info(
            "Gridded path: exact separable DFT (mode grid %s)", xplan.nf
        )
        return "type1", Type1ExactExecutor(xplan), None
    plan = plan_type1(bls_signed, eps, upsample_factor)
    return "type1", Type1Executor(plan), None
