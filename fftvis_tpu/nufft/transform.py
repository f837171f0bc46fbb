"""JAX NUFFT: host planning + jittable device execution.

Replaces finufft's type-3 and type-1 transforms (ref /root/reference/src/
fftvis/cpu/nufft.py:11-175) with the decomposition

    type-1:  ES-spread (periodic) -> batched XLA (i)FFT -> per-mode
             deconvolution -> gather at the requested integer modes
    type-3:  pre-phase + pre-correction -> ES-spread -> batched XLA (i)FFT ->
             grid deconvolution -> ES-interpolation at the (rescaled)
             nonuniform targets

Key structural departures from the CPU library, driven by XLA:

  * Planning vs execution are fully split. A plan is computed on host from
    static problem bounds (target coordinates are host data: baselines x
    frequencies), so everything under ``jit`` has static shapes. Source
    coordinates stay on device; their extent is bounded by the unit sphere
    (|x| <= 2 pi after the reference's ``topo *= 2 pi``), so no
    data-dependent grid sizing is needed.
  * All transforms are batched over a leading channel axis C (beam-pairs x
    feed-pairs x ...), turning many small CPU transforms (one per beam pair
    per frequency; ref cpu_simulate.py:1030-1069) into one large batched
    tensor program.
  * The interpolation half is a dense gather + einsum with host-precomputed
    tap indices/weights (targets are static); only spreading needs dynamic
    indexing.

Sign convention matches finufft defaults used by the reference (isign=+1
for types 1 and 3):  f(s) = sum_j c_j exp(+i s . x_j).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .kernels import (
    ESKernel,
    es_kernel_ft,
    es_kernel_ft_cheb,
    es_kernel_grid,
    fit_log_ft_cheb,
    next_fast_size,
)


# --------------------------------------------------------------------------
# Plans (host side, all-static)
# --------------------------------------------------------------------------


def _check_int32_grid(nf) -> None:
    """Guard the flat int32 index space of a planned grid.

    Gather/scatter/tap indices are composed per axis as ``idx * nf_d + tap``
    and shipped to the device as int32 (the device index dtype); a grid
    with >= 2^31 cells would silently wrap and address wrong cells. No
    realistic plan gets near this (the fine-grid planner caps total cells
    far below), but a hand-built plan could.
    """
    cells = int(np.prod([int(n) for n in nf]))
    if cells > np.iinfo(np.int32).max:
        raise ValueError(
            f"planned grid has {cells} cells, exceeding the int32 index "
            "space used for device gather/scatter indices; reduce the mode "
            "extent or split the transform"
        )


def _scoped(name):
    """Wrap an executor stage in jax.named_scope for profiler attribution.

    The tag flows into HLO op metadata, letting examples/trace_report.py
    attribute fused device ops to pipeline stages.
    """

    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapper(*a, **k):
            import jax

            with jax.named_scope(name):
                return fn(*a, **k)

        return wrapper

    return deco


@dataclass(frozen=True)
class Type1Plan:
    """Plan for a d-dimensional type-1 transform gathered at fixed modes.

    The reference computes the full (n_modes, n_modes) mode grid and gathers
    afterwards (ref cpu/nufft.py:162-175); here the deconvolution+gather is
    planned per requested mode so the full deconvolved grid is never formed.
    """

    kernel: ESKernel
    d: int
    nf: tuple[int, ...]
    # Per-target gather positions in FFT-order flat indexing, (m,) int32.
    gather_idx: np.ndarray
    # Per-target deconvolution factors, (m,) float64.
    gather_deconv: np.ndarray
    n_targets: int


@dataclass(frozen=True)
class Type3Plan:
    """Plan for a d-dimensional type-3 transform at fixed targets."""

    kernel: ESKernel
    d: int
    nf: tuple[int, ...]
    h: tuple[float, ...]  # stage-A grid spacing per dim (x units)
    ds: tuple[float, ...]  # uniform s-sample spacing per dim
    s_center: tuple[float, ...]
    # Per-dim mode deconvolution vectors in FFT order, each (nf_d,) float64.
    deconv: tuple[np.ndarray, ...]
    # Per-dim interpolation taps: indices (m, w) int32 (mod nf applied) and
    # kernel values (m, w) float64.
    tap_idx: tuple[np.ndarray, ...]
    tap_val: tuple[np.ndarray, ...]
    n_targets: int
    # Host-fitted log-Chebyshev of psi_hat over the planned extent (per
    # dim; see kernels.fit_log_ft_cheb). f32 device pipelines evaluate the
    # amplitude pre-correction from this instead of the 80-node quadrature
    # (~8x fewer flops per source-axis); None entries fall back.
    ft_coefs: tuple = ()
    ft_xi_max: tuple = ()


def plan_type1(
    modes: np.ndarray,
    eps: float,
    upsample_factor: float = 2.0,
    prefer_pow2: bool = False,
) -> Type1Plan:
    """Plan a type-1 transform gathered at integer ``modes``.

    Parameters
    ----------
    modes
        Integer mode indices, shape (d, m). May be negative (FFT wrap).
    eps
        Requested accuracy (same semantics as finufft / the reference API).
    upsample_factor
        Fine-grid oversampling sigma, 1.25 or 2 (ref wrapper.py:99).
    """
    modes = np.atleast_2d(np.asarray(modes, dtype=np.int64))
    d, m = modes.shape
    kernel = ESKernel.from_eps(eps, upsample_factor)

    # The fine grid must hold the requested modes inside the accurate band
    # |k| <= nf / (2 sigma).
    kmax = np.max(np.abs(modes), axis=1)  # (d,)
    nf = tuple(
        next_fast_size(
            int(np.ceil(2 * upsample_factor * max(km, 1) + kernel.w)),
            prefer_pow2=prefer_pow2,
        )
        for km in kmax
    )

    # FFT-order flat gather index and per-target deconvolution. The kernel
    # FT is evaluated once per unique |k| per axis (quadrature over every
    # target would dominate planning for ~100k-baseline arrays).
    _check_int32_grid(nf)
    flat = np.zeros(m, dtype=np.int64)
    deconv = np.ones(m, dtype=np.float64)
    for axis in range(d):
        k = modes[axis]
        idx = np.mod(k, nf[axis])
        flat = flat * nf[axis] + idx
        km = int(kmax[axis])
        table = es_kernel_ft(
            2.0 * np.pi * np.arange(km + 1) / nf[axis], kernel.w, kernel.beta
        )
        deconv /= table[np.abs(k)]
    gather_idx = flat.astype(np.int32)
    # Frozen: cache keys fingerprint these every simulate() call; an
    # immutable-owner array gets a one-time digest (core/hashing.py).
    gather_idx.setflags(write=False)
    deconv.setflags(write=False)
    return Type1Plan(
        kernel=kernel,
        d=d,
        nf=nf,
        gather_idx=gather_idx,
        gather_deconv=deconv,
        n_targets=m,
    )


@dataclass(frozen=True)
class Type3LowrankZPlan:
    """Plan for a 3D type-3 transform as K z-modes of a batched 2D type-3.

    Device replacement for finufft's ``nufft3d3`` (ref /root/reference/
    src/fftvis/cpu/nufft.py:62-118): a full 3D fine grid does not fit in
    device memory for wide arrays (the sigma^2-oversampled grid reaches
    10^10 cells), so instead the z phase factor is factored at low rank:

        exp(i s_z x_z) = exp(i s_zc x_z)                 [device pre-phase]
                       * exp(i s'_z x_c)                 [folded into g]
                       * sum_k a_k(s'_z zh) T_k(t),      t = (x_z - x_c)/zh

    a Chebyshev (Jacobi-Anger) expansion whose length K ~ |s'|_max zh +
    O(log 1/eps) is small for near-coplanar arrays. Each z-mode multiplies
    the weights by T_k(t) (a cheap device recurrence), giving a 2D type-3
    with C*K channels -- the extra channels ride the same 2D spread, and
    memory stays 2D. Target-side coefficients g (m, K) are
    host-precomputed by a Chebyshev-node DCT (exact to machine precision,
    no Bessel evaluations needed).
    """

    plan2d: Type3Plan
    K: int
    s_center_z: float
    x_center_z: float
    x_half_z: float
    # (m, K) complex128: a_k(s'_m zh) * exp(i s'_m x_c).
    g: np.ndarray
    n_targets: int


def plan_type3_lowrank_z(
    targets: np.ndarray,
    x_extent,
    eps: float,
    upsample_factor: float = 2.0,
    prefer_pow2: bool = False,
    x_range_z: tuple[float, float] | None = None,
    max_modes: int = 160,
    fit_precorr: bool = True,
) -> Type3LowrankZPlan:
    """Plan a 3D type-3 transform via the low-rank z factorization.

    Parameters match :func:`plan_type3` (d must be 3); ``x_range_z``
    optionally tightens the source z-coordinate range to (lo, hi) -- e.g.
    (0, X) for topocentric up-hemisphere sources -- which halves the
    Chebyshev bandwidth versus the symmetric default (-X, X).
    """
    targets = np.atleast_2d(np.asarray(targets, dtype=np.float64))
    d, m = targets.shape
    if d != 3:
        raise ValueError(f"lowrank-z planning requires d=3, got {d}")
    x_extent = np.broadcast_to(np.asarray(x_extent, dtype=np.float64), (3,))

    plan2d = plan_type3(
        targets[:2], x_extent[:2], eps, upsample_factor, prefer_pow2,
        fit_precorr=fit_precorr,
    )

    sz = targets[2]
    s_zc = 0.5 * (float(sz.min()) + float(sz.max()))
    s_prime = sz - s_zc

    if x_range_z is None:
        zlo, zhi = -float(x_extent[2]), float(x_extent[2])
    else:
        zlo, zhi = float(x_range_z[0]), float(x_range_z[1])
    x_c = 0.5 * (zlo + zhi)
    zh = max(0.5 * (zhi - zlo), 1e-12)

    lam = s_prime * zh  # per-target Chebyshev bandwidth
    lam_max = float(np.max(np.abs(lam))) if m else 0.0

    # Chebyshev coefficients of exp(i lam t) on t in [-1, 1] via a DCT at
    # Chebyshev-Gauss nodes. Upper bound on the needed degree: lam + a
    # superexponential-decay tail (|J_k(lam)| ~ (e lam / 2k)^k for k > lam).
    K_need = int(np.ceil(lam_max + 10.0 * np.log10(1.0 / eps) + 12))
    if K_need > max_modes:
        # The Jacobi-Anger expansion has not started its superexponential
        # decay before the cap: truncation error would be O(1), not O(eps).
        # Refuse rather than return silently wrong visibilities; callers
        # (the engine FLOP model) fall back to the exact direct path.
        raise ValueError(
            f"lowrank-z expansion needs ~{K_need} Chebyshev modes "
            f"(z bandwidth lam_max={lam_max:.1f}, eps={eps:.0e}) but "
            f"max_modes={max_modes}: the array's z extent is too large for "
            f"the low-rank factorization; use the direct path or raise "
            f"max_modes"
        )
    K_hi = max(K_need, 4)
    Q = 2 * K_hi
    theta = np.pi * (np.arange(Q) + 0.5) / Q
    tq = np.cos(theta)  # (Q,)
    # h[m, q] = exp(i lam_m t_q); a[m, k] = (2/Q) sum_q h cos(k theta_q).
    h = np.exp(1j * lam[:, None] * tq[None, :])  # (m, Q)
    cosmat = np.cos(np.outer(np.arange(K_hi), theta))  # (K_hi, Q)
    a = (2.0 / Q) * (h @ cosmat.T)  # (m, K_hi)
    a[:, 0] *= 0.5

    # Truncate where every target's tail is below eps (coefficients decay
    # superexponentially past lam, so this cutoff is sharp).
    amax = np.max(np.abs(a), axis=0)
    keep = np.nonzero(amax > 0.1 * eps)[0]
    K = int(keep[-1]) + 1 if keep.size else 1
    K = max(K, 1)

    g = a[:, :K] * np.exp(1j * s_prime * x_c)[:, None]
    return Type3LowrankZPlan(
        plan2d=plan2d,
        K=K,
        s_center_z=float(s_zc),
        x_center_z=float(x_c),
        x_half_z=float(zh),
        g=g,
        n_targets=m,
    )


def plan_type3(
    targets: np.ndarray,
    x_extent,
    eps: float,
    upsample_factor: float = 2.0,
    prefer_pow2: bool = False,
    fit_precorr: bool = True,
) -> Type3Plan:
    """Plan a type-3 transform onto fixed nonuniform ``targets``.

    Parameters
    ----------
    targets
        Target frequencies s, shape (d, m) (host data; e.g. 2 pi * uvw).
    x_extent
        Per-dim bound X_d with |x_d| <= X_d for all (device-side) source
        coordinates. For unit-sphere source coordinates scaled by 2 pi this
        is at most 2 pi (and pi for the z axis).
    eps, upsample_factor
        Accuracy / oversampling, as in the reference API.
    fit_precorr
        Fit the log-Chebyshev amplitude pre-correction (several chebfit
        solves of host time; f32 executors consume it). Cost-model probe
        plans that are never executed pass False; the executor then falls
        back to the exact quadrature if it ever runs.
    """
    targets = np.atleast_2d(np.asarray(targets, dtype=np.float64))
    d, m = targets.shape
    x_extent = np.broadcast_to(np.asarray(x_extent, dtype=np.float64), (d,))
    kernel = ESKernel.from_eps(eps, upsample_factor)
    sigma, w = upsample_factor, kernel.w

    s_lo = targets.min(axis=1)
    s_hi = targets.max(axis=1)
    s_center = 0.5 * (s_lo + s_hi)
    s_half = 0.5 * (s_hi - s_lo)

    nf, h, ds, deconv, tap_idx, tap_val = [], [], [], [], [], []
    ft_coefs, ft_xi_max = [], []
    for axis in range(d):
        X = max(float(x_extent[axis]), 1e-12)
        S = max(float(s_half[axis]), 1.0 / X)
        h_d = np.pi / (sigma * S)
        # Grid size: sigma-oversampled in BOTH domains (the type-3 sigma^2
        # law; finufft paper sec. 4), plus kernel margins. The second bound
        # keeps the interpolation taps (at |v| <= nf/(2 sigma) plus w/2)
        # inside the FFT band: nf (1 - 1/sigma) >= w + 4 -- binding for
        # small grids at sigma = 1.25.
        nf_d = next_fast_size(
            max(
                int(np.ceil(2.0 * sigma**2 * X * S / np.pi + 2 * w + 4)),
                int(np.ceil((w + 4) / (1.0 - 1.0 / sigma))),
            ),
            prefer_pow2=prefer_pow2,
        )
        ds_d = 2.0 * np.pi / (nf_d * h_d)

        # Mode deconvolution in FFT order.
        k = np.fft.fftfreq(nf_d, d=1.0 / nf_d)
        deconv_d = 1.0 / es_kernel_ft(2.0 * np.pi * k / nf_d, w, kernel.beta)
        deconv.append(deconv_d)

        # Interpolation taps at (s - s_c) / ds, signed FFT indexing. The
        # window [ceil(v - w/2), ...] keeps offsets in (-w/2, w/2] for both
        # odd and even widths.
        v = (targets[axis] - s_center[axis]) / ds_d  # (m,)
        k0 = np.ceil(v - w / 2.0).astype(np.int64)
        offs = np.arange(w, dtype=np.int64)
        kk = k0[:, None] + offs[None, :]  # (m, w) signed
        tap_idx.append(np.mod(kk, nf_d).astype(np.int32))
        tap_val.append(es_kernel_grid(v[:, None] - kk, w, kernel.beta))

        nf.append(nf_d)
        h.append(float(h_d))
        ds.append(float(ds_d))
        # Amplitude pre-correction fit over the source extent (2% margin;
        # xi_max <= pi/sigma by the nf sizing rule, well inside psi_hat's
        # positive band, so the fit succeeds for every real plan).
        xi_m = 1.02 * X * ds_d
        ft_coefs.append(
            fit_log_ft_cheb(w, kernel.beta, xi_m) if fit_precorr else None
        )
        ft_xi_max.append(xi_m)

    for arr in (*deconv, *tap_idx, *tap_val):
        arr.setflags(write=False)  # one-time digest (core/hashing.py)
    return Type3Plan(
        kernel=kernel,
        d=d,
        nf=tuple(nf),
        h=tuple(h),
        ds=tuple(ds),
        s_center=tuple(float(c) for c in s_center),
        deconv=tuple(deconv),
        tap_idx=tuple(tap_idx),
        tap_val=tuple(tap_val),
        n_targets=m,
        ft_coefs=tuple(ft_coefs),
        ft_xi_max=tuple(ft_xi_max),
    )


def fit_plan_precorr(plan):
    """Return ``plan`` with the log-Chebyshev pre-correction fitted.

    Fills any ``None`` entries of ``ft_coefs`` (plans built with
    ``fit_precorr=False`` -- e.g. the engine's cost-model probes, which
    only pay the chebfit host time once the type-3 path actually wins).
    Entries the fit cannot reach stay ``None`` (executors fall back to
    the exact quadrature). No-op for fully fitted plans.
    """
    import dataclasses

    if isinstance(plan, Type3LowrankZPlan):
        plan2d = fit_plan_precorr(plan.plan2d)
        if plan2d is plan.plan2d:
            return plan
        return dataclasses.replace(plan, plan2d=plan2d)
    if all(c is not None for c in plan.ft_coefs):
        return plan
    coefs = tuple(
        c
        if c is not None
        else fit_log_ft_cheb(plan.kernel.w, plan.kernel.beta, plan.ft_xi_max[i])
        for i, c in enumerate(plan.ft_coefs)
    )
    return dataclasses.replace(plan, ft_coefs=coefs)


def _precorr_axis(p, axis: int, x_axis, rdtype, xp):
    """psi_hat(x * ds_axis) for the type-3 amplitude pre-correction.

    f32 device pipelines use the plan's fitted log-Chebyshev (one Clenshaw
    + exp; ~8x fewer flops than the 80-node quadrature). f64 pipelines and
    fit-less plans keep the quadrature (the fit tolerance is 3e-7 -- f32
    territory only).
    """
    xi = x_axis * xp.asarray(p.ds[axis], dtype=rdtype)
    coefs = p.ft_coefs[axis] if axis < len(p.ft_coefs) else None
    if coefs is not None and np.dtype(rdtype) == np.float32:
        return es_kernel_ft_cheb(xi, coefs, p.ft_xi_max[axis], xp=xp)
    return es_kernel_ft(xi, p.kernel.w, p.kernel.beta, xp=xp)


# --------------------------------------------------------------------------
# Device execution (jittable)
# --------------------------------------------------------------------------


class Type1Executor:
    """Split-phase type-1 execution for jitted pipelines.

    ``spread`` is linear in the weights, so grids from source blocks can be
    accumulated under ``lax.scan`` before a single ``transform`` + ``gather``
    -- this is how the engine implements the reference's source-chunking
    memory control (ref core/utils.py:213-355) with static shapes.
    """

    def __init__(self, plan: Type1Plan):
        self.plan = plan

    channel_multiplier = 1

    def fresh_copy(self):
        return type(self)(self.plan)

    @_scoped("nufft_spread")
    def spread(self, x, c):
        """x: (d, n) radians (2 pi periodic); c: (C, n). Returns (C, *nf)."""
        import jax.numpy as jnp

        p = self.plan
        u = [
            jnp.mod(x[axis] / (2.0 * jnp.pi) * p.nf[axis], p.nf[axis])
            for axis in range(p.d)
        ]
        return _spread_auto(u, c, p.nf, p.kernel.w, p.kernel.beta)

    @_scoped("nufft_spread")
    def spread_ds(self, u_ds, c):
        """Spread from double-single grid coordinates.

        ``u_ds``: length-d list of (u_hi, u_lo) f32 pairs, already reduced
        into [0, nf_d) (engine computes them via tpu.ds.ds_mod_n). The
        fractional position keeps ~ulp(1) accuracy, removing the dominant
        fp32 phase-error term of the plain path (u loses ~nf * 2^-24 cells).
        """
        return _spread_auto(
            [u[0] for u in u_ds], c, self.plan.nf, self.plan.kernel.w,
            self.plan.kernel.beta, u_lo_list=[u[1] for u in u_ds],
        )

    @_scoped("nufft_fft")
    def transform(self, g):
        return _forward_modes(g, self.plan.nf)

    @_scoped("nufft_gather")
    def gather(self, G, sel: np.ndarray | None = None):
        """Gather modes; ``sel`` optionally selects target rows (static)."""
        import jax.numpy as jnp

        p = self.plan
        idx = p.gather_idx if sel is None else p.gather_idx[sel]
        dec = p.gather_deconv if sel is None else p.gather_deconv[sel]
        flat = G.reshape(G.shape[0], -1)
        rdtype = jnp.finfo(G.dtype).dtype
        out = flat[:, jnp.asarray(idx)] * jnp.asarray(dec, dtype=rdtype)[None, :]
        return out.astype(G.dtype)

    @_scoped("nufft_gather")
    def gather_padded(self, G, sel_pad: np.ndarray):
        """Batched per-pair gather: (P*nf2, *nf) -> (P, nf2, m_max).

        ``sel_pad`` is the engine's padded pair routing (static (P, m_max)
        target rows, pair-major channels); one take_along_axis replaces P
        per-pair :meth:`gather` calls (an O(P) HLO otherwise).
        """
        import jax.numpy as jnp

        p = self.plan
        P, m_max = sel_pad.shape
        flat = G.reshape(P, -1, int(np.prod(p.nf)))
        idx = p.gather_idx[sel_pad]  # (P, m_max) host
        dec = p.gather_deconv[sel_pad]
        rdtype = jnp.finfo(G.dtype).dtype
        sub = jnp.take_along_axis(
            flat,
            jnp.broadcast_to(
                jnp.asarray(idx)[:, None, :], flat.shape[:2] + (m_max,)
            ),
            axis=2,
        )
        return (sub * jnp.asarray(dec, dtype=rdtype)[:, None, :]).astype(G.dtype)


def make_type1_fn(plan: Type1Plan):
    """(x (d,n) radians, c (C,n)) -> (C, m). One-shot convenience wrapper."""
    ex = Type1Executor(plan)

    def run(x, c):
        return ex.gather(ex.transform(ex.spread(x, c)))

    return run


@dataclass(frozen=True)
class Type2Plan:
    """Plan for a d-dimensional type-2 transform (modes -> points).

    c_j = sum_k f_k exp(+i k . x_j) for a static integer mode list and
    static evaluation points: the exact TRANSPOSE of this library's type-1
    (same +i sign convention, see the module docstring), so it shares the
    type-1 fine grid, kernel, and deconvolution table. The reference needs
    no type-2 (fftvis only consumes types 1 and 3 of finufft), but a
    standalone NUFFT library without the uniform->nonuniform direction
    would leave degridding / model-prediction workflows uncovered.

    Pipeline (each stage the transpose of the type-1 stage):

        scatter-add (f * deconv) at the mode positions  [gather^T]
        -> batched +i-sign FFT (symmetric matrix)        [FFT^T]
        -> ES-kernel tap interpolation at the points     [spread^T]

    Points are host data here (taps are planned in float64), unlike the
    type-1 executor whose source coordinates stay on device -- type-2's
    role (evaluating a gridded model at instrument sampling points) makes
    the points part of the plan, exactly like type-3's targets.
    """

    kernel: ESKernel
    d: int
    nf: tuple[int, ...]
    # Per-mode scatter positions in FFT-order flat indexing, (m,) int32,
    # and deconvolution factors, (m,) float64 (the type-1 gather tables).
    scatter_idx: np.ndarray
    scatter_deconv: np.ndarray
    n_modes: int
    # Per-point interpolation taps per dim: indices (n, w) int32 (mod nf
    # applied) and kernel values (n, w) float64.
    tap_idx: tuple[np.ndarray, ...]
    tap_val: tuple[np.ndarray, ...]
    n_points: int


def plan_type2(
    x: np.ndarray,
    modes: np.ndarray,
    eps: float,
    upsample_factor: float = 2.0,
    prefer_pow2: bool = False,
) -> Type2Plan:
    """Plan a type-2 transform: integer ``modes`` evaluated at points ``x``.

    Parameters
    ----------
    x
        Evaluation points in radians (2 pi periodic), shape (d, n). Host
        data -- interpolation taps are planned from them in float64.
    modes
        Integer mode indices, shape (d, m). May be negative (FFT wrap);
        duplicate modes sum (scatter-add), mirroring the type-1 gather's
        transpose exactly.
    eps, upsample_factor
        Accuracy / oversampling, as for :func:`plan_type1`.
    """
    x = np.atleast_2d(np.asarray(x, dtype=np.float64))
    t1 = plan_type1(modes, eps, upsample_factor, prefer_pow2)
    if x.shape[0] != t1.d:
        raise ValueError(
            f"x has {x.shape[0]} dims but modes have {t1.d}"
        )
    w = t1.kernel.w
    tap_idx, tap_val = [], []
    for axis in range(t1.d):
        nf_d = t1.nf[axis]
        u = np.mod(x[axis] / (2.0 * np.pi) * nf_d, nf_d)  # (n,) grid units
        i0 = np.ceil(u - w / 2.0).astype(np.int64)
        cells = i0[:, None] + np.arange(w, dtype=np.int64)[None, :]
        tap_idx.append(np.mod(cells, nf_d).astype(np.int32))
        tap_val.append(es_kernel_grid(u[:, None] - cells, w, t1.kernel.beta))
    return Type2Plan(
        kernel=t1.kernel,
        d=t1.d,
        nf=t1.nf,
        scatter_idx=t1.gather_idx,
        scatter_deconv=t1.gather_deconv,
        n_modes=t1.n_targets,
        tap_idx=tuple(tap_idx),
        tap_val=tuple(tap_val),
        n_points=x.shape[1],
    )


class Type2Executor:
    """Split-phase type-2 execution for jitted pipelines.

    ``interp`` is linear in the grid, so one ``scatter`` + ``transform``
    can serve multiple point blocks (the mirror of the type-1 executor's
    accumulate-then-gather structure).
    """

    def __init__(self, plan: Type2Plan):
        self.plan = plan

    def fresh_copy(self):
        return type(self)(self.plan)

    @_scoped("nufft_scatter")
    def scatter(self, f):
        """f: (C, m) mode coefficients. Returns the fine mode grid (C, *nf).

        Uses XLA ``.at[].add`` scatter-add; fine for the typical small mode
        lists this transform serves.
        If very large mode lists (>~10^5) become a use case, reuse the
        type-1 spreaders' bincount/segment-sum or dense-matmul formulation
        instead.
        """
        import jax
        import jax.numpy as jnp

        p = self.plan
        rdtype = jnp.finfo(f.dtype).dtype
        vals = f * jnp.asarray(p.scatter_deconv, dtype=rdtype)[None, :]
        # Scatter-add the real/imag planes separately: the scatter stays
        # real, and interpolation distributes over re/im anyway -- same
        # split the beam tables use.
        idx = jnp.asarray(p.scatter_idx)
        zeros = jnp.zeros((f.shape[0], int(np.prod(p.nf))), dtype=rdtype)
        gr = zeros.at[:, idx].add(jnp.real(vals))
        gi = zeros.at[:, idx].add(jnp.imag(vals))
        return jax.lax.complex(gr, gi).reshape((f.shape[0],) + p.nf)

    @_scoped("nufft_fft")
    def transform(self, G):
        # e^{+2 pi i k m / nf} is symmetric in (k, m): the +i-sign FFT that
        # implements the type-1 forward IS its own transpose.
        return _forward_modes(G, self.plan.nf)

    @_scoped("nufft_interp")
    def interp(self, g, point_block: int | None = None):
        """Evaluate the spatial fine grid at the planned points.

        g: (C, *nf) from :meth:`transform`. Returns (C, n_points).
        Gathers all w^d taps per point at once -- (C, block, w^d) resident
        -- so ``point_block`` (host-static) bounds memory for large point
        sets; taps are host arrays, making the block loop shape-static.
        """
        import jax.numpy as jnp

        p = self.plan
        n = p.n_points
        if n == 0:
            return jnp.zeros((g.shape[0], 0), dtype=g.dtype)
        if point_block is None or point_block >= n:
            point_block = n
        elif point_block < 1:
            raise ValueError(f"point_block must be >= 1, got {point_block}")
        flat = g.reshape(g.shape[0], -1)
        rdtype = jnp.finfo(g.dtype).dtype
        out = []
        for lo in range(0, n, point_block):
            hi = min(lo + point_block, n)
            idx = p.tap_idx[0][lo:hi].astype(np.int64)  # (b, w)
            val = p.tap_val[0][lo:hi]
            for axis in range(1, p.d):
                nf_d = p.nf[axis]
                idx = (
                    idx[:, :, None] * nf_d
                    + p.tap_idx[axis][lo:hi][:, None, :]
                ).reshape(hi - lo, -1)
                val = (
                    val[:, :, None] * p.tap_val[axis][lo:hi][:, None, :]
                ).reshape(hi - lo, -1)
            taps = flat[:, jnp.asarray(idx.astype(np.int32))]  # (C, b, W)
            out.append(
                jnp.einsum(
                    "cbw,bw->cb", taps, jnp.asarray(val, dtype=rdtype)
                )
            )
        return out[0] if len(out) == 1 else jnp.concatenate(out, axis=1)


def make_type2_fn(plan: Type2Plan, point_block: int | None = None):
    """(f (C, m) mode coefficients) -> (C, n_points). One-shot wrapper."""
    ex = Type2Executor(plan)

    def run(f):
        return ex.interp(ex.transform(ex.scatter(f)), point_block=point_block)

    return run


@dataclass(frozen=True)
class Type1ExactPlan:
    """Plan for the exact separable-DFT type-1 (gridded-array) transform.

    ``nf`` here is the MODE grid -- 2 kmax + 1 per axis, rounded up to
    ``nhi * K`` so the split-k factor outer product (see
    :class:`Type1ExactExecutor`) reshapes contiguously -- not an
    oversampled fine grid; there is no kernel, no FFT and no
    deconvolution. The <=2 K - 1 padding rows per axis hold modes beyond
    kmax that are computed but never gathered.
    """

    d: int
    nf: tuple[int, ...]
    kmax: tuple[int, ...]
    # Per-axis split k = khi * K + klo with K ~ sqrt(nm): (K, nhi) pairs.
    split: tuple[tuple[int, int], ...]
    # Per-target gather positions into the (kmax-shifted, padded) mode grid.
    gather_idx: np.ndarray
    n_targets: int


def plan_type1_exact(modes: np.ndarray) -> Type1ExactPlan:
    """Plan an exact type-1 at integer ``modes`` (no eps: the transform is
    evaluated exactly, up to floating-point roundoff)."""
    modes = np.atleast_2d(np.asarray(modes, dtype=np.int64))
    d, m = modes.shape
    kmax = tuple(
        int(max(np.max(np.abs(modes[axis])) if m else 1, 1))
        for axis in range(d)
    )
    split = []
    nf = []
    for km in kmax:
        nm = 2 * km + 1
        K = max(int(round(np.sqrt(nm))), 1)
        nhi = -(-nm // K)
        split.append((K, nhi))
        nf.append(nhi * K)
    _check_int32_grid(nf)
    flat = np.zeros(m, dtype=np.int64)
    for axis in range(d):
        flat = flat * nf[axis] + (modes[axis] + kmax[axis])
    gather_idx = flat.astype(np.int32)
    gather_idx.setflags(write=False)  # one-time digest (core/hashing.py)
    return Type1ExactPlan(
        d=d, nf=tuple(nf), kmax=kmax, split=tuple(split),
        gather_idx=gather_idx, n_targets=m,
    )


class Type1ExactExecutor:
    """Exact type-1 via separable DFT factor matmuls (no ES kernel, no FFT).

    For a gridded array the requested modes are integers |k| <= kmax, so

        V_k = sum_s c_s e^{+i (ky xy_s + kx xx_s)}

    factors exactly as ``M = Ey^T diag(c) Ex`` with
    ``E[s, j] = e^{+i k_j x_s}`` -- two (n, nm) complex factor matrices
    and one matmul per channel. Compared with the dense ES spreader +
    FFT + deconvolved gather (the reference's type-1 computes the full ES
    mode grid, ref cpu/nufft.py:120-175), this does strictly fewer MACs
    per source, needs no FFT or deconvolution, shrinks the scan-carry
    grid ~5-7x, and has NO eps truncation error at all.

    Cost model: sin/cos are multi-op polynomials, so building E
    entry-by-entry (n * nm sincos per axis) would cost more than the ES
    spreader's exp kernel. Instead each axis splits k = khi K + klo
    with K ~ sqrt(nm): E = A[s, khi] * B[s, klo] needs only
    n (nhi + K) ~ 2 n sqrt(nm) sincos plus one fused complex multiply per
    entry (~5x fewer transcendentals). The
    mode grid is padded to nhi * K so the outer product reshapes
    contiguously (padding rows are never gathered).

    Phase accuracy: the factor argument is reduced with an error-free
    integer-cell split: k * cell is exact in f32 (the engine gates this
    path on kmax * nm < 2^23) and reduced mod nm exactly up to a
    self-correcting (phase mod 2 pi) off-by-one, leaving a trig argument
    of magnitude <~ 2 pi that carries only ulp-level error regardless of
    kmax; the split adds one ~ulp complex multiply. Double-single low
    parts from the engine's ds_coords chain fold into the fractional
    term, so position accuracy matches the DS dense-ES path.
    """

    channel_multiplier = 1

    def __init__(self, plan: Type1ExactPlan):
        if plan.d != 2:
            raise ValueError("Type1ExactExecutor supports 2D mode grids")
        self.plan = plan

    def fresh_copy(self):
        return type(self)(self.plan)

    def _factor(self, u, u_lo, axis: int, rdtype):
        """E[s, j] = exp(+2 pi i (j - kmax) u_s / nm) as (n, nm) re/im.

        ``u`` lives in [0, nm) with nm = nhi * K the padded mode count;
        rows j >= 2 kmax + 1 are padding modes (computed, never read).
        """
        import jax.numpy as jnp

        nm = int(self.plan.nf[axis])
        km = int(self.plan.kmax[axis])
        K, nhi = self.plan.split[axis]
        m = u.shape[0]
        cell, frac = _split_cell_frac(
            u.astype(rdtype),
            None if u_lo is None else u_lo.astype(rdtype),
            jnp,
        )

        def phases(kvals, reduce_mod):
            q = kvals[None, :] * cell[:, None]  # integer product, exact
            if reduce_mod:
                q = q - nm * jnp.round(q / nm)  # mod into ~[-nm/2, nm/2]
            arg = (q + kvals[None, :] * frac[:, None]) * (2.0 * np.pi / nm)
            return jnp.cos(arg), jnp.sin(arg)

        khi = jnp.arange(nhi, dtype=rdtype) * K - km
        klo = jnp.arange(K, dtype=rdtype)  # |klo cell| < K nm: no mod needed
        ar, ai = phases(khi, True)  # (n, nhi)
        br, bi = phases(klo, False)  # (n, K)
        er = ar[:, :, None] * br[:, None, :] - ai[:, :, None] * bi[:, None, :]
        ei = ar[:, :, None] * bi[:, None, :] + ai[:, :, None] * br[:, None, :]
        return er.reshape(m, nm), ei.reshape(m, nm)

    def _grid(self, u_list, u_lo_list, c):
        import jax.numpy as jnp

        rdtype = jnp.finfo(jnp.result_type(c, 0.0)).dtype
        lo = (None, None) if u_lo_list is None else u_lo_list
        eyr, eyi = self._factor(u_list[0], lo[0], 0, rdtype)  # (n, nmy)
        exr, exi = self._factor(u_list[1], lo[1], 1, rdtype)  # (n, nmx)
        ey = jax_complex(eyr, eyi)
        ex = jax_complex(exr, exi)
        C, n = c.shape
        nmy, nmx = int(self.plan.nf[0]), int(self.plan.nf[1])
        # Two matmul formulations with IDENTICAL logical FLOPs
        # (C * n * nmy * nmx complex MACs); the choice is tile geometry:
        #
        # - FACTORED (einsum): contract ex (n, nmx) against a broadcast
        #   rhs = c * ey, i.e. a (2C*nmy, n) x (n, nmx) matmul. M is huge
        #   but N = nmx is small (21 at the north-star geometry), which
        #   leaves a GEMM's output tiles mostly empty. XLA operand-fuses
        #   the rhs broadcast, so nothing large materializes; this is the
        #   only option when C is small (M = 2C in the outer form would
        #   starve instead) or the mode grid is huge.
        # - OUTER-PRODUCT: materialize E[s, y*nmx+x] = ey * ex (complex,
        #   n x nmy*nmx) and run ONE (C, n) x (n, nmy*nmx) matmul: N fills
        #   (441 at the north star), M = 2C fills when C is large -- which
        #   is exactly the regime the engine routes to this executor.
        #   Costs an n*nmy*nmx complex temporary; gate on its size.
        outer_env = os.environ.get("FFTVIS_EXACT_OUTER", "auto")
        e_bytes = 2 * n * nmy * nmx * np.dtype(rdtype).itemsize
        use_outer = outer_env == "1" or (
            outer_env == "auto"
            and 2 * C >= 128  # M must fill
            # N must fill too: at nmy*nmx < 128 the factored einsum is
            # kept (these thresholds have not been tuned on the GPU).
            and nmy * nmx >= 128
            and e_bytes <= 512 * 1024 * 1024
        )
        if use_outer:
            import jax

            # Contract n against the rank-3 outer product directly: a
            # flatten-to-(n, nmy*nmx) + matmul + reshape can force
            # physical relayouts of the tensor; dot_general folds the
            # flattening into the matmul's layout.
            dn = (((1,), (0,)), ((), ()))
            cmm = os.environ.get("FFTVIS_EXACT_CMM", "split4")
            if cmm not in ("split4", "karatsuba"):
                # A typo'd knob silently measuring the default path is
                # the exact trap the bench discipline notes warn about.
                raise ValueError(
                    f"FFTVIS_EXACT_CMM={cmm!r}: expected 'split4' or "
                    "'karatsuba'"
                )
            if cmm == "karatsuba":
                # 3-real-matmul (Karatsuba/Gauss) split of the complex
                # product: 25% fewer real matmuls, paid for by building a
                # third operand (er3 + ei3). Opt-in; not measured on the
                # GPU.
                er3 = (
                    eyr[:, :, None] * exr[:, None, :]
                    - eyi[:, :, None] * exi[:, None, :]
                )
                ei3 = (
                    eyr[:, :, None] * exi[:, None, :]
                    + eyi[:, :, None] * exr[:, None, :]
                )
                cr = jnp.real(c)
                ci = jnp.imag(c)
                t1 = jax.lax.dot_general(cr, er3, dn)
                t2 = jax.lax.dot_general(ci, ei3, dn)
                t3 = jax.lax.dot_general(cr + ci, er3 + ei3, dn)
                g = jax.lax.complex(t1 - t2, t3 - t1 - t2)
                return g.astype(c.dtype)
            E3 = ey[:, :, None] * ex[:, None, :]
            g = jax.lax.dot_general(c, E3, dn)
            return g.astype(c.dtype)
        # Materialize the (C, n, nm_small) RHS on the SMALLER axis (less
        # memory traffic when XLA does not operand-fuse the broadcast).
        if self.plan.nf[0] <= self.plan.nf[1]:
            rhs = c[:, :, None] * ey[None, :, :]  # (C, n, nmy)
            g = jnp.einsum("sx,csy->cyx", ex, rhs)
        else:
            rhs = c[:, :, None] * ex[None, :, :]  # (C, n, nmx)
            g = jnp.einsum("sy,csx->cyx", ey, rhs)
        return g.astype(c.dtype)

    @_scoped("nufft_spread")
    def spread(self, x, c):
        """x: (d, n) radians (2 pi periodic); c: (C, n). Returns (C, *nf)."""
        import jax.numpy as jnp

        p = self.plan
        u = [
            jnp.mod(x[axis] / (2.0 * jnp.pi) * p.nf[axis], p.nf[axis])
            for axis in range(p.d)
        ]
        return self._grid(u, None, c)

    @_scoped("nufft_spread")
    def spread_ds(self, u_ds, c):
        """Spread from double-single grid coordinates (see Type1Executor)."""
        return self._grid(
            [u[0] for u in u_ds], [u[1] for u in u_ds], c
        )

    @_scoped("nufft_fft")
    def transform(self, g):
        return g  # the mode grid IS the accumulator; nothing to do

    @_scoped("nufft_gather")
    def gather(self, G, sel: np.ndarray | None = None):
        import jax.numpy as jnp

        p = self.plan
        idx = p.gather_idx if sel is None else p.gather_idx[sel]
        return G.reshape(G.shape[0], -1)[:, jnp.asarray(idx)]

    @_scoped("nufft_gather")
    def gather_padded(self, G, sel_pad: np.ndarray):
        import jax.numpy as jnp

        p = self.plan
        P, m_max = sel_pad.shape
        flat = G.reshape(P, -1, int(np.prod(p.nf)))
        idx = p.gather_idx[sel_pad]  # (P, m_max) host
        return jnp.take_along_axis(
            flat,
            jnp.broadcast_to(
                jnp.asarray(idx)[:, None, :], flat.shape[:2] + (m_max,)
            ),
            axis=2,
        )


def jax_complex(re, im):
    import jax

    return jax.lax.complex(re, im)


def pick_strip_width(nfx: int, target: int = 128) -> int:
    """Largest divisor of nfx that is <= ~1.5x the target strip width.

    The strip spreader needs strip | nfx so every window stays inside the
    padded grid; nfx is 5-smooth so good divisors always exist.
    """
    best = 1
    for d in range(1, nfx + 1):
        if nfx % d == 0 and d <= int(1.5 * target):
            best = d
    return best


class _TiledInterp:
    """Host-planned, gather-free 2D tap interpolation.

    The default tap evaluation gathers G at (m, w, w) index pairs. Since
    everything about the taps is static (targets are host data), this
    alternative (``FFTVIS_INTERP=tiled``) bins the targets into grid tiles
    AT PLAN TIME and each tile contracts a contiguous dynamic-slice window
    of the (wrap-padded) grid with host-built tap matrices -- matmuls and
    elementwise reductions only, no gather. The
    final reordering back to target order is a static-index take, which
    XLA compiles to plain copies.
    """

    def __init__(self, plan2d, sel=None, ity: int = 32, isx: int = 64):
        ti0 = plan2d.tap_idx[0] if sel is None else plan2d.tap_idx[0][sel]
        ti1 = plan2d.tap_idx[1] if sel is None else plan2d.tap_idx[1][sel]
        tv0 = plan2d.tap_val[0] if sel is None else plan2d.tap_val[0][sel]
        tv1 = plan2d.tap_val[1] if sel is None else plan2d.tap_val[1][sel]
        nfy, nfx = plan2d.nf
        w = plan2d.kernel.w
        m = ti0.shape[0]
        ity = min(ity, nfy)
        isx = min(isx, nfx)

        k0y = ti0[:, 0].astype(np.int64)  # window starts, already mod nf
        k0x = ti1[:, 0].astype(np.int64)
        tiy = k0y // ity
        tix = k0x // isx
        nty = -(-nfy // ity)
        ntx = -(-nfx // isx)
        tid = tiy * ntx + tix
        order = np.argsort(tid, kind="stable")
        tid_sorted = tid[order]
        uniq, counts = np.unique(tid_sorted, return_counts=True)
        T = uniq.size
        P = int(counts.max()) if T else 1

        self.w = w
        self.m = m
        self.T = T
        self.P = P
        self.ay = ity + w
        self.ax = isx + w
        self.nf = (int(nfy), int(nfx))
        # Wrap-pad must cover the LAST tile's window, not just w: when
        # nf % tile != 0 the final window ends at ntiles*tile + w > nf + w,
        # and a clamped dynamic_slice would silently shift every offset.
        self.pad_y = nty * ity + w - nfy
        self.pad_x = ntx * isx + w - nfx
        if self.pad_y > nfy or self.pad_x > nfx:
            raise ValueError("interp tile larger than the grid period")
        self.tile_y0 = (uniq // ntx * ity).astype(np.int32)
        self.tile_x0 = (uniq % ntx * isx).astype(np.int32)
        offy = np.zeros((T, P), dtype=np.int32)
        offx = np.zeros((T, P), dtype=np.int32)
        tvy = np.zeros((T, P, w), dtype=np.float64)
        tvx = np.zeros((T, P, w), dtype=np.float64)
        # Padding slots keep zero tap values -> contribute nothing.
        pos_of_target = np.zeros(m, dtype=np.int64)
        start = 0
        for t in range(T):
            c = counts[t]
            js = order[start : start + c]
            offy[t, :c] = k0y[js] - self.tile_y0[t]
            offx[t, :c] = k0x[js] - self.tile_x0[t]
            tvy[t, :c] = tv0[js]
            tvx[t, :c] = tv1[js]
            pos_of_target[js] = t * P + np.arange(c)
            start += c
        self.offy, self.offx, self.tvy, self.tvx = offy, offx, tvy, tvx
        self.pos_of_target = pos_of_target.astype(np.int32)

    def __call__(self, G):
        """G: (C', nfy, nfx) complex -> (C', m) complex."""
        import jax
        import jax.numpy as jnp

        nfy, nfx = self.nf
        w, T, P, ay, ax = self.w, self.T, self.P, self.ay, self.ax
        rdtype = jnp.finfo(G.dtype).dtype
        C = G.shape[0]
        # Real (re, im) planes: the tap matrices are real, so the
        # contractions stay real matmuls.
        Gr = jnp.concatenate([jnp.real(G), jnp.imag(G)], axis=0)  # (2C,.,.)
        # Wrap-pad so every tile window (through the last, possibly
        # grid-overhanging tile) is contiguous.
        Gr = jnp.concatenate([Gr, Gr[:, : self.pad_y, :]], axis=1)
        Gr = jnp.concatenate([Gr, Gr[:, :, : self.pad_x]], axis=2)

        iota_ay = jnp.arange(ay, dtype=jnp.int32)
        iota_ax = jnp.arange(ax, dtype=jnp.int32)
        tvy = jnp.asarray(self.tvy, dtype=rdtype)
        tvx = jnp.asarray(self.tvx, dtype=rdtype)
        offy = jnp.asarray(self.offy)
        offx = jnp.asarray(self.offx)
        y0s = jnp.asarray(self.tile_y0)
        x0s = jnp.asarray(self.tile_x0)

        def tile_body(_, t):
            win = jax.lax.dynamic_slice(
                Gr, (jnp.int32(0), y0s[t], x0s[t]), (2 * C, ay, ax)
            )
            # KY[p, a] = tvy[p, k] at a == offy[p] + k (static tap layout).
            ky = jnp.zeros((P, ay), dtype=rdtype)
            kx = jnp.zeros((P, ax), dtype=rdtype)
            for k in range(w):
                ky = ky + tvy[t, :, k, None] * (
                    iota_ay[None, :] == (offy[t, :, None] + k)
                )
                kx = kx + tvx[t, :, k, None] * (
                    iota_ax[None, :] == (offx[t, :, None] + k)
                )
            # (P, ay) @ (ay, 2C*ax) matmul, then an elementwise tap reduction.
            tmp = jax.lax.dot_general(
                ky,
                win.transpose(1, 0, 2).reshape(ay, 2 * C * ax),
                (((1,), (0,)), ((), ())),
                preferred_element_type=rdtype,
            ).reshape(P, 2 * C, ax)
            out_t = jnp.einsum("pcb,pb->cp", tmp, kx)  # (2C, P)
            return None, out_t

        _, outs = jax.lax.scan(
            tile_body, None, jnp.arange(T, dtype=jnp.int32)
        )  # (T, 2C, P)
        flat = outs.transpose(1, 0, 2).reshape(2 * C, T * P)
        res = flat[:, jnp.asarray(self.pos_of_target)]  # static take: copies
        return (res[:C] + 1j * res[C:]).astype(G.dtype)


class Type3Executor:
    """Split-phase type-3 execution for jitted pipelines.

    ``spread`` (pre-phase + pre-correction + ES spreading) is linear in the
    weights and accumulable across source blocks; ``transform`` runs the
    batched FFT + mode deconvolution once; ``interpolate`` evaluates any
    (static) subset of the planned targets -- the engine slices per beam
    pair (ref cpu_simulate.py:1030-1069 routes baselines by pair).

    ``strip_config = (strip_width, capacity)`` may be set by the planner to
    route large grids through the strip-binned spreader (the dense matmul
    spread is quadratic in grid size).
    """

    def __init__(self, plan: Type3Plan):
        self.plan = plan
        self.strip_config: tuple[int, int] | None = None
        # (tile_y, tile_x, capacity[, classes]) -- classes is the optional
        # balanced-occupancy schedule from the engine planner; a legacy
        # 3-tuple (no classes) is accepted and normalized by _spread_auto.
        self.tile_config: tuple | None = None
        self._interp_cache: dict = {}

    # Extra grid channels per weight channel (1 here; K for lowrank-z).
    channel_multiplier = 1

    def fresh_copy(self):
        """New executor over the same (immutable) plan, no shared mutables."""
        return type(self)(self.plan)

    def _tiled_interp(self, sel):
        """Host-planned gather-free interpolation (cached per target set)."""
        key = None if sel is None else np.asarray(sel).tobytes()
        ti = self._interp_cache.get(key)
        if ti is None:
            ti = _TiledInterp(self.plan, sel)
            self._interp_cache[key] = ti
        return ti

    @_scoped("nufft_spread")
    def spread(self, x, c):
        """x: (d, n) source coords within the planned extent; c: (C, n)."""
        import jax.numpy as jnp

        p = self.plan
        d, w, beta = p.d, p.kernel.w, p.kernel.beta
        cdtype = c.dtype
        rdtype = jnp.finfo(cdtype).dtype

        phase = sum(
            jnp.asarray(p.s_center[axis], dtype=rdtype) * x[axis] for axis in range(d)
        )
        corr = jnp.ones_like(x[0])
        for axis in range(d):
            corr = corr * _precorr_axis(p, axis, x[axis], rdtype, jnp)
        pre = (jnp.cos(phase) + 1j * jnp.sin(phase)).astype(cdtype) / corr
        wts = c * pre[None, :]

        u = [
            jnp.mod(x[axis] / jnp.asarray(p.h[axis], dtype=rdtype), p.nf[axis])
            for axis in range(d)
        ]
        return _spread_auto(
            u, wts, p.nf, w, beta,
            strip_config=self.strip_config, tile_config=self.tile_config,
        )

    @_scoped("nufft_spread")
    def spread_ds(self, x_ds, c):
        """Spread from double-single source coordinates.

        ``x_ds``: length-d list of (x_hi, x_lo) f32 pairs (the engine's DS
        coordinate chain). The pre-phase (|s_center . x| reaches 1e3-1e4
        rad) and the grid coordinates (|x/h| reaches 1e5 cells) are the
        two places plain f32 loses ~|value| * 2^-24; both are computed in
        two-float arithmetic here. The amplitude pre-correction is smooth
        and stays f32.
        """
        import jax.numpy as jnp

        from ..tpu import ds as _dsm

        p = self.plan
        d, w, beta = p.d, p.kernel.w, p.kernel.beta
        cdtype = c.dtype
        rdtype = jnp.finfo(cdtype).dtype

        ph = None
        for axis in range(d):
            sch, scl = _dsm.split64(np.float64(p.s_center[axis]))
            mh, ml = _dsm.ds_mul(
                jnp.asarray(sch, rdtype), jnp.asarray(scl, rdtype),
                x_ds[axis][0], x_ds[axis][1],
            )
            ph = (mh, ml) if ph is None else _dsm.ds_add(*ph, mh, ml)
        sn, cs = _dsm.ds_sincos(*ph)
        corr = jnp.ones_like(x_ds[0][0])
        for axis in range(d):
            corr = corr * _precorr_axis(p, axis, x_ds[axis][0], rdtype, jnp)
        pre = (cs + 1j * sn).astype(cdtype) / corr
        wts = c * pre[None, :]

        u_hi, u_lo = [], []
        for axis in range(d):
            ih, il = _dsm.split64(np.float64(1.0 / p.h[axis]))
            yh, yl = _dsm.ds_mul(
                x_ds[axis][0], x_ds[axis][1],
                jnp.asarray(ih, rdtype), jnp.asarray(il, rdtype),
            )
            uh, ul = _dsm.ds_mod_n(yh, yl, int(p.nf[axis]))
            u_hi.append(uh)
            u_lo.append(ul)
        return _spread_auto(
            u_hi, wts, p.nf, w, beta,
            strip_config=self.strip_config, tile_config=self.tile_config,
            u_lo_list=u_lo,
        )

    @_scoped("nufft_fft")
    def transform(self, g):
        import jax.numpy as jnp

        p = self.plan
        G = _forward_modes(g, p.nf)
        rdtype = jnp.finfo(G.dtype).dtype
        for axis in range(p.d):
            s = [1] * (1 + p.d)
            s[1 + axis] = p.nf[axis]
            G = G * jnp.asarray(p.deconv[axis], dtype=rdtype).reshape(s)
        return G

    @_scoped("nufft_interp")
    def interpolate(self, G, sel: np.ndarray | None = None):
        """Evaluate targets (optionally a static subset ``sel``) from G."""
        import jax.numpy as jnp

        p = self.plan
        if p.d == 2 and os.environ.get("FFTVIS_INTERP", "auto") == "tiled":
            return self._tiled_interp(sel)(G)
        rdtype = jnp.finfo(G.dtype).dtype
        ti = [t if sel is None else t[sel] for t in p.tap_idx]
        tv = [
            jnp.asarray(t if sel is None else t[sel], dtype=rdtype)
            for t in p.tap_val
        ]
        ti = [jnp.asarray(t) for t in ti]
        if p.d == 2:
            sub = G[:, ti[0][:, :, None], ti[1][:, None, :]]
            out = jnp.einsum("cmab,ma,mb->cm", sub, tv[0], tv[1])
        elif p.d == 3:
            sub = G[
                :,
                ti[0][:, :, None, None],
                ti[1][:, None, :, None],
                ti[2][:, None, None, :],
            ]
            out = jnp.einsum("cmabe,ma,mb,me->cm", sub, tv[0], tv[1], tv[2])
        elif p.d == 1:
            sub = G[:, ti[0]]
            out = jnp.einsum("cma,ma->cm", sub, tv[0])
        else:
            raise NotImplementedError(f"d={p.d}")
        return out.astype(G.dtype)


def make_type3_fn(plan: Type3Plan):
    """(x (d,n), c (C,n)) -> (C, m). One-shot convenience wrapper."""
    ex = Type3Executor(plan)

    def run(x, c):
        return ex.interpolate(ex.transform(ex.spread(x, c)))

    return run


class Type3LowrankZExecutor:
    """Split-phase 3D type-3 execution via the low-rank z factorization.

    Drop-in for :class:`Type3Executor` with d=3 source coordinates: the
    engine's spread -> (psum) -> transform -> interpolate pipeline is
    unchanged; grids simply carry C*K channels (``channel_multiplier``) and
    ``interpolate`` contracts the K z-modes with the host-planned target
    coefficients. ``.plan`` exposes the inner 2D plan so grid-size logic
    (strip-spreader config, memory estimates) sees the true 2D fine grid.
    """

    def __init__(self, zplan: Type3LowrankZPlan):
        self.zplan = zplan
        self.plan = zplan.plan2d
        self.strip_config: tuple[int, int] | None = None
        # (tile_y, tile_x, capacity[, classes]); see Type3Executor.
        self.tile_config: tuple | None = None
        self._interp_cache: dict = {}

    _tiled_interp = Type3Executor._tiled_interp

    @property
    def channel_multiplier(self) -> int:
        return self.zplan.K

    def fresh_copy(self):
        return type(self)(self.zplan)

    @_scoped("nufft_spread")
    def spread(self, x, c):
        """x: (3, n) source coords; c: (C, n). Returns (C*K, nf0, nf1)."""
        import jax.numpy as jnp

        p2 = self.plan
        zp = self.zplan
        w, beta = p2.kernel.w, p2.kernel.beta
        cdtype = c.dtype
        rdtype = jnp.finfo(cdtype).dtype

        # Pre-phase: 2D target centering plus the z-center factor; the
        # pre-correction (inverse kernel FT) applies to the spread axes only.
        phase = (
            jnp.asarray(p2.s_center[0], dtype=rdtype) * x[0]
            + jnp.asarray(p2.s_center[1], dtype=rdtype) * x[1]
            + jnp.asarray(zp.s_center_z, dtype=rdtype) * x[2]
        )
        corr = jnp.ones_like(x[0])
        for axis in range(2):
            corr = corr * _precorr_axis(p2, axis, x[axis], rdtype, jnp)
        pre = (jnp.cos(phase) + 1j * jnp.sin(phase)).astype(cdtype) / corr
        wts = c * pre[None, :]  # (C, n)

        # Chebyshev z-modes. Clamp: below-horizon / padding sources carry
        # zero weight but may sit outside [zlo, zhi], where T_k explodes.
        t = (x[2].astype(rdtype) - zp.x_center_z) / zp.x_half_z
        t = jnp.clip(t, -1.0, 1.0)
        K = zp.K
        cheb = [jnp.ones_like(t)]
        if K > 1:
            cheb.append(t)
        for _ in range(2, K):
            cheb.append(2.0 * t * cheb[-1] - cheb[-2])
        f = jnp.stack(cheb[:K])  # (K, n)

        C, n = wts.shape
        wts_k = (wts[:, None, :] * f[None, :, :]).reshape(C * K, n)

        u = [
            jnp.mod(x[axis] / jnp.asarray(p2.h[axis], dtype=rdtype), p2.nf[axis])
            for axis in range(2)
        ]
        return _spread_auto(
            u, wts_k, p2.nf, w, beta,
            strip_config=self.strip_config, tile_config=self.tile_config,
        )

    @_scoped("nufft_spread")
    def spread_ds(self, x_ds, c):
        """Spread from double-single coordinates (3 axes; see
        Type3Executor.spread_ds). The z factorization (Chebyshev modes,
        z pre-correction) is smooth in z and stays f32 on the hi part;
        the pre-phase (including the z-center term) and the 2D grid
        coordinates run in two-float arithmetic.
        """
        import jax.numpy as jnp

        from ..tpu import ds as _dsm

        p2 = self.plan
        zp = self.zplan
        w, beta = p2.kernel.w, p2.kernel.beta
        cdtype = c.dtype
        rdtype = jnp.finfo(cdtype).dtype

        centers = (p2.s_center[0], p2.s_center[1], zp.s_center_z)
        ph = None
        for axis in range(3):
            sch, scl = _dsm.split64(np.float64(centers[axis]))
            mh, ml = _dsm.ds_mul(
                jnp.asarray(sch, rdtype), jnp.asarray(scl, rdtype),
                x_ds[axis][0], x_ds[axis][1],
            )
            ph = (mh, ml) if ph is None else _dsm.ds_add(*ph, mh, ml)
        sn, cs = _dsm.ds_sincos(*ph)
        corr = jnp.ones_like(x_ds[0][0])
        for axis in range(2):
            corr = corr * _precorr_axis(p2, axis, x_ds[axis][0], rdtype, jnp)
        pre = (cs + 1j * sn).astype(cdtype) / corr
        wts = c * pre[None, :]

        t = (x_ds[2][0].astype(rdtype) - zp.x_center_z) / zp.x_half_z
        t = jnp.clip(t, -1.0, 1.0)
        K = zp.K
        cheb = [jnp.ones_like(t)]
        if K > 1:
            cheb.append(t)
        for _ in range(2, K):
            cheb.append(2.0 * t * cheb[-1] - cheb[-2])
        f = jnp.stack(cheb[:K])
        C, n = wts.shape
        wts_k = (wts[:, None, :] * f[None, :, :]).reshape(C * K, n)

        u_hi, u_lo = [], []
        for axis in range(2):
            ih, il = _dsm.split64(np.float64(1.0 / p2.h[axis]))
            yh, yl = _dsm.ds_mul(
                x_ds[axis][0], x_ds[axis][1],
                jnp.asarray(ih, rdtype), jnp.asarray(il, rdtype),
            )
            uh, ul = _dsm.ds_mod_n(yh, yl, int(p2.nf[axis]))
            u_hi.append(uh)
            u_lo.append(ul)
        return _spread_auto(
            u_hi, wts_k, p2.nf, w, beta,
            strip_config=self.strip_config, tile_config=self.tile_config,
            u_lo_list=u_lo,
        )

    @_scoped("nufft_fft")
    def transform(self, g):
        import jax.numpy as jnp

        p2 = self.plan
        G = _forward_modes(g, p2.nf)
        rdtype = jnp.finfo(G.dtype).dtype
        for axis in range(2):
            s = [1, 1, 1]
            s[1 + axis] = p2.nf[axis]
            G = G * jnp.asarray(p2.deconv[axis], dtype=rdtype).reshape(s)
        return G

    @_scoped("nufft_interp")
    def interpolate(self, G, sel: np.ndarray | None = None):
        """(C*K, nf0, nf1) -> (C, m[sel]): 2D taps then z-mode contraction."""
        import jax.numpy as jnp

        p2 = self.plan
        zp = self.zplan
        rdtype = jnp.finfo(G.dtype).dtype
        if os.environ.get("FFTVIS_INTERP", "auto") == "tiled":
            o = self._tiled_interp(sel)(G)  # (C*K, m)
            o_re, o_im = jnp.real(o), jnp.imag(o)
        else:
            ti = [t if sel is None else t[sel] for t in p2.tap_idx]
            tv = [
                jnp.asarray(t if sel is None else t[sel], dtype=rdtype)
                for t in p2.tap_val
            ]
            ti = [jnp.asarray(t) for t in ti]
            sub = G[:, ti[0][:, :, None], ti[1][:, None, :]]
            # Both the tap interpolation and the K-mode contraction run
            # in real arithmetic on (re, im) planes.
            o_re = jnp.einsum("cmab,ma,mb->cm", jnp.real(sub), tv[0], tv[1])
            o_im = jnp.einsum("cmab,ma,mb->cm", jnp.imag(sub), tv[0], tv[1])

        g_host = zp.g if sel is None else zp.g[sel]
        gr = jnp.asarray(np.ascontiguousarray(g_host.real), dtype=rdtype)
        gi = jnp.asarray(np.ascontiguousarray(g_host.imag), dtype=rdtype)
        K = zp.K
        o_re = o_re.reshape(o_re.shape[0] // K, K, o_re.shape[1])
        o_im = o_im.reshape(o_im.shape[0] // K, K, o_im.shape[1])
        res_re = jnp.einsum("ckm,mk->cm", o_re, gr) - jnp.einsum(
            "ckm,mk->cm", o_im, gi
        )
        res_im = jnp.einsum("ckm,mk->cm", o_re, gi) + jnp.einsum(
            "ckm,mk->cm", o_im, gr
        )
        return (res_re + 1j * res_im).astype(G.dtype)


def make_type3_lowrank_z_fn(zplan: Type3LowrankZPlan):
    """(x (3,n), c (C,n)) -> (C, m). One-shot convenience wrapper."""
    ex = Type3LowrankZExecutor(zplan)

    def run(x, c):
        return ex.interpolate(ex.transform(ex.spread(x, c)))

    return run


def _forward_modes(g, nf):
    """FFT with the +i sign convention: G_k = sum_m g_m e^{+2 pi i k m / nf}."""
    import jax.numpy as jnp

    d = len(nf)
    axes = tuple(range(1, 1 + d))
    return jnp.fft.ifftn(g, axes=axes) * float(np.prod(nf))


# Grid-size class of the dense forms (cost n * prod(nf)): the gridded path
# takes the exact separable DFT up to this many mode-grid cells.
DENSE_GRID_LIMIT = 512 * 512


def _spread_auto(
    u_list, weights, nf, w: int, beta: float, strip_config=None,
    tile_config=None, u_lo_list=None,
):
    """Spreading dispatch, trace-time static.

    ``FFTVIS_SPREADER=auto`` (the default) is XLA scatter-add on every
    backend: on an H100 at the forced-type-3 geometry it beat the dense
    matmul form 4-6x end to end, and a bin-sorted Pallas tile kernel won
    only at 4 channels (PERF.md). The other values force one lowering:
    ``scatter``, ``dense`` (two dense matmuls over the whole grid),
    ``ztaps`` (the 3D z-plane scan), and the capacity-planned XLA scans
    ``strip`` and ``tiled``, which need the planner's configuration. A
    forced lowering that cannot run this problem falls back to scatter.
    """
    mode = os.environ.get("FFTVIS_SPREADER", "auto")
    d = len(u_list)
    # The engine planner supplies a 4-tuple (ty, sx, cap, classes); accept
    # the documented legacy 3-tuple (FFTVIS_TILE workflows) as classes=None.
    if tile_config is not None and len(tile_config) == 3:
        tile_config = (*tile_config, None)
    # Every spreader consumes optional DS low parts through the shared
    # cell/frac decomposition (:func:`_split_cell_frac`), so the engine's
    # ds_coords accuracy win carries to every lowering.
    if mode == "strip" and d == 2 and strip_config is not None:
        return _spread_strip_matmul(u_list, weights, nf, w, beta,
                                    *strip_config, u_lo_list=u_lo_list)
    if mode == "tiled" and d == 2 and tile_config is not None:
        return _spread_tiled_matmul(u_list, weights, nf, w, beta,
                                    *tile_config, u_lo_list=u_lo_list)
    if mode == "dense" and d == 2:
        return _spread_dense_matmul(u_list, weights, nf, w, beta,
                                    u_lo_list=u_lo_list)
    if mode == "ztaps" and d == 3:
        return _spread_3d_ztaps(u_list, weights, nf, w, beta,
                                u_lo_list=u_lo_list)
    return _spread_scatter(u_list, weights, nf, w, beta, u_lo_list=u_lo_list)


def _spread_strip_matmul(
    u_list,
    weights,
    nf,
    w: int,
    beta: float,
    strip: int,
    capacity: int,
    u_lo_list=None,
):
    """2D ES spreading via x-strip binning + per-strip matmuls.

    The dense-matmul spreader costs n * nfy * nfx per channel -- fine for
    small grids, quadratic pain for large type-3 grids. This variant
    sorts sources into ``nfx / strip`` x-strips (device argsort), then runs
    one (nfy x P) @ (P x 2C*(strip+w+2)) matmul per strip into a dynamic
    window of the grid, cutting the x-extent of every product from nfx to
    strip+w+2.

    ``capacity`` is the static per-strip source capacity; the caller must
    guarantee no strip holds more (the engine derives a rigorous bound from
    a host-side sliding-window count). Periodic wraps in x are handled with
    pad columns folded back afterwards; y uses periodic distances directly.
    """
    import os

    import jax
    import jax.numpy as jnp

    nfy, nfx = int(nf[0]), int(nf[1])
    C, n = weights.shape
    c2 = 2 * C
    rdtype = jnp.finfo(jnp.result_type(weights, 0.0)).dtype
    uy = u_list[0].astype(rdtype)
    ux = u_list[1].astype(rdtype)
    # Cell/frac decomposition (optionally DS-refined): kernel arguments are
    # then formed as integer-exact distances minus a ~ulp(1) fraction, so
    # position accuracy no longer degrades as ulp(nf) on large grids.
    cy, fy = _split_cell_frac(
        uy, None if u_lo_list is None else u_lo_list[0].astype(rdtype), jnp
    )
    cx, fx = _split_cell_frac(
        ux, None if u_lo_list is None else u_lo_list[1].astype(rdtype), jnp
    )

    nstrips = -(-nfx // strip)
    P = int(capacity)
    margin = w + 2
    XW = strip + 2 * margin  # window: strip plus kernel halo each side

    sid = jnp.clip((ux // strip).astype(jnp.int32), 0, nstrips - 1)
    order = jnp.argsort(sid)
    sid_sorted = sid[order]
    # CSR offsets per strip.
    starts = jnp.searchsorted(sid_sorted, jnp.arange(nstrips, dtype=jnp.int32))
    ends = jnp.searchsorted(
        sid_sorted, jnp.arange(1, nstrips + 1, dtype=jnp.int32)
    )
    pos = starts[:, None] + jnp.arange(P, dtype=jnp.int32)[None, :]
    valid = pos < ends[:, None]  # (nstrips, P)
    idx = order[jnp.clip(pos, 0, n - 1)]  # (nstrips, P)

    if os.environ.get("FFTVIS_DEBUG"):
        # Capacity overflow silently drops sources (pos is clipped above);
        # the engine's host-side bound should make this impossible, so the
        # check is debug-only to keep it off the hot path.
        def _check_capacity(maxcount, cap=P):
            if int(maxcount) > cap:
                raise RuntimeError(
                    f"strip spreader capacity overflow: a strip holds "
                    f"{int(maxcount)} sources > capacity {cap}; "
                    f"sources were dropped"
                )

        jax.debug.callback(_check_capacity, (ends - starts).max())

    vals = jnp.concatenate([jnp.real(weights), jnp.imag(weights)], axis=0)
    rows = jnp.arange(nfy, dtype=rdtype)

    def strip_body(grid, s_inp):
        s, idx_s, valid_s = s_inp
        cy_s = cy[idx_s]
        fy_s = fy[idx_s]
        cx_s = cx[idx_s]
        fx_s = fx[idx_s]
        v_s = vals[:, idx_s] * valid_s[None, :].astype(rdtype)  # (2C, P)

        # rows - cy is integer-exact, as is the periodic fold of it; the
        # ~ulp(1) fraction is subtracted last (see _split_cell_frac).
        dy = rows[:, None] - cy_s[None, :]
        dy = dy - nfy * jnp.round(dy / nfy) - fy_s[None, :]
        ky = es_kernel_grid(dy, w, beta, xp=jnp)  # (nfy, P)

        x0 = s * strip - margin  # window start (signed; pad handles edges)
        cols = x0.astype(rdtype) + jnp.arange(XW, dtype=rdtype)
        kx = es_kernel_grid(
            (cols[None, :] - cx_s[:, None]) - fx_s[:, None], w, beta, xp=jnp
        )

        rhs = (kx[:, None, :] * v_s.T[:, :, None]).reshape(P, c2 * XW)
        patch = ky @ rhs  # (nfy, 2C*XW)
        patch = patch.reshape(nfy, c2, XW)

        start = (x0 + margin).astype(jnp.int32)  # padded-grid position, >= 0
        zero = jnp.int32(0)
        cur = jax.lax.dynamic_slice(grid, (zero, zero, start), (nfy, c2, XW))
        grid = jax.lax.dynamic_update_slice(grid, cur + patch, (zero, zero, start))
        return grid, None

    grid0 = jnp.zeros((nfy, c2, nfx + 2 * margin), dtype=rdtype)
    grid, _ = jax.lax.scan(
        strip_body, grid0, (jnp.arange(nstrips, dtype=jnp.int32), idx, valid)
    )

    # Fold the pad columns back periodically.
    core = grid[:, :, margin : margin + nfx]
    core = core.at[:, :, nfx - margin :].add(grid[:, :, :margin])
    core = core.at[:, :, :margin].add(grid[:, :, margin + nfx :])

    out = core.transpose(1, 0, 2)  # (2C, nfy, nfx)
    return (out[:C] + 1j * out[C:]).astype(weights.dtype)


def _spread_3d_ztaps(u_list, weights, nf, w: int, beta: float,
                     u_lo_list=None):
    """3D ES spreading as a scan of 2D dense-matmul spreads over z-planes.

    For each plane p of the LAST grid axis, every source contributes its
    full 2D tap patch weighted by psi(periodic distance of p to u_z) -- zero
    outside the kernel support, so this is exact. Near-coplanar arrays have
    a small z grid (the type-3 planner sizes nf_z from the tiny w-extent),
    making the nf_z x (2D spread) cost acceptable. Selected by
    FFTVIS_SPREADER=ztaps; the default for d == 3 is the scatter.
    """
    import jax
    import jax.numpy as jnp

    nf0, nf1, nf2 = int(nf[0]), int(nf[1]), int(nf[2])
    C = weights.shape[0]
    rdtype = jnp.finfo(jnp.result_type(weights, 0.0)).dtype
    uz = u_list[2].astype(rdtype)
    cz, fz = _split_cell_frac(
        uz, None if u_lo_list is None else u_lo_list[2].astype(rdtype), jnp
    )
    u_lo_2d = None if u_lo_list is None else u_lo_list[:2]

    def plane(_, p):
        dz = p.astype(rdtype) - cz
        dz = dz - nf2 * jnp.round(dz / nf2) - fz
        kz = es_kernel_grid(dz, w, beta, xp=jnp)  # (n,)
        wp = weights * kz[None, :]
        g2 = _spread_dense_matmul(u_list[:2], wp, (nf0, nf1), w, beta,
                                  u_lo_list=u_lo_2d)
        return None, g2  # (C, nf0, nf1)

    _, planes = jax.lax.scan(plane, None, jnp.arange(nf2))
    return jnp.moveaxis(planes, 0, -1)  # (C, nf0, nf1, nf2)


def pick_tile_shape(nf, w: int, c2: int):
    """(TY, SX) tile shape for the 2D tiled spreader.

    The per-tile matmul is (TYW, P) @ (P, c2 * XW) with TYW = TY + w + 2
    rounded up to a multiple of 8 and XW = SX + w + 2; smaller tiles track
    clustered source densities better (lower per-tile capacity slack) at
    the price of a larger halo fraction. Override with FFTVIS_TILE=ty,sx
    for experiments.
    """
    import os

    env = os.environ.get("FFTVIS_TILE")
    if env:
        ty, sx = (int(v) for v in env.split(","))
        return ty, sx
    nfy, nfx = int(nf[0]), int(nf[1])
    # Taller tiles halve the per-step dispatch count; the balanced-
    # occupancy class schedule absorbs the occupancy-slack penalty that
    # would favor small tiles. Not tuned on the GPU.
    ty = 64 if nfy >= 128 else max(8, nfy)
    sx = max(16, min(128 - w - 2, nfx))
    return ty, sx


def _spread_tiled_matmul(
    u_list,
    weights,
    nf,
    w: int,
    beta: float,
    ty: int,
    sx: int,
    capacity: int,
    classes=None,
    u_lo_list=None,
):
    """2D ES spreading via (y, x) tile binning + per-tile matmuls.

    Generalizes :func:`_spread_strip_matmul` (x strips, dense in y) by also
    binning the y axis: each source is assigned to one (TY, SX) tile of the
    grid by its coordinates, and the tile's (TYW, P) @ (P, c2*XW) matmul
    covers every assigned source's full kernel patch (TYW = TY + w + 2
    rounded up to a multiple of 8, XW = SX + w + 2). Work per source drops
    from nfy * XW (strip) to TYW * XW -- the decisive factor for large
    type-3 grids, where the strip form is ~nfy/TYW = 10-40x more FLOPs.

    ``capacity`` bounds the source count of ANY tile (engine-derived from
    the exactly-known rotated coordinates, like the strip bound). Edge and
    periodic wraps are handled by padding the grid on all sides and folding
    the pads back at the end.

    ``classes`` (optional) is a balanced-occupancy schedule: a sequence of
    ``(tile_ids, cap)`` with per-class capacities, host-planned from
    per-tile occupancy bounds. Skies clustered in transform space (every
    horizon-to-horizon sky is: the sin-projection piles sources at the rim)
    make the global capacity 5-20x the mean tile count, and per-tile work
    is proportional to capacity regardless of occupancy -- one scan per
    class restores near-proportional total work. Tiles absent from every
    class are provably empty and are never scanned at all.
    """
    import os

    import jax
    import jax.numpy as jnp

    nfy, nfx = int(nf[0]), int(nf[1])
    C, n = weights.shape
    c2 = 2 * C
    rdtype = jnp.finfo(jnp.result_type(weights, 0.0)).dtype
    uy = u_list[0].astype(rdtype)
    ux = u_list[1].astype(rdtype)

    m = w // 2 + 2  # kernel halo + rounding slack per side
    nty = -(-nfy // ty)
    ntx = -(-nfx // sx)
    ntiles = nty * ntx
    P = int(capacity)
    tyw = -(-(ty + 2 * m) // 8) * 8  # row window, a multiple of 8
    xw = sx + 2 * m

    # Assembled frame: all tiles plus an m halo on every side. Row r of the
    # grid lives at frame index r + m.
    hw = ty + 2 * m  # nonzero window height (kernel support; tyw is padded)
    gy = nty * ty + 2 * m
    gx = ntx * sx + 2 * m
    pad_y_hi = gy - m - nfy
    pad_x_hi = gx - m - nfx
    if pad_y_hi > nfy or pad_x_hi > nfx or m > nfy or m > nfx:
        # Pads would wrap more than one period: grid too small for tiling.
        return _spread_dense_matmul(u_list, weights, nf, w, beta,
                                    u_lo_list=u_lo_list)

    tiy = jnp.clip((uy // ty).astype(jnp.int32), 0, nty - 1)
    tix = jnp.clip((ux // sx).astype(jnp.int32), 0, ntx - 1)
    tid = tiy * ntx + tix

    # Bin-sort with the payload PACKED into wide rows: instead of per-tile
    # index gathers (uy[idx], vals[:, idx]), sort once, apply the
    # permutation as ONE row-gather of a (n, D) matrix (wide rows amortize
    # the gather), and slice each tile's sources CONTIGUOUSLY.
    vals = jnp.concatenate(
        [jnp.real(weights), jnp.imag(weights)], axis=0
    ).astype(rdtype)  # (c2, n)
    iota = jnp.arange(n, dtype=jnp.int32)
    tid_sorted, perm = jax.lax.sort((tid, iota), num_keys=1)
    # Pack the cell/frac decomposition (optionally DS-refined) instead of
    # the raw coordinates: kernel arguments in the tile body become
    # integer-exact distances minus a ~ulp(1) fraction, so position
    # accuracy no longer degrades as ulp(nf) on large grids.
    cy, fy = _split_cell_frac(
        uy, None if u_lo_list is None else u_lo_list[0].astype(rdtype), jnp
    )
    cx, fx = _split_cell_frac(
        ux, None if u_lo_list is None else u_lo_list[1].astype(rdtype), jnp
    )
    packed = jnp.concatenate(
        [cy[None], fy[None], cx[None], fx[None], vals], axis=0
    ).T  # (n, D)
    packed_sorted = jnp.take(packed, perm, axis=0)
    # Pad P zero rows so per-tile dynamic slices never clamp near the end.
    packed_sorted = jnp.concatenate(
        [packed_sorted, jnp.zeros((P, packed.shape[1]), dtype=rdtype)], axis=0
    )
    starts = jnp.searchsorted(tid_sorted, jnp.arange(ntiles, dtype=jnp.int32))
    ends = jnp.searchsorted(
        tid_sorted, jnp.arange(1, ntiles + 1, dtype=jnp.int32)
    ).astype(jnp.int32)
    starts = starts.astype(jnp.int32)

    if classes is None:
        classes = ((np.arange(ntiles, dtype=np.int64), P),)
    class_ids = [np.asarray(ids, dtype=np.int64) for ids, _ in classes]
    class_caps = [min(int(cap), P) for _, cap in classes]
    tids_all = np.concatenate(class_ids)

    if os.environ.get("FFTVIS_DEBUG"):

        def _check_capacity(maxcount, cap, label):
            if int(maxcount) > int(cap):
                raise RuntimeError(
                    f"tiled spreader capacity overflow ({label}): a tile "
                    f"holds {int(maxcount)} sources > capacity {int(cap)}; "
                    f"sources were dropped"
                )

        counts = ends - starts
        for ci, (ids, cap_c) in enumerate(zip(class_ids, class_caps)):
            jax.debug.callback(
                _check_capacity, counts[ids].max(), cap_c, f"class {ci}"
            )
        uncovered = np.setdiff1d(np.arange(ntiles), tids_all)
        if uncovered.size:
            jax.debug.callback(
                _check_capacity, counts[uncovered].max(), 0, "unscanned tiles"
            )

    rows_rel = jnp.arange(tyw, dtype=rdtype)
    cols_rel = jnp.arange(xw, dtype=rdtype)

    def make_tile_body(Pc: int):
        lane = jnp.arange(Pc, dtype=jnp.int32)

        def tile_body(_, t_inp):
            t, s0, e0 = t_inp
            y0 = (t // ntx) * ty - m  # window origin (absolute rows, signed)
            x0 = (t % ntx) * sx - m
            sl = jax.lax.dynamic_slice(
                packed_sorted, (s0, jnp.int32(0)), (Pc, packed.shape[1])
            )  # (Pc, D) contiguous
            live = ((s0 + lane) < e0).astype(rdtype)  # (Pc,)
            cy_t = sl[:, 0]
            fy_t = sl[:, 1]
            cx_t = sl[:, 2]
            fx_t = sl[:, 3]
            v_t = sl[:, 4:].T * live[None, :]  # (c2, Pc)

            # (rows + y0) - cell is integer-exact; the ~ulp(1) fraction is
            # subtracted last (no periodic fold here -- pads handle wraps).
            ky = es_kernel_grid(
                ((rows_rel[:, None] + y0.astype(rdtype)) - cy_t[None, :])
                - fy_t[None, :],
                w, beta, xp=jnp,
            )  # (tyw, Pc)
            # Kill padding/overflow columns in ky too: zero coordinates can
            # otherwise alias onto real grid rows when y0 is near the origin.
            ky = ky * live[None, :]
            kx = es_kernel_grid(
                ((cols_rel[None, :] + x0.astype(rdtype)) - cx_t[:, None])
                - fx_t[:, None],
                w, beta, xp=jnp,
            )  # (Pc, xw)

            rhs = (kx[:, None, :] * v_t.T[:, :, None]).reshape(Pc, c2 * xw)
            patch = (ky @ rhs).reshape(tyw, c2, xw)
            # Rows beyond the kernel-support window are identically zero
            # (tyw is rounded up to 8); drop them for the assembly.
            return None, patch[:hw]

        return tile_body

    class_patches = []
    for ids, cap_c in zip(class_ids, class_caps):
        _, pc = jax.lax.scan(
            make_tile_body(cap_c),
            None,
            (
                jnp.asarray(ids.astype(np.int32)),
                starts[ids],
                ends[ids],
            ),
        )  # (len(ids), hw, c2, xw)
        class_patches.append(pc)
    patches = (
        class_patches[0]
        if len(class_patches) == 1
        else jnp.concatenate(class_patches, axis=0)
    )
    if not (tids_all.size == ntiles and np.array_equal(tids_all, np.arange(ntiles))):
        # Restore lattice tile order with one static take; tiles covered by
        # no class are provably empty (host-bounded occupancy 0) and pull a
        # shared zero row.
        zero = jnp.zeros((1,) + tuple(patches.shape[1:]), dtype=rdtype)
        pool = jnp.concatenate([patches, zero], axis=0)
        inv = np.full(ntiles, tids_all.size, dtype=np.int64)
        inv[tids_all] = np.arange(tids_all.size)
        patches = pool[inv]
    patches = patches.reshape(nty, ntx, hw, c2, xw)

    # Overlap-add assembly. A scan-carried dynamic-update-slice accumulator
    # forces XLA to copy the whole grid every step (no in-place update for
    # a batched carry); instead the regular tile lattice lets each of the
    # 3x3 (core/halo) segment sets be placed DISJOINTLY by pad+reshape and
    # summed -- pure dense ops, no scatter, no dynamic updates.
    segs_y = ((0, m, 0), (m, ty, m), (m + ty, m, ty + m))  # (src, h, dst)
    segs_x = ((0, m, 0), (m, sx, m), (m + sx, m, sx + m))
    grid = jnp.zeros((c2, gy, gx), dtype=rdtype)
    for sy, hy, oy in segs_y:
        for sxo, hx, ox in segs_x:
            seg = patches[:, :, sy : sy + hy, :, sxo : sxo + hx]
            seg = seg.transpose(3, 0, 2, 1, 4)  # (c2, nty, hy, ntx, hx)
            seg = jnp.pad(
                seg, ((0, 0), (0, 0), (0, ty - hy), (0, 0), (0, sx - hx))
            )
            seg = seg.reshape(c2, nty * ty, ntx * sx)
            # The last tile's zero padding may overhang the frame; the
            # content itself always fits. Trim zeros, then place.
            seg = seg[:, : min(nty * ty, gy - oy), : min(ntx * sx, gx - ox)]
            seg = jnp.pad(
                seg,
                (
                    (0, 0),
                    (oy, gy - oy - seg.shape[1]),
                    (ox, gx - ox - seg.shape[2]),
                ),
            )
            grid = grid + seg

    return _fold_frame(grid, nfy, nfx, m, C, weights.dtype)


def _fold_frame(grid, nfy: int, nfx: int, m: int, C: int, out_dtype):
    """Fold an m-padded (2C, nfy+2m', nfx+2m'') frame back periodically.

    ``grid`` is the assembled overlap-add frame: real/imag channel planes of
    the fine grid with an ``m``-column/row pad on the low sides and whatever
    the tile lattice left on the high sides (< one period by the callers'
    guards). Shared by the XLA tiled and strip spreaders.
    """
    import jax.numpy as jnp  # noqa: F401  (callers pass jnp arrays)

    core = grid[:, m : m + nfy, m : m + nfx]
    # y: low pad rows [0, m) belong to rows nfy-m..; high pad to rows 0..
    core = core.at[:, nfy - m :, :].add(grid[:, :m, m : m + nfx])
    hi_y = grid[:, m + nfy :, m : m + nfx]
    core = core.at[:, : hi_y.shape[1], :].add(hi_y)
    # x folds (using y-folded pads would double-count; fold x pads over the
    # full padded y extent first, then fold y of the x-pads separately).
    left_x = grid[:, :, :m]
    right_x = grid[:, :, m + nfx :]
    lx = left_x[:, m : m + nfy]
    lx = lx.at[:, nfy - m :].add(left_x[:, :m])
    lx_hi = left_x[:, m + nfy :]
    lx = lx.at[:, : lx_hi.shape[1]].add(lx_hi)
    rx = right_x[:, m : m + nfy]
    rx = rx.at[:, nfy - m :].add(right_x[:, :m])
    rx_hi = right_x[:, m + nfy :]
    rx = rx.at[:, : rx_hi.shape[1]].add(rx_hi)
    core = core.at[:, :, nfx - m :].add(lx)
    core = core.at[:, :, : rx.shape[2]].add(rx)

    return (core[:C] + 1j * core[C:]).astype(out_dtype)


def _split_cell_frac(u, u_lo, xp):
    """Decompose a (possibly DS) grid coordinate into (integer cell, frac).

    ``u - floor(u)`` is exact in f32 (Sterbenz), so adding the DS low part
    afterwards keeps the FRACTIONAL position accurate to ~ulp(1) even when
    ``u`` itself is large (ulp(u) reaches 0.01 cells on 1e5-cell grids) --
    the fp32 NUFFT's dominant phase-error term.
    """
    cell = xp.floor(u)
    frac = u - cell
    if u_lo is not None:
        frac = frac + u_lo
    return cell, frac


def _spread_dense_matmul(u_list, weights, nf, w: int, beta: float,
                         u_lo_list=None):
    """2D ES spreading as two dense matmuls.

    grid[c, y, x] = sum_j psi_per(y - uy_j) * psi_per(x - ux_j) * w[c, j]

    computed as  Ky(nfy, n) @ RHS(n, 2C*nfx)  in f32 re/im planes, where
    psi_per uses the periodic grid distance (both wraps handled for free)
    and RHS carries kx * weight. FLOPs are n * nfy * 2C * nfx * 2, and it
    is exact (psi vanishes outside its support). On an H100 at the
    forced-type-3 grid (1200 x 576) it ran 4-6x slower end to end than the
    scatter default (PERF.md); selected by FFTVIS_SPREADER=dense.

    ``u_lo_list`` optionally supplies double-single low parts of the
    coordinates; distances are then formed cell/frac-exactly so the
    kernel argument keeps ~ulp(1) position accuracy at any grid size.
    """
    import jax.numpy as jnp

    nfy, nfx = int(nf[0]), int(nf[1])
    C, n = weights.shape
    rdtype = jnp.finfo(jnp.result_type(weights, 0.0)).dtype
    uy = u_list[0].astype(rdtype)
    ux = u_list[1].astype(rdtype)
    uy_lo = None if u_lo_list is None else u_lo_list[0].astype(rdtype)
    ux_lo = None if u_lo_list is None else u_lo_list[1].astype(rdtype)

    rows = jnp.arange(nfy, dtype=rdtype)
    cols = jnp.arange(nfx, dtype=rdtype)
    cy, fy = _split_cell_frac(uy, uy_lo, jnp)
    cx, fx = _split_cell_frac(ux, ux_lo, jnp)
    # Integer-exact periodic cell distance, then subtract the frac part:
    # the result carries ~ulp(w/2) error instead of ~ulp(nf).
    dy = rows[:, None] - cy[None, :]
    dy = dy - nfy * jnp.round(dy / nfy) - fy[None, :]
    ky = es_kernel_grid(dy, w, beta, xp=jnp)  # (nfy, n)
    dx = cols[None, :] - cx[:, None]
    dx = dx - nfx * jnp.round(dx / nfx) - fx[:, None]
    kx = es_kernel_grid(dx, w, beta, xp=jnp)  # (n, nfx)

    vals = jnp.concatenate([jnp.real(weights), jnp.imag(weights)], axis=0)
    # RHS: (n, 2C, nfx) -> (n, 2C*nfx)
    rhs = (kx[:, None, :] * vals.T[:, :, None]).reshape(n, 2 * C * nfx)
    flat = ky @ rhs  # (nfy, 2C*nfx)
    grid = flat.reshape(nfy, 2 * C, nfx).transpose(1, 0, 2)
    return (grid[:C] + 1j * grid[C:]).astype(weights.dtype)


def _spread_scatter(u_list, weights, nf, w: int, beta: float,
                    u_lo_list=None):
    """ES-kernel spreading via XLA scatter-add.

    Parameters
    ----------
    u_list
        Per-dim source grid coordinates in [0, nf_d), length d, each (n,).
    weights
        (C, n) complex strengths.
    u_lo_list
        Optional double-single low parts (see :func:`_split_cell_frac`).

    Returns
    -------
    (C, *nf) complex fine grid.

    This is the portable path; accelerators route large problems through
    :func:`_spread_tiled_matmul` instead.
    """
    import jax.numpy as jnp

    d = len(u_list)
    n = u_list[0].shape[0]
    C = weights.shape[0]
    offs = jnp.arange(w)

    idx_dim = []
    val_dim = []
    for axis in range(d):
        u = u_list[axis]
        u_lo = None if u_lo_list is None else u_lo_list[axis]
        cell, frac = _split_cell_frac(u, u_lo, jnp)
        # Centered window: offsets stay in (-w/2, w/2] for odd and even w.
        i0 = jnp.ceil(u - w / 2.0).astype(jnp.int32)
        ii = i0[:, None] + offs[None, :]  # (n, w) signed
        # cell - ii is integer-exact; + frac keeps ~ulp(1) accuracy.
        t = (cell[:, None] - ii.astype(cell.dtype)) + frac[:, None]
        val = es_kernel_grid(t, w, beta, xp=jnp)
        idx_dim.append(jnp.mod(ii, nf[axis]))
        val_dim.append(val.astype(jnp.real(weights).dtype))

    if d == 1:
        flat_idx = idx_dim[0]  # (n, w)
        vals = val_dim[0]
    elif d == 2:
        flat_idx = idx_dim[0][:, :, None] * nf[1] + idx_dim[1][:, None, :]
        vals = val_dim[0][:, :, None] * val_dim[1][:, None, :]
        flat_idx = flat_idx.reshape(n, w * w)
        vals = vals.reshape(n, w * w)
    elif d == 3:
        flat_idx = (
            (idx_dim[0][:, :, None, None] * nf[1] + idx_dim[1][:, None, :, None])
            * nf[2]
            + idx_dim[2][:, None, None, :]
        ).reshape(n, w**3)
        vals = (
            val_dim[0][:, :, None, None]
            * val_dim[1][:, None, :, None]
            * val_dim[2][:, None, None, :]
        ).reshape(n, w**3)
    else:
        raise NotImplementedError(f"d={d}")

    ntot = int(np.prod(nf))
    g = jnp.zeros((C, ntot), dtype=weights.dtype)
    # (C, n, w^d) contributions scattered along the flattened grid axis.
    contrib = weights[:, :, None] * vals[None, :, :]
    g = g.at[:, flat_idx.reshape(-1)].add(contrib.reshape(C, -1))
    return g.reshape((C,) + tuple(nf))
