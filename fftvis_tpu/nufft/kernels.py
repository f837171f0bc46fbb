"""Exponential-of-semicircle (ES) spreading kernel: parameters and transforms.

The reference delegates all of this to finufft (C++/OpenMP; ref
/root/reference/src/fftvis/cpu/nufft.py). Here the kernel itself is
implemented from the published math (Barnett et al., arXiv:1808.06736;
aliasing analysis arXiv:2001.09405):

    phi(z) = exp(beta * (sqrt(1 - z^2) - 1)),   |z| <= 1
    psi(t) = phi(2 t / w),                      |t| <= w/2   (grid units)

Width/beta selection follows the finufft heuristics so that ``eps`` has the
same meaning as in the reference API:

    sigma == 2   : w = ceil(log10(1/eps)) + 1
    sigma other  : w = ceil(log(1/eps) / (pi * sqrt(1 - 1/sigma)))
    beta ~= pi * w * (1 - 1/(2 sigma)) * gamma   (gamma ~ 0.97-0.98)

The kernel's Fourier transform has no closed form; it is evaluated with
Gauss-Legendre quadrature (exact for the smooth integrand at the node counts
used here), on host for mode-grid deconvolution and on device (jnp) for
type-3 source-position pre-correction.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

MAX_WIDTH = 16
MIN_WIDTH = 2

# Quadrature order for the kernel Fourier transform. The integrand is
# exp(beta sqrt(1-z^2)) cos(a z) with |a| <= pi/sigma * w/2 <~ 26; 80 nodes
# hold ~1e-15 accuracy over the full range.
_QUAD_NODES = 80


def kernel_width(eps: float, sigma: float) -> int:
    """Kernel half-support in grid points for target accuracy ``eps``."""
    if sigma == 2.0:
        w = int(np.ceil(np.log10(1.0 / eps))) + 1
    else:
        # Low-upsampling kernels lose ~half a digit in practice; widen by one.
        w = 1 + int(
            np.ceil(np.log(1.0 / eps) / (np.pi * np.sqrt(1.0 - 1.0 / sigma)))
        )
    return int(np.clip(w, MIN_WIDTH, MAX_WIDTH))


def kernel_beta(w: int, sigma: float) -> float:
    """ES kernel sharpness parameter."""
    if sigma == 2.0:
        gamma_w = {2: 2.20, 3: 2.26, 4: 2.38}.get(w, 2.30)
        return gamma_w * w
    return float(np.pi * w * (1.0 - 1.0 / (2.0 * sigma)) * 0.976)


@dataclass(frozen=True)
class ESKernel:
    """ES kernel configuration for one transform."""

    w: int
    beta: float
    sigma: float
    eps: float

    @classmethod
    def from_eps(cls, eps: float, sigma: float = 2.0) -> "ESKernel":
        if sigma not in (1.25, 2.0):
            raise ValueError("upsample_factor (sigma) must be 1.25 or 2")
        w = kernel_width(eps, sigma)
        return cls(w=w, beta=kernel_beta(w, sigma), sigma=sigma, eps=eps)


def es_kernel(z, beta: float, xp=np):
    """phi(z) on |z|<=1, zero outside. Works for np or jnp arrays."""
    inside = xp.abs(z) < 1.0
    safe = xp.where(inside, z, 0.0)
    val = xp.exp(beta * (xp.sqrt(1.0 - safe * safe) - 1.0))
    return xp.where(inside, val, 0.0)


def es_kernel_grid(t, w: int, beta: float, xp=np):
    """psi(t) = phi(2t/w) for offsets t in grid units."""
    return es_kernel(2.0 * t / w, beta, xp=xp)


@functools.lru_cache(maxsize=None)
def _gl_nodes(n: int) -> tuple[tuple[float, ...], tuple[float, ...]]:
    x, wts = np.polynomial.legendre.leggauss(n)
    return tuple(x), tuple(wts)


def es_kernel_ft(xi, w: int, beta: float, xp=np):
    """Fourier transform of the grid-unit kernel, psi_hat(xi).

    psi_hat(xi) = int_{-w/2}^{w/2} psi(t) e^{-i xi t} dt
                = (w/2) * int_{-1}^{1} e^{beta(sqrt(1-z^2)-1)} cos(xi w z / 2) dz

    ``xi`` is in radians per grid point. Accepts np or jnp arrays; returns
    a real array of the same shape.
    """
    nodes, weights = _gl_nodes(_QUAD_NODES)
    xi = xp.asarray(xi)
    # Under jnp the quadrature table must follow xi's dtype: asarray of
    # float64 host constants with jax_enable_x64 on yields f64 arrays,
    # silently upcasting an fp32 pipeline's weights to complex128 (carry
    # dtype crash in the engine scan).
    dt = np.float64 if xp is np else xi.dtype
    z = xp.asarray(nodes, dtype=dt)
    q = xp.asarray(weights, dtype=dt)
    envelope = xp.exp(beta * (xp.sqrt(1.0 - z * z) - 1.0)) * q
    phases = xi[..., None] * (0.5 * w) * z  # (..., nq)
    return (0.5 * w) * xp.sum(xp.cos(phases) * envelope, axis=-1)


def fit_log_ft_cheb(
    w: int,
    beta: float,
    xi_max: float,
    tol: float = 3e-7,
    degrees: tuple = (12, 16, 20, 24, 32, 40),
):
    """Host-side Chebyshev fit of log(psi_hat) over |xi| <= xi_max.

    The type-3 amplitude pre-correction divides per-source weights by
    psi_hat(x * ds) -- a smooth, even, positive function over the planned
    coordinate extent. Evaluating it with the 80-node quadrature costs 80
    cos + 80 FMA per (source, axis) on device; a degree-~20 Chebyshev of
    log(psi_hat) in t = 2 (xi/xi_max)^2 - 1 is ~8x fewer flops and one
    exp. Fitting the LOG keeps the error RELATIVE across psi_hat's decay.

    Returns float64 Chebyshev coefficients, or None when the fit cannot
    reach ``tol`` (caller falls back to the quadrature) or psi_hat is not
    strictly positive on the domain (cannot happen inside the accurate
    band, but guard anyway).
    """
    from numpy.polynomial import chebyshev as _cheb

    xi = np.linspace(0.0, float(xi_max), 4001)
    ph = es_kernel_ft(xi, w, beta)
    if ph.min() <= 0:
        return None
    lp = np.log(ph)
    t = 2.0 * (xi / xi_max) ** 2 - 1.0
    for deg in degrees:
        coefs = _cheb.chebfit(t, lp, deg)
        if np.abs(_cheb.chebval(t, coefs) - lp).max() < tol:
            return coefs
    return None


def es_kernel_ft_cheb(xi, coefs, xi_max: float, xp=np):
    """Evaluate the :func:`fit_log_ft_cheb` approximation of psi_hat(xi).

    Clenshaw recurrence in the caller's dtype; |xi| beyond xi_max clips to
    the domain edge (only reachable by zero-weight padding sources -- the
    plan's extent bounds all live coordinates).
    """
    xi = xp.asarray(xi)
    dt = np.float64 if xp is np else xi.dtype
    r = xi * xp.asarray(1.0 / xi_max, dtype=dt)
    t = xp.clip(2.0 * r * r - 1.0, -1.0, 1.0)
    b1 = xp.zeros_like(t)
    b2 = xp.zeros_like(t)
    t2 = 2.0 * t
    for c in coefs[:0:-1]:
        b1, b2 = t2 * b1 - b2 + xp.asarray(c, dtype=dt), b1
    return xp.exp(t * b1 - b2 + xp.asarray(coefs[0], dtype=dt))


def next_fast_size(n: int, prefer_pow2: bool = False, multiple_of: int = 8) -> int:
    """Smallest 5-smooth (2^a 3^b 5^c) multiple of ``multiple_of`` >= n.

    XLA's FFT handles radix-2/3/5 well; the multiple-of-8 default keeps
    grid rows aligned for the tile/strip spreaders' 8-row windows.
    """
    if prefer_pow2:
        return max(1 << int(np.ceil(np.log2(max(n, 2)))), multiple_of)
    n = max(int(n), multiple_of)
    while True:
        m = n
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        if m == 1 and n % multiple_of == 0:
            return n
        n += 1
