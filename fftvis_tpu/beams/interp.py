"""Regular-grid interpolation in JAX (map_coordinates equivalent).

Replaces the reference's beam interpolation backends (pyuvdata
``compute_response`` with 'az_za_simple' RectBivariateSpline or
'az_za_map_coordinates' scipy.ndimage; ref /root/reference/src/fftvis/cpu/
beams.py:62-74) with vectorized XLA gathers:

  - order 1: bilinear (matches scipy map_coordinates order=1 exactly),
  - order 3: cubic B-spline WITH the scipy prefilter (exact parity with
    scipy.ndimage.map_coordinates(order=3, mode='nearest')), the prefilter
    implemented as the standard causal/anticausal first-order recursive
    filter run with lax.scan along each axis.

The azimuth axis of a full-coverage beam grid is periodic; ``wrap_x=True``
selects modular indexing there.
"""

from __future__ import annotations

import numpy as np

_POLE = np.sqrt(3.0) - 2.0  # cubic B-spline filter pole


def _prefilter_axis(data, axis: int):
    """Cubic-B-spline prefilter along ``axis`` (scipy 'mirror' boundary)."""
    import jax.numpy as jnp
    from jax import lax

    z = _POLE
    x = jnp.moveaxis(data, axis, 0)
    n = x.shape[0]
    if n == 1:
        return jnp.moveaxis(x, 0, axis)

    gain = (1.0 - z) * (1.0 - 1.0 / z)
    x = x * gain

    # Exact causal init for the 'mirror' boundary (Unser's formula): the
    # mirrored extension has period 2n-2, so
    #   c0 = sum_k coeff[k] x[k] / (1 - z^(2n-2)),
    # with coeff[0] = 1, coeff[n-1] = z^(n-1), else z^k + z^(2n-2-k).
    k = np.arange(n)
    coeff = (z ** k).astype(np.float64) + (z ** (2 * n - 2 - k)).astype(np.float64)
    coeff[0] = 1.0
    coeff[n - 1] = z ** (n - 1)
    coeff /= 1.0 - z ** (2 * n - 2)
    c0 = jnp.tensordot(jnp.asarray(coeff, dtype=jnp.result_type(x, 0.0)), x, axes=(0, 0))

    def causal(carry, xi):
        yi = xi + z * carry
        return yi, yi

    _, y = lax.scan(causal, c0, x[1:])
    y = jnp.concatenate([c0[None], y], axis=0)

    # Anticausal pass.
    cn = (z / (z * z - 1.0)) * (y[-1] + z * y[-2])

    def anticausal(carry, yi):
        ci = z * (carry - yi)
        return ci, ci

    _, c = lax.scan(anticausal, cn, y[:-1][::-1])
    c = jnp.concatenate([cn[None], c], axis=0)[::-1]
    return jnp.moveaxis(c, 0, axis)


def _prefilter_axis_periodic(data, axis: int):
    """Cubic-B-spline prefilter along a PERIODIC ``axis``.

    Solves the circulant system (c[i-1] + 4 c[i] + c[i+1]) / 6 = x[i] in
    the Fourier domain (eigenvalues (4 + 2 cos(2 pi k / n)) / 6): the
    coefficients a full-circle azimuth axis needs so that periodic taps
    (mod-n indexing at evaluation time) reconstruct the table exactly at
    the seam. Prefiltering a wrapped axis with the mirror boundary leaves
    an O((c[n-1] - c[1]) / 6) bias at the seam nodes instead.
    """
    import jax.numpy as jnp

    x = jnp.moveaxis(data, axis, -1)
    n = x.shape[-1]
    if n == 1:
        return data
    k = np.arange(n)
    eig = (4.0 + 2.0 * np.cos(2.0 * np.pi * k / n)) / 6.0
    c = jnp.fft.ifft(jnp.fft.fft(x, axis=-1) / jnp.asarray(eig), axis=-1)
    if not jnp.iscomplexobj(data):
        c = c.real
    c = c.astype(data.dtype)
    return jnp.moveaxis(c, -1, axis)


def spline_prefilter_2d(data, axes=(-2, -1), periodic_x: bool = False):
    """Apply the cubic-B-spline prefilter along two axes.

    ``periodic_x`` selects the periodic boundary for the LAST axis of
    ``axes`` (a full-circle azimuth grid evaluated with ``wrap_x=True``);
    the other axis always uses scipy's 'mirror' boundary.
    """
    out = _prefilter_axis(data, axes[0])
    if periodic_x:
        return _prefilter_axis_periodic(out, axes[1])
    return _prefilter_axis(out, axes[1])


def _mirror_index(i, n: int):
    """Mirror boundary index mapping (period 2n-2), matching scipy 'mirror'."""
    import jax.numpy as jnp

    if n == 1:
        return jnp.zeros_like(i)
    p = 2 * n - 2
    j = jnp.abs(i) % p
    return jnp.where(j >= n, p - j, j)


def _bspline3_weights(t):
    """Cubic B-spline basis values for fractional offset t in [0,1).

    Returns weights for taps at offsets (-1, 0, 1, 2).
    """
    import jax.numpy as jnp

    t2 = t * t
    t3 = t2 * t
    w0 = (1.0 - 3.0 * t + 3.0 * t2 - t3) / 6.0
    w1 = (4.0 - 6.0 * t2 + 3.0 * t3) / 6.0
    w2 = (1.0 + 3.0 * t + 3.0 * t2 - 3.0 * t3) / 6.0
    w3 = t3 / 6.0
    return jnp.stack([w0, w1, w2, w3], axis=-1)


def map_coordinates_2d(
    data,
    y,
    x,
    order: int = 1,
    wrap_x: bool = False,
    prefiltered: bool = False,
):
    """Interpolate ``data[..., ny, nx]`` at fractional coordinates (y, x).

    Parameters
    ----------
    data
        (..., ny, nx) real or complex samples. For order 3, pass data through
        :func:`spline_prefilter_2d` first (or set ``prefiltered=False`` to do
        it here -- avoid inside jit loops).
    y, x
        (npts,) fractional indices.
    order
        1 (bilinear) or 3 (cubic B-spline).
    wrap_x
        Periodic indexing along the last axis (azimuth of a full 2pi grid).

    Returns
    -------
    (..., npts) interpolated values. Out-of-range coordinates clamp
    (scipy mode='nearest') along y; x clamps unless ``wrap_x``.
    """
    import jax.numpy as jnp

    ny, nx = data.shape[-2], data.shape[-1]

    if order == 1:
        y0 = jnp.clip(jnp.floor(y), 0, ny - 1 - 1e-9)
        ty = jnp.clip(y - y0, 0.0, 1.0)
        y0 = y0.astype(jnp.int32)
        y1 = jnp.minimum(y0 + 1, ny - 1)

        if wrap_x:
            x0f = jnp.floor(x)
            tx = x - x0f
            x0 = jnp.mod(x0f.astype(jnp.int32), nx)
            x1 = jnp.mod(x0 + 1, nx)
        else:
            x0f = jnp.clip(jnp.floor(x), 0, nx - 1 - 1e-9)
            tx = jnp.clip(x - x0f, 0.0, 1.0)
            x0 = x0f.astype(jnp.int32)
            x1 = jnp.minimum(x0 + 1, nx - 1)

        v00 = data[..., y0, x0]
        v01 = data[..., y0, x1]
        v10 = data[..., y1, x0]
        v11 = data[..., y1, x1]
        return (
            v00 * (1 - ty) * (1 - tx)
            + v01 * (1 - ty) * tx
            + v10 * ty * (1 - tx)
            + v11 * ty * tx
        )

    if order == 3:
        coeff = (
            data if prefiltered else spline_prefilter_2d(data, periodic_x=wrap_x)
        )
        y0 = jnp.floor(y)
        ty = y - y0
        wy = _bspline3_weights(ty)  # (npts, 4)
        iy = y0.astype(jnp.int32)[:, None] + jnp.arange(-1, 3)[None, :]
        iy = _mirror_index(iy, ny)

        x0 = jnp.floor(x)
        tx = x - x0
        wx = _bspline3_weights(tx)
        ix = x0.astype(jnp.int32)[:, None] + jnp.arange(-1, 3)[None, :]
        ix = jnp.mod(ix, nx) if wrap_x else _mirror_index(ix, nx)

        sub = coeff[..., iy[:, :, None], ix[:, None, :]]  # (..., npts, 4, 4)
        return jnp.einsum("...pab,pa,pb->...p", sub, wy, wx)

    raise NotImplementedError(f"order={order}")


def upsample_prefiltered_2d(coeff, factor: int, wrap_x: bool = False):
    """Resample prefiltered cubic-spline coefficients onto a denser grid.

    One-time host-side transform behind the ``FFTVIS_BEAM_UPSAMPLE`` knob:
    evaluating the order-3 spline at a ``factor``x-refined lattice yields a
    table whose ORDER-1 interpolation reproduces the cubic values exactly at
    the refined nodes and bilinearly between them. This trades 16 gathered
    taps per point for 4 at a (documented, opt-in) accuracy cost of
    O((h/factor)^2) vs the cubic's O(h^4).

    Parameters
    ----------
    coeff
        (..., ny, nx) PREFILTERED cubic-B-spline coefficients
        (:func:`spline_prefilter_2d`).
    factor
        Integer refinement >= 2.
    wrap_x
        Periodic last axis (full-2pi azimuth): the refined axis keeps the
        period with ``nx * factor`` samples; otherwise endpoints are kept
        with ``(nx - 1) * factor + 1`` samples. Rows always keep endpoints.

    Returns
    -------
    (..., ny2, nx2) resampled VALUES (not coefficients), ready for order-1.
    """
    import jax
    import jax.numpy as jnp

    ny, nx = coeff.shape[-2], coeff.shape[-1]
    f = int(factor)
    if f < 2 or ny < 2 or nx < 2:
        raise ValueError(f"upsample needs factor>=2 and a 2D grid, got "
                         f"factor={factor}, grid={ny}x{nx}")
    ny2 = (ny - 1) * f + 1
    nx2 = nx * f if wrap_x else (nx - 1) * f + 1
    yy = np.arange(ny2, dtype=np.float64) / f
    xx = np.arange(nx2, dtype=np.float64) / f
    Y, X = np.meshgrid(yy, xx, indexing="ij")
    with jax.default_device(jax.devices("cpu")[0]):
        vals = np.asarray(
            map_coordinates_2d(
                jnp.asarray(coeff), jnp.asarray(Y.ravel()),
                jnp.asarray(X.ravel()), order=3, wrap_x=wrap_x,
                prefiltered=True,
            )
        )
    return vals.reshape(coeff.shape[:-2] + (ny2, nx2))


def map_coordinates_2d_cl(
    data,
    y,
    x,
    order: int = 1,
    wrap_x: bool = False,
):
    """Channels-LAST variant of :func:`map_coordinates_2d` for accelerators.

    ``data`` is (ny, nx, ch) with the channel axis contiguous in memory, so
    every gathered tap is one contiguous ch-vector instead of ch elements
    strided ny*nx apart: one (npts*taps)-index flat gather over a
    (ny*nx, ch) view. Semantics match
    :func:`map_coordinates_2d` exactly (order-1 clamp / order-3 mirror
    boundaries, optional periodic x); order 3 expects prefiltered data.

    Returns (npts, ch).
    """
    import jax.numpy as jnp

    ny, nx, ch = data.shape
    flat = data.reshape(ny * nx, ch)

    if order == 1:
        y0 = jnp.clip(jnp.floor(y), 0, ny - 1 - 1e-9)
        ty = jnp.clip(y - y0, 0.0, 1.0)
        y0 = y0.astype(jnp.int32)
        y1 = jnp.minimum(y0 + 1, ny - 1)

        if wrap_x:
            x0f = jnp.floor(x)
            tx = x - x0f
            x0 = jnp.mod(x0f.astype(jnp.int32), nx)
            x1 = jnp.mod(x0 + 1, nx)
        else:
            x0f = jnp.clip(jnp.floor(x), 0, nx - 1 - 1e-9)
            tx = jnp.clip(x - x0f, 0.0, 1.0)
            x0 = x0f.astype(jnp.int32)
            x1 = jnp.minimum(x0 + 1, nx - 1)

        idx = jnp.stack(
            [y0 * nx + x0, y0 * nx + x1, y1 * nx + x0, y1 * nx + x1], axis=1
        )  # (npts, 4)
        sub = jnp.take(flat, idx.reshape(-1), axis=0).reshape(-1, 4, ch)
        w = jnp.stack(
            [
                (1 - ty) * (1 - tx),
                (1 - ty) * tx,
                ty * (1 - tx),
                ty * tx,
            ],
            axis=1,
        )  # (npts, 4)
        return jnp.einsum("ptc,pt->pc", sub, w)

    if order == 3:
        y0 = jnp.floor(y)
        wy = _bspline3_weights(y - y0)  # (npts, 4)
        iy = y0.astype(jnp.int32)[:, None] + jnp.arange(-1, 3)[None, :]
        iy = _mirror_index(iy, ny)

        x0 = jnp.floor(x)
        wx = _bspline3_weights(x - x0)
        ix = x0.astype(jnp.int32)[:, None] + jnp.arange(-1, 3)[None, :]
        ix = jnp.mod(ix, nx) if wrap_x else _mirror_index(ix, nx)

        idx = iy[:, :, None] * nx + ix[:, None, :]  # (npts, 4, 4)
        sub = jnp.take(flat, idx.reshape(-1), axis=0).reshape(-1, 4, 4, ch)
        return jnp.einsum("pabc,pa,pb->pc", sub, wy, wx)

    raise NotImplementedError(f"order={order}")
