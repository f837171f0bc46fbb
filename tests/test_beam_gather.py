"""Channels-last beam-table gather vs scipy.ndimage.map_coordinates.

Tabulated beams are evaluated by :func:`map_coordinates_2d_cl`: a flat
gather of 4 (order 1) or 16 (order 3) contiguous channel vectors per
point. Its boundary rules are scipy's: order 1 clamps ('nearest'), order 3
reflects ('mirror') on a prefiltered table, and a full-circle azimuth axis
wraps. scipy has one mode for all axes, so a wrapped x axis is compared
on the table tiled three periods wide (the spline prefilter's memory
decays as 0.27^k, far below the tolerance over one period).

Reference anchor: pyuvdata's az_za_map_coordinates, which the reference
delegates beam evaluation to (ref src/fftvis/cpu/beams.py:62-74).
"""

import numpy as np
import pytest
from scipy import ndimage

import jax.numpy as jnp

from fftvis_tpu.beams.interp import (
    map_coordinates_2d,
    map_coordinates_2d_cl,
    spline_prefilter_2d,
)


def _coords(n, ny, nx, wrap, seed):
    """Interior points plus points hugging every edge (and, with wrap,
    x beyond one period on both sides)."""
    rng = np.random.default_rng(seed)
    y = rng.uniform(0, ny - 1, n)
    x = rng.uniform(-nx, 2 * nx, n) if wrap else rng.uniform(0, nx - 1, n)
    k = n // 8
    y[:k] = rng.uniform(0, 0.99, k)
    y[k:2 * k] = rng.uniform(ny - 1.99, ny - 1, k)
    x[2 * k:3 * k] = rng.uniform(0, 0.99, k)
    x[3 * k:4 * k] = rng.uniform(nx - 1.99, nx - 1, k)
    return y, x


def _scipy(data, y, x, order, wrap):
    """scipy.ndimage.map_coordinates channel by channel -> (npts, ch)."""
    nx = data.shape[1]
    if wrap:
        data = np.concatenate([data, data, data], axis=1)
        x = np.mod(x, nx) + nx
    mode = "nearest" if order == 1 else "mirror"
    return np.stack(
        [ndimage.map_coordinates(data[:, :, c], [y, x], order=order, mode=mode)
         for c in range(data.shape[2])],
        axis=1,
    )


def _table(data, order, wrap):
    if order == 1:
        return jnp.asarray(data)
    return spline_prefilter_2d(jnp.asarray(data), axes=(0, 1), periodic_x=wrap)


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("wrap", [True, False])
@pytest.mark.parametrize("ny,nx,ch", [(91, 181, 8), (21, 40, 3)])
def test_gather_matches_scipy(order, wrap, ny, nx, ch):
    rng = np.random.default_rng(order * 10 + wrap + ny)
    data = rng.normal(size=(ny, nx, ch))
    y, x = _coords(700, ny, nx, wrap, seed=ny + order)
    got = np.asarray(
        map_coordinates_2d_cl(_table(data, order, wrap), jnp.asarray(y),
                              jnp.asarray(x), order=order, wrap_x=wrap)
    )
    want = _scipy(data, y, x, order, wrap)
    assert got.shape == want.shape == (700, ch)
    np.testing.assert_allclose(got, want, atol=1e-9 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("order", [1, 3])
def test_gather_at_period_multiples(order):
    """x exactly at multiples of the period (the seam of a full-circle
    azimuth axis) lands on column 0 from either side."""
    rng = np.random.default_rng(1)
    ny, nx, ch = 24, 30, 3
    data = rng.normal(size=(ny, nx, ch))
    y = rng.uniform(0, ny - 1, 9)
    x = np.array([-2, -1, 0, 1, 2, 3, -1, 1, 2], float) * nx
    got = np.asarray(
        map_coordinates_2d_cl(_table(data, order, True), jnp.asarray(y),
                              jnp.asarray(x), order=order, wrap_x=True)
    )
    want = _scipy(data, y, x, order, True)
    np.testing.assert_allclose(got, want, atol=1e-9 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("wrap", [True, False])
def test_channels_last_equals_channels_first(order, wrap):
    """The engine's channels-last gather and the public channels-first
    map_coordinates_2d are one function on transposed tables."""
    rng = np.random.default_rng(7 + order)
    ny, nx, ch = 33, 64, 5
    data = rng.normal(size=(ny, nx, ch))
    y, x = _coords(300, ny, nx, wrap, seed=order)
    table = _table(data, order, wrap)
    got = np.asarray(map_coordinates_2d_cl(table, jnp.asarray(y), jnp.asarray(x),
                                           order=order, wrap_x=wrap))
    want = np.asarray(map_coordinates_2d(jnp.moveaxis(table, -1, 0),
                                         jnp.asarray(y), jnp.asarray(x),
                                         order=order, wrap_x=wrap,
                                         prefiltered=True))
    np.testing.assert_allclose(got, want.T, atol=1e-12, rtol=0)
