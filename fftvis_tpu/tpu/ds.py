"""Double-single (two-float) arithmetic for fp64-class accuracy in fp32.

The engine's accelerator path computes in float32; the reference's
``precision=2`` path (fp64 + eps=1e-13 through finufft, ref
core/simulate.py accuracy dict) therefore degrades to fp32 there. This
module provides the
compensated-arithmetic building blocks that recover ~1e-7-1e-9 relative
accuracy for the exact (direct-DFT) path: every value is an unevaluated
sum ``hi + lo`` of two float32s (~49-bit effective mantissa).

The error-free transformations (Knuth two-sum, Dekker two-product) stay
bit-exact when jitted for an H100 (residuals are 0 against float64; the
``gpu``-marked tests of tests/test_ds.py check it on the card, where FMA
contraction would break them), so the classical double-double algorithms
transfer directly.

All functions are elementwise over arbitrary-shape jnp arrays and are
safe under jit/vmap/scan. Host-side ``split64`` produces the (hi, lo)
planes shipped as program inputs (float64 cannot cross to the device).
"""

from __future__ import annotations

import numpy as np

_SPLITTER = np.float32(4097.0)  # 2^12 + 1 for Dekker splitting
TWO_PI_HI = np.float32(6.2831855)


def split64(x) -> tuple[np.ndarray, np.ndarray]:
    """Host: split float64 into (hi, lo) float32 planes, x == hi + lo."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def two_sum(a, b):
    """Error-free a + b -> (s, err): s + err == a + b exactly."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """Error-free a + b assuming |a| >= |b| (3 flops)."""
    s = a + b
    return s, b - (s - a)


def two_prod(a, b):
    """Error-free a * b -> (p, err): p + err == a * b exactly."""
    p = a * b
    c = _SPLITTER * a
    ah = c - (c - a)
    al = a - ah
    d = _SPLITTER * b
    bh = d - (d - b)
    bl = b - bh
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def ds_add(ah, al, bh, bl):
    """(ah+al) + (bh+bl) as a normalized DS pair."""
    s, e = two_sum(ah, bh)
    e = e + (al + bl)
    return quick_two_sum(s, e)


def ds_mul(ah, al, bh, bl):
    """(ah+al) * (bh+bl) as a normalized DS pair."""
    p, e = two_prod(ah, bh)
    e = e + (ah * bl + al * bh)
    return quick_two_sum(p, e)


def ds_mul_f32(ah, al, b):
    """(ah+al) * b (plain float32 b)."""
    p, e = two_prod(ah, b)
    e = e + al * b
    return quick_two_sum(p, e)


def ds_dot3(a_ds, b_ds):
    """Sum_k a[k] * b[k] for k = 0..2 of DS pairs (rotation rows etc.)."""
    h, l = ds_mul(a_ds[0][0], a_ds[0][1], b_ds[0][0], b_ds[0][1])
    for k in (1, 2):
        ph, pl = ds_mul(a_ds[k][0], a_ds[k][1], b_ds[k][0], b_ds[k][1])
        h, l = ds_add(h, l, ph, pl)
    return h, l


def ds_mod_two_pi(h, l):
    """Reduce a DS angle into (-2pi, 2pi) with a DS-accurate 2*pi.

    Large direct-path phases (|theta| up to ~1e4 rad for wide arrays) lose
    ~|theta| * 2^-24 absolute accuracy in fp32; reducing in DS keeps the
    residual angle accurate to the DS epsilon.
    """
    import jax.numpy as jnp

    two_pi_h = jnp.float32(TWO_PI_HI)
    two_pi_l = jnp.float32(np.float64(2.0 * np.pi) - np.float64(TWO_PI_HI))
    k = jnp.round(h / two_pi_h)
    mh, ml = ds_mul_f32(two_pi_h, two_pi_l, k)
    return ds_add(h, l, -mh, -ml)


def ds_mod_n(h, l, n: int):
    """Reduce a DS value modulo an integer ``n`` into [0, n), keeping DS.

    Used for fine-grid coordinates ``u = mod(x / h, nf)``: computed in
    plain f32 the pre-mod value (magnitude up to ~1e5 cells on large
    grids) loses ~magnitude * 2^-24 cells of position, which dominates the
    fp32 NUFFT phase error. ``n`` must be f32-exact (n < 2^24; fine-grid
    sizes always are), and |h|/n must stay below 2^24 so q*n is exact.
    """
    import jax.numpy as jnp

    nf = jnp.float32(n)
    q = jnp.round(h / nf)
    rh, rl = ds_add(h, l, -q * nf, jnp.float32(0.0))
    # r in [-n/2, n/2] up to rounding; shift into [0, n), error-free.
    shift = jnp.where(rh < 0, nf, jnp.float32(0.0))
    shift = shift + jnp.where(rh + shift >= nf, -nf, jnp.float32(0.0))
    sh, se = two_sum(rh, shift)
    return quick_two_sum(sh, se + rl)


def ds_sincos(h, l):
    """sin/cos of a DS angle, accurate to ~1e-7 absolute.

    After DS range reduction the residual ``l`` is tiny; first-order
    correction sin(h+l) = sin(h) + l cos(h) brings the phase error down
    to the f32 transcendental's own ~1 ulp -- matched to the f32 beam
    and flux inputs, which bound the whole pipeline at ~1e-7 anyway.
    """
    import jax.numpy as jnp

    h, l = ds_mod_two_pi(h, l)
    sh = jnp.sin(h)
    ch = jnp.cos(h)
    return sh + l * ch, ch - l * sh


def ds_sum_pairwise(xh, xl, axis):
    """Compensated reduction of DS arrays along ``axis`` (tree order)."""
    import jax.numpy as jnp

    xh = jnp.moveaxis(xh, axis, 0)
    xl = jnp.moveaxis(xl, axis, 0)
    n = xh.shape[0]
    while n > 1:
        half = n // 2
        if n % 2:
            tail_h, tail_l = xh[-1], xl[-1]
        ah, al = xh[:half], xl[:half]
        bh, bl = xh[half : 2 * half], xl[half : 2 * half]
        xh, xl = ds_add(ah, al, bh, bl)
        if n % 2:
            h0, l0 = ds_add(xh[0], xl[0], tail_h, tail_l)
            xh = xh.at[0].set(h0)
            xl = xl.at[0].set(l0)
        n = half
    return xh[0], xl[0]
