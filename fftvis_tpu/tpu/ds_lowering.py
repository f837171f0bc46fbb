"""Double-single (two-float) device lowerings for the jitted program.

Three pieces of the traced simulation use compensated double-single
arithmetic (:mod:`fftvis_tpu.tpu.ds`) to reach fp64-class accuracy on
hardware without float64:

* :func:`ds_coordinate_chain` -- the per-time source coordinate chain
  (aberration add, normalization, 3x3 rotation) in two-float form; the
  plain-f32 chain alone costs ~1e-4 relative phase at wide-array scales.
* :func:`ds_direct_accumulate` -- the fully-compensated exact direct
  path: DS phase contraction over folded targets, DS range-reduced
  sincos, error-free products, pairwise-compensated source reduction.
* :func:`ds_coords_spread` -- DS *coordinates only* for the NUFFT
  spread (type-1 lattice grid coordinates / type-3 scaled positions);
  beams and coherency stay f32.

These are called from the program builder (:mod:`fftvis_tpu.tpu.program`)
inside ``lax.scan`` bodies; everything is shape-static and jit-traceable.
"""

from __future__ import annotations

import numpy as np


def ds_coordinate_chain(eq_t, vel, mat, ds_coords: bool):
    """Full per-time coordinate chain in double-single arithmetic.

    Aberration add, normalization (f32 rsqrt + one DS Newton step), and
    the 3x3 rotation. ``eq_t`` is (3, n, 2) hi/lo planes; ``vel`` is
    (3, 2); ``mat`` is (3, 3, 2). Returns ``(topo, topo_hi)`` where topo
    is (3, n, 2) and topo_hi its hi planes.

    When ``ds_coords`` (DS coordinates feeding an f32 NUFFT spread), the
    chain ends in an optimization barrier: XLA:CPU's optimizer goes
    pathological (hour-long compile) when this DS chain feeds scatter
    indices downstream, and materializing topo at the barrier is free
    (it is a scan input anyway).
    """
    import jax
    import jax.numpy as jnp

    from . import ds as _dsm

    comp = [
        _dsm.ds_add(
            eq_t[d2, :, 0], eq_t[d2, :, 1],
            vel[d2, 0], vel[d2, 1],
        )
        for d2 in range(3)
    ]
    n2h, n2l = _dsm.ds_mul(*comp[0], *comp[0])
    for d2 in (1, 2):
        sq = _dsm.ds_mul(*comp[d2], *comp[d2])
        n2h, n2l = _dsm.ds_add(n2h, n2l, *sq)
    y0 = jax.lax.rsqrt(n2h)
    t_h, t_l = _dsm.ds_mul_f32(n2h, n2l, y0)
    t_h, t_l = _dsm.ds_mul_f32(t_h, t_l, y0)
    t_h, t_l = _dsm.ds_mul_f32(t_h, t_l, jnp.float32(-0.5))
    t_h, t_l = _dsm.ds_add(
        t_h, t_l, jnp.float32(1.5), jnp.float32(0.0)
    )
    yh, yl = _dsm.ds_mul_f32(t_h, t_l, y0)
    unit = [
        _dsm.ds_mul(*comp[d2], yh, yl) for d2 in range(3)
    ]
    tp = [
        _dsm.ds_dot3(
            [(mat[i2, k2, 0], mat[i2, k2, 1]) for k2 in range(3)],
            unit,
        )
        for i2 in range(3)
    ]
    topo_hi = jnp.stack([p[0] for p in tp])  # (3, n)
    topo = jnp.stack(
        [topo_hi, jnp.stack([p[1] for p in tp])], axis=-1
    )  # (3, n, 2)
    if ds_coords:
        topo = jax.lax.optimization_barrier(topo)
        topo_hi = topo[..., 0]
    return topo, topo_hi


def ds_direct_accumulate(
    carry, topo_b, rows, tg_ds_host, f_h, f_l, nbl: int, real_dtype
):
    """One source block of the compensated exact direct path.

    DS phase contraction over the folded targets, DS range-reduced
    sincos, error-free products, pairwise-compensated source reduction.
    Channels are batched: (C, B, nbl) two-float temps (the engine's
    block-size budget scales with C to bound them). ``carry`` is the
    4-tuple of (C, nbl) hi/lo real/imag planes.
    """
    import jax.numpy as jnp

    from . import ds as _dsm

    B = topo_b.shape[1]
    tgh = jnp.asarray(tg_ds_host[..., 0])  # (3, nbl)
    tgl = jnp.asarray(tg_ds_host[..., 1])
    ph_h = jnp.zeros((B, nbl), real_dtype)
    ph_l = jnp.zeros((B, nbl), real_dtype)
    for dd in range(3):
        mh, ml = _dsm.ds_mul(
            topo_b[dd, :, 0][:, None], topo_b[dd, :, 1][:, None],
            tgh[dd][None, :], tgl[dd][None, :],
        )
        ph_h, ph_l = _dsm.ds_add(ph_h, ph_l, mh, ml)
    ph_h, ph_l = _dsm.ds_mul(ph_h, ph_l, f_h, f_l)
    sn, cs = _dsm.ds_sincos(ph_h, ph_l)
    rr = jnp.real(rows)[:, :, None]  # (C, B, 1)
    ri = jnp.imag(rows)[:, :, None]
    sn = sn[None]  # (1, B, nbl)
    cs = cs[None]
    ac_h, ac_l = _dsm.two_prod(rr, cs)
    bs_h, bs_l = _dsm.two_prod(ri, sn)
    re_h, re_l = _dsm.ds_add(ac_h, ac_l, -bs_h, -bs_l)
    as_h, as_l = _dsm.two_prod(rr, sn)
    bc_h, bc_l = _dsm.two_prod(ri, cs)
    im_h, im_l = _dsm.ds_add(as_h, as_l, bc_h, bc_l)
    srh, srl = _dsm.ds_sum_pairwise(re_h, re_l, axis=1)
    sih, sil = _dsm.ds_sum_pairwise(im_h, im_l, axis=1)
    vr_h, vr_l = _dsm.ds_add(carry[0], carry[1], srh, srl)
    vi_h, vi_l = _dsm.ds_add(carry[2], carry[3], sih, sil)
    return (vr_h, vr_l, vi_h, vi_l)


def ds_coords_spread(
    carry, topo_b, rows, plan, lat_ds_host, f_h, f_l, k2pi_c_ds
):
    """DS coordinates for the NUFFT spread, contracted entirely in
    two-float arithmetic (the plain-f32 chain loses ~|value| * 2^-24 in
    the coordinate mod / pre-phase -> ~6e-5 rad of phase at HERA-331
    scale):

        type-1: u_i = mod((lattice @ topo)_i * f * nf_i, nf_i)
        type-3: x_i = (rot @ topo)_i * (2 pi f / c), with the executor
                doing DS pre-phase + mod.

    Returns the updated spread accumulator (``carry + spread_ds(...)``).
    """
    import jax
    import jax.numpy as jnp

    from . import ds as _dsm

    lat_h = jnp.asarray(lat_ds_host[..., 0])  # (d_eff, 3)
    lat_l = jnp.asarray(lat_ds_host[..., 1])

    def _row_dot(i2):
        lh, ll = _dsm.ds_mul(
            lat_h[i2, 0], lat_l[i2, 0],
            topo_b[0, :, 0], topo_b[0, :, 1],
        )
        for k2 in (1, 2):
            mh, ml = _dsm.ds_mul(
                lat_h[i2, k2], lat_l[i2, k2],
                topo_b[k2, :, 0], topo_b[k2, :, 1],
            )
            lh, ll = _dsm.ds_add(lh, ll, mh, ml)
        return lh, ll

    if plan.mode == "type1":
        u_ds = []
        for i2 in range(2):
            lh, ll = _row_dot(i2)
            nf_i = int(plan.executor.plan.nf[i2])
            sh, sl = _dsm.ds_mul_f32(
                f_h, f_l, jnp.float32(nf_i)
            )
            yh, yl = _dsm.ds_mul(lh, ll, sh, sl)
            u_ds.append(_dsm.ds_mod_n(yh, yl, nf_i))
        # Barrier: stops XLA:CPU fusion from duplicating the DS chain's
        # subexpressions with one-ulp differences (breaking the
        # error-free transforms) and from the pathological
        # scatter-producer fusion above.
        u_ds = jax.lax.optimization_barrier(u_ds)
        return carry + plan.executor.spread_ds(u_ds, rows)
    # type-3: scale rows by 2 pi f / c in DS.
    sh, sl = _dsm.ds_mul(
        f_h, f_l,
        jnp.float32(k2pi_c_ds[0]), jnp.float32(k2pi_c_ds[1]),
    )
    x_ds = []
    for i2 in range(lat_ds_host.shape[0]):
        lh, ll = _row_dot(i2)
        x_ds.append(_dsm.ds_mul(lh, ll, sh, sl))
    x_ds = jax.lax.optimization_barrier(x_ds)
    return carry + plan.executor.spread_ds(x_ds, rows)


def split_ds_hosts(plan, freqs_padded, use_ds: bool, speed_of_light: float):
    """Host-side double-single constant preparation.

    For the full DS path the rotation (or lattice) is folded into the
    targets in float64 so the device phase is one DS contraction:
    ``phase = (tg_eff . topo) * f`` with ``tg_eff = M[:d]^T tg * 2 pi``
    (``/ c`` unless folded into M). For ds_coords only the lattice rows
    and frequencies ship as DS pairs (grid coordinates, not per-baseline
    phases).

    Returns ``(tg_ds_host, lat_ds_host, k2pi_c_ds, freqs_ds_host)``
    (unused entries None).
    """
    from . import ds as _ds

    TWO_PI = 2.0 * np.pi
    tg_ds_host = lat_ds_host = k2pi_c_ds = None
    if use_ds:
        if plan.lattice_matrix is not None:
            tg_eff = (
                plan.lattice_matrix[:2].T @ plan.targets
            ) * TWO_PI  # lattice already carries 1/c
        else:
            d_eff = 2 if plan.is_coplanar else 3
            tg_eff = (
                plan.rotation_matrix[:d_eff].T @ plan.targets
            ) * (TWO_PI / speed_of_light)
        tg_ds_host = np.stack(_ds.split64(tg_eff), axis=-1)  # (3, nbl, 2)
    else:
        # DS split of the coordinate matrix: lattice rows (type-1) or
        # plane-rotation rows (type-3); + 2 pi / c for type-3.
        if plan.lattice_matrix is not None:
            lat_ds_host = np.stack(
                _ds.split64(plan.lattice_matrix[:2]), axis=-1
            )  # (2, 3, 2)
        else:
            _de = 2 if plan.is_coplanar else 3
            lat_ds_host = np.stack(
                _ds.split64(plan.rotation_matrix[:_de]), axis=-1
            )  # (d_eff, 3, 2)
        k2pi_c_ds = _ds.split64(np.float64(TWO_PI / speed_of_light))
    freqs_ds_host = np.stack(
        _ds.split64(freqs_padded), axis=-1
    )  # (nf_pad, 2)
    return tg_ds_host, lat_ds_host, k2pi_c_ds, freqs_ds_host
