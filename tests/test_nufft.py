"""NUFFT correctness vs exact direct-DFT references.

Mirrors the reference's kernel-vs-einsum testing pattern (ref
tests/test_cpu_beams.py:99-109) applied to the transform layer: every
approximate transform must match the dense direct sum to its planned eps.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fftvis_tpu.nufft import (
    direct_type1_np,
    direct_type3_jax,
    direct_type3_np,
    make_type1_fn,
    make_type3_fn,
    plan_type1,
    plan_type3,
)
from fftvis_tpu.nufft.kernels import ESKernel, es_kernel_ft, next_fast_size


def _rand_sources(n, d, rng, extent):
    x = rng.uniform(-1, 1, size=(d, n)) * np.asarray(extent)[:, None]
    c = rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))
    return x, c


@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("eps,sigma", [(1e-6, 2.0), (1e-9, 2.0), (1e-12, 2.0), (1e-6, 1.25)])
def test_type3_matches_direct(d, eps, sigma):
    rng = np.random.default_rng(42 + d)
    n, m = 400, 150
    extent = [2 * np.pi] * d
    x, c = _rand_sources(n, d, rng, extent)
    # Asymmetric target band to exercise centering. Keep the band modest in
    # 3D: the type-3 fine grid scales as (sigma^2 X S / pi)^3.
    smax = 40.0 if d < 3 else 6.0
    s = rng.uniform(0.3, smax, size=(d, m))
    s[0] -= 0.6 * smax

    plan = plan_type3(s, extent, eps, sigma)
    fn = make_type3_fn(plan)
    got = np.asarray(fn(jnp.asarray(x), jnp.asarray(c)))
    want = direct_type3_np(x, c, s)

    scale = np.max(np.abs(want))
    err = np.max(np.abs(got - want)) / scale
    # eps is a target, not a bound (as in finufft): allow a modest factor,
    # growing with dimension (per-dim errors add), with an fp64 floor.
    tol = max({1: 30, 2: 30, 3: 300}[d] * eps, 3e-11)
    assert err < tol, f"d={d} eps={eps} sigma={sigma}: rel err {err:.3e}"


@pytest.mark.parametrize("eps", [1e-6, 1e-10])
def test_type1_matches_direct(eps):
    rng = np.random.default_rng(7)
    n = 300
    x = rng.uniform(0, 2 * np.pi, size=(2, n))
    c = rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))
    kmax = 20
    modes = rng.integers(-kmax, kmax + 1, size=(2, 77))

    plan = plan_type1(modes, eps)
    fn = make_type1_fn(plan)
    got = np.asarray(fn(jnp.asarray(x), jnp.asarray(c)))
    want = direct_type1_np(x, c, modes)

    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err < 20 * eps, f"eps={eps}: rel err {err:.3e}"


def test_type1_spread_ds_coordinates():
    """spread_ds (double-single grid coordinates) beats the plain-f32
    spread against the fp64 reference: the cell/frac decomposition keeps
    ~ulp(1) fractional positions, removing the dominant f32 position-
    rounding term (~nf * 2^-24 cells) of the single-precision transform."""
    from fftvis_tpu.nufft.transform import Type1Executor
    from fftvis_tpu.tpu.ds import split64

    rng = np.random.default_rng(11)
    n = 2000
    modes = rng.integers(-20, 21, size=(2, 200))
    plan = plan_type1(modes, eps=5e-7, upsample_factor=2.0)
    ex = Type1Executor(plan)
    x64 = rng.uniform(-np.pi, np.pi, (2, n))
    c64 = rng.normal(size=(1, n)) + 1j * rng.normal(size=(1, n))
    want = direct_type1_np(np.mod(x64, 2 * np.pi), c64, modes)
    scale = np.abs(want).max()

    x32 = jnp.asarray(x64, jnp.float32)
    c32 = jnp.asarray(c64, jnp.complex64)
    got32 = np.asarray(ex.gather(ex.transform(ex.spread(x32, c32))))

    u64 = np.mod(
        x64 / (2 * np.pi) * np.array(plan.nf)[:, None], np.array(plan.nf)[:, None]
    )
    uh, ul = split64(u64)
    u_ds = [(jnp.asarray(uh[i]), jnp.asarray(ul[i])) for i in range(2)]
    gotds = np.asarray(ex.gather(ex.transform(ex.spread_ds(u_ds, c32))))

    e32 = np.abs(got32 - want).max() / scale
    eds = np.abs(gotds - want).max() / scale
    assert eds < 1e-6
    assert eds < e32 / 3


def test_type1_exact_matches_direct():
    """The exact separable-DFT type-1 has no eps: it must match the dense
    direct sum to floating-point roundoff in both precisions."""
    from fftvis_tpu.nufft.transform import Type1ExactExecutor, plan_type1_exact

    rng = np.random.default_rng(21)
    n = 500
    x = rng.uniform(0, 2 * np.pi, size=(2, n))
    c = rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))
    modes = rng.integers(-17, 18, size=(2, 91))
    want = direct_type1_np(x, c, modes)
    scale = np.abs(want).max()

    ex = Type1ExactExecutor(plan_type1_exact(modes))
    got64 = np.asarray(
        ex.gather(ex.transform(ex.spread(jnp.asarray(x), jnp.asarray(c))))
    )
    assert np.abs(got64 - want).max() / scale < 1e-12

    got32 = np.asarray(
        ex.gather(
            ex.transform(
                ex.spread(
                    jnp.asarray(x, jnp.float32), jnp.asarray(c, jnp.complex64)
                )
            )
        )
    )
    assert np.abs(got32 - want).max() / scale < 5e-6


def test_type1_exact_outer_product_form_matches(monkeypatch):
    """The large-C outer-product matmul formulation (E = ey*ex materialized,
    one (C, n) @ (n, nmy*nmx) matmul) is algebraically the factored einsum
    with a different tile geometry: both branches must match the direct
    sum, and auto must engage the outer form at 2C >= 128 with nm^2 >= 128
    (the north-star regime)."""
    from fftvis_tpu.nufft.transform import Type1ExactExecutor, plan_type1_exact

    rng = np.random.default_rng(33)
    n, C, km = 700, 70, 8  # 2C = 140 >= 128; nm^2 = 289 >= 128
    x = rng.uniform(0, 2 * np.pi, size=(2, n))
    c = rng.normal(size=(C, n)) + 1j * rng.normal(size=(C, n))
    modes = rng.integers(-km, km + 1, size=(2, 61))
    want = direct_type1_np(x, c, modes)
    scale = np.abs(want).max()
    ex = Type1ExactExecutor(plan_type1_exact(modes))

    outs = {}
    for env in ("0", "1", "auto"):
        monkeypatch.setenv("FFTVIS_EXACT_OUTER", env)
        outs[env] = np.asarray(
            ex.gather(ex.transform(ex.spread(jnp.asarray(x), jnp.asarray(c))))
        )
        assert np.abs(outs[env] - want).max() / scale < 1e-12
    # auto must follow the outer branch here (same summation order)
    np.testing.assert_array_equal(outs["auto"], outs["1"])


def test_type1_exact_karatsuba_complex_contract(monkeypatch):
    """The 3-real-matmul (Karatsuba/Gauss) complex contraction of the
    outer form must match the plain 4-matmul lowering and the direct sum
    (opt-in knob FFTVIS_EXACT_CMM=karatsuba, for geometries where the
    contraction dominates)."""
    from fftvis_tpu.nufft.transform import Type1ExactExecutor, plan_type1_exact

    rng = np.random.default_rng(34)
    n, C, km = 600, 70, 8
    x = rng.uniform(0, 2 * np.pi, size=(2, n))
    c = rng.normal(size=(C, n)) + 1j * rng.normal(size=(C, n))
    modes = rng.integers(-km, km + 1, size=(2, 61))
    want = direct_type1_np(x, c, modes)
    scale = np.abs(want).max()
    ex = Type1ExactExecutor(plan_type1_exact(modes))

    monkeypatch.setenv("FFTVIS_EXACT_OUTER", "1")
    outs = {}
    for cmm in ("split4", "karatsuba"):
        monkeypatch.setenv("FFTVIS_EXACT_CMM", cmm)
        outs[cmm] = np.asarray(
            ex.gather(ex.transform(ex.spread(jnp.asarray(x), jnp.asarray(c))))
        )
        assert np.abs(outs[cmm] - want).max() / scale < 1e-12, cmm


def test_type1_exact_spread_ds_coordinates():
    """DS grid coordinates restore near-fp64 positions on the exact path:
    the integer cell enters the factor phase error-free, so only the
    ~ulp(1) fractional term survives."""
    from fftvis_tpu.nufft.transform import Type1ExactExecutor, plan_type1_exact
    from fftvis_tpu.tpu.ds import split64

    rng = np.random.default_rng(22)
    n = 2000
    modes = rng.integers(-20, 21, size=(2, 200))
    ex = Type1ExactExecutor(plan_type1_exact(modes))
    nf = np.array(ex.plan.nf)[:, None]
    x64 = rng.uniform(-np.pi, np.pi, (2, n))
    c64 = rng.normal(size=(1, n)) + 1j * rng.normal(size=(1, n))
    want = direct_type1_np(np.mod(x64, 2 * np.pi), c64, modes)
    scale = np.abs(want).max()

    c32 = jnp.asarray(c64, jnp.complex64)
    got32 = np.asarray(
        ex.gather(ex.transform(ex.spread(jnp.asarray(x64, jnp.float32), c32)))
    )
    uh, ul = split64(np.mod(x64 / (2 * np.pi) * nf, nf))
    u_ds = [(jnp.asarray(uh[i], jnp.float32), jnp.asarray(ul[i], jnp.float32))
            for i in range(2)]
    gotds = np.asarray(ex.gather(ex.transform(ex.spread_ds(u_ds, c32))))

    e32 = np.abs(got32 - want).max() / scale
    eds = np.abs(gotds - want).max() / scale
    assert eds < 1e-6
    assert eds <= e32


def test_type1_exact_gather_padded_matches_gather():
    from fftvis_tpu.nufft.transform import Type1ExactExecutor, plan_type1_exact

    rng = np.random.default_rng(23)
    modes = rng.integers(-9, 10, size=(2, 40))
    ex = Type1ExactExecutor(plan_type1_exact(modes))
    x = rng.uniform(0, 2 * np.pi, size=(2, 120))
    P, nf2 = 3, 2
    c = rng.normal(size=(P * nf2, 120)) + 1j * rng.normal(size=(P * nf2, 120))
    G = ex.transform(ex.spread(jnp.asarray(x), jnp.asarray(c)))
    sel_pad = np.stack([rng.permutation(40)[:12] for _ in range(P)])
    got = np.asarray(ex.gather_padded(G, sel_pad))  # (P, nf2, 12)
    for p in range(P):
        want = np.asarray(ex.gather(G, sel=sel_pad[p]))[p * nf2:(p + 1) * nf2]
        np.testing.assert_allclose(got[p], want, rtol=1e-12)


def test_gridded_path_selection_gates():
    """Exact executor for compact lattices; ES fallback past the f32-exact
    phase bound or the dense size class; env override honored."""
    from fftvis_tpu.nufft.transform import Type1ExactExecutor, Type1Executor
    from fftvis_tpu.tpu.engine import TPUSimulationEngine

    eng = TPUSimulationEngine()
    compact = np.stack(
        [np.arange(-15, 16), np.arange(-15, 16)]
    )
    mode, ex, _ = eng._select_gridded_path(compact, 1e-6, 2.0, 100, 31, 31, 1, 1)
    assert mode == "type1" and isinstance(ex, Type1ExactExecutor)

    # One enormous axis: kmax*nm >= 2^23 -> ES pipeline.
    elong = np.stack([np.array([-4000, 0, 4000]), np.array([0, 1, 0])])
    _, ex2, _ = eng._select_gridded_path(elong, 1e-6, 2.0, 100, 3, 3, 1, 1)
    assert isinstance(ex2, Type1Executor)

    import os
    os.environ["FFTVIS_TYPE1"] = "es"
    try:
        _, ex3, _ = eng._select_gridded_path(compact, 1e-6, 2.0, 100, 31, 31, 1, 1)
        assert isinstance(ex3, Type1Executor)
    finally:
        del os.environ["FFTVIS_TYPE1"]


def test_type3_spread_ds_coordinates():
    """Type-3 spread_ds (DS pre-phase + DS grid coordinates) beats the
    plain-f32 spread against the fp64 reference."""
    from fftvis_tpu.nufft.transform import Type3Executor, plan_type3
    from fftvis_tpu.tpu.ds import split64

    rng = np.random.default_rng(13)
    n = 1500
    x64 = rng.uniform(-1, 1, (2, n))
    s = rng.uniform(-600, 600, (2, 120))
    plan = plan_type3(s, 1.0, eps=5e-7)
    ex = Type3Executor(plan)
    c64 = rng.normal(size=(1, n)) + 1j * rng.normal(size=(1, n))
    want = np.einsum("cn,mn->cm", c64, np.exp(1j * (s.T @ x64)))
    scale = np.abs(want).max()

    c32 = jnp.asarray(c64, jnp.complex64)
    got32 = np.asarray(
        ex.interpolate(ex.transform(ex.spread(jnp.asarray(x64, jnp.float32), c32)))
    )
    xh, xl = split64(x64)
    x_ds = [(jnp.asarray(xh[i]), jnp.asarray(xl[i])) for i in range(2)]
    gotds = np.asarray(ex.interpolate(ex.transform(ex.spread_ds(x_ds, c32))))

    e32 = np.abs(got32 - want).max() / scale
    eds = np.abs(gotds - want).max() / scale
    assert eds < 2e-6
    assert eds < e32 / 2


def test_binned_spreaders_consume_ds_low_parts():
    """The tiled / strip / z-tap spreaders consume DS coordinate low
    parts through the shared cell/frac decomposition: an f32 spread fed
    (u_hi, u_lo) must land at u_hi + u_lo (vs the fp64 scatter oracle),
    not at u_hi — carrying the engine's ds_coords accuracy win to the
    large-grid type-3 paths."""
    from fftvis_tpu.nufft.kernels import ESKernel
    from fftvis_tpu.nufft.transform import (
        _spread_3d_ztaps,
        _spread_scatter,
        _spread_strip_matmul,
        _spread_tiled_matmul,
        pick_strip_width,
    )

    rng = np.random.default_rng(41)
    k = ESKernel.from_eps(1e-9, 2.0)
    nf = (64, 120)
    n = 400
    # f32-representable hi parts + low parts big enough (5e-3 cells) that
    # ignoring them is ~1e-3-level kernel error, far above f32 noise.
    u_hi = [
        np.float64(np.float32(rng.uniform(0, nf[i], n))) for i in range(2)
    ]
    u_lo = [rng.uniform(-5e-3, 5e-3, n) for _ in range(2)]
    c64 = rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))
    c32 = jnp.asarray(c64, jnp.complex64)
    uh32 = [jnp.asarray(u, jnp.float32) for u in u_hi]
    ul32 = [jnp.asarray(u, jnp.float32) for u in u_lo]

    ref = np.asarray(
        _spread_scatter(
            [jnp.asarray(u_hi[i] + u_lo[i]) for i in range(2)],
            jnp.asarray(c64), nf, k.w, k.beta,
        )
    )
    scale = np.abs(ref).max()

    strip = pick_strip_width(nf[1], 32)
    sid = np.clip(np.asarray(u_hi[1]) // strip, 0, nf[1] // strip - 1)
    cap_s = int(np.bincount(sid.astype(int), minlength=nf[1] // strip).max())
    ty, sx = 16, 30
    nty, ntx = -(-nf[0] // ty), -(-nf[1] // sx)
    tid = (
        np.clip(u_hi[0] // ty, 0, nty - 1) * ntx
        + np.clip(u_hi[1] // sx, 0, ntx - 1)
    ).astype(int)
    cap_t = int(np.bincount(tid, minlength=nty * ntx).max())

    for name, without, with_lo in [
        (
            "tiled",
            _spread_tiled_matmul(uh32, c32, nf, k.w, k.beta, ty, sx, cap_t),
            _spread_tiled_matmul(
                uh32, c32, nf, k.w, k.beta, ty, sx, cap_t, u_lo_list=ul32
            ),
        ),
        (
            "strip",
            _spread_strip_matmul(uh32, c32, nf, k.w, k.beta, strip, cap_s),
            _spread_strip_matmul(
                uh32, c32, nf, k.w, k.beta, strip, cap_s, u_lo_list=ul32
            ),
        ),
    ]:
        e0 = np.abs(np.asarray(without) - ref).max() / scale
        e1 = np.abs(np.asarray(with_lo) - ref).max() / scale
        assert e1 < 1e-5, f"{name}: DS error {e1:.2e}"
        assert e1 < e0 / 30, f"{name}: DS {e1:.2e} vs plain {e0:.2e}"

    nf3 = (40, 48, 24)
    u_hi3 = [
        np.float64(np.float32(rng.uniform(0, nf3[i], n))) for i in range(3)
    ]
    u_lo3 = [rng.uniform(-5e-3, 5e-3, n) for _ in range(3)]
    ref3 = np.asarray(
        _spread_scatter(
            [jnp.asarray(u_hi3[i] + u_lo3[i]) for i in range(3)],
            jnp.asarray(c64), nf3, k.w, k.beta,
        )
    )
    got3 = np.asarray(
        _spread_3d_ztaps(
            [jnp.asarray(u, jnp.float32) for u in u_hi3], c32, nf3,
            k.w, k.beta,
            u_lo_list=[jnp.asarray(u, jnp.float32) for u in u_lo3],
        )
    )
    e3_0 = np.abs(
        np.asarray(
            _spread_3d_ztaps(
                [jnp.asarray(u, jnp.float32) for u in u_hi3], c32, nf3,
                k.w, k.beta,
            )
        )
        - ref3
    ).max() / np.abs(ref3).max()
    e3 = np.abs(got3 - ref3).max() / np.abs(ref3).max()
    assert e3 < 1e-5, f"ztaps: DS error {e3:.2e}"
    assert e3 < e3_0 / 30, f"ztaps: DS {e3:.2e} vs plain {e3_0:.2e}"


def test_kernel_ft_respects_input_dtype():
    """es_kernel_ft must follow xi's dtype under jnp: f64 quadrature
    tables (jax_enable_x64) silently upcast fp32 pipelines to complex128
    (engine scan-carry crash; latent until the fp32 type-3 path ran on
    the x64-enabled CPU test backend)."""
    from fftvis_tpu.nufft.kernels import es_kernel_ft

    out32 = es_kernel_ft(jnp.asarray([0.3], jnp.float32), 8, 22.0, xp=jnp)
    assert out32.dtype == jnp.float32
    out64 = es_kernel_ft(jnp.asarray([0.3], jnp.float64), 8, 22.0, xp=jnp)
    assert out64.dtype == jnp.float64
    np.testing.assert_allclose(
        np.asarray(out32), np.asarray(out64), rtol=1e-6
    )


def test_type3_single_precision():
    rng = np.random.default_rng(3)
    n, m = 500, 100
    x, c = _rand_sources(n, 2, rng, [2 * np.pi, 2 * np.pi])
    s = rng.uniform(-30, 30, size=(2, m))
    plan = plan_type3(s, [2 * np.pi, 2 * np.pi], 6e-8, 2.0)
    fn = make_type3_fn(plan)
    got = np.asarray(
        fn(jnp.asarray(x, dtype=jnp.float32), jnp.asarray(c, dtype=jnp.complex64))
    )
    want = direct_type3_np(x, c, s)
    err = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert err < 2e-5, f"fp32 rel err {err:.3e}"


def test_direct_jax_matches_np():
    rng = np.random.default_rng(11)
    x, c = _rand_sources(1000, 2, rng, [2 * np.pi, 2 * np.pi])
    s = rng.uniform(-20, 20, size=(2, 64))
    got = np.asarray(direct_type3_jax(jnp.asarray(x), jnp.asarray(c), s, source_block=256))
    want = direct_type3_np(x, c, s)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def test_kernel_ft_consistency():
    """Quadrature FT must match brute-force numerical integration."""
    k = ESKernel.from_eps(1e-9, 2.0)
    xi = np.linspace(0, np.pi, 13)
    got = es_kernel_ft(xi, k.w, k.beta)
    t = np.linspace(-k.w / 2, k.w / 2, 20001)
    from fftvis_tpu.nufft.kernels import es_kernel_grid

    psi = es_kernel_grid(t, k.w, k.beta)
    want = np.trapezoid(psi[None, :] * np.cos(xi[:, None] * t[None, :]), t, axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-12)


def test_kernel_ft_cheb_matches_quadrature():
    """The host-fitted log-Chebyshev of psi_hat (the f32 type-3 amplitude
    pre-correction fast path) must match the 80-node quadrature to well
    under f32 resolution across the kernel-width/beta range real plans
    produce, and must follow xi's dtype under jnp like es_kernel_ft."""
    from fftvis_tpu.nufft.kernels import es_kernel_ft_cheb, fit_log_ft_cheb

    for sigma in (1.25, 2.0):
        for eps in (1e-4, 6e-8, 1e-11):
            k = ESKernel.from_eps(eps, sigma)
            xi_max = 1.02 * np.pi / sigma
            coefs = fit_log_ft_cheb(k.w, k.beta, xi_max)
            assert coefs is not None, (sigma, eps)
            xi = np.linspace(0.0, xi_max, 3333)
            want = es_kernel_ft(xi, k.w, k.beta)
            got = es_kernel_ft_cheb(xi, coefs, xi_max)
            rel = np.max(np.abs(got / want - 1.0))
            assert rel < 1e-9, f"sigma={sigma} eps={eps} rel={rel:.2e}"

    k = ESKernel.from_eps(6e-8, 2.0)
    xi_max = 1.02 * np.pi / 2.0
    coefs = fit_log_ft_cheb(k.w, k.beta, xi_max)
    out32 = es_kernel_ft_cheb(jnp.asarray([0.4], jnp.float32), coefs, xi_max, xp=jnp)
    assert out32.dtype == jnp.float32
    # Beyond-domain xi clips to the edge value instead of extrapolating.
    edge = es_kernel_ft_cheb(np.asarray([xi_max]), coefs, xi_max)
    far = es_kernel_ft_cheb(np.asarray([3.0 * xi_max]), coefs, xi_max)
    np.testing.assert_allclose(far, edge, rtol=1e-12)


def test_type3_plan_carries_ft_fit():
    """plan_type3 fits the log-Chebyshev per axis over the planned source
    extent; every real plan (xi_max <= ~pi/sigma by the nf sizing rule)
    must succeed so the f32 executor path never silently mixes fast and
    quadrature pre-corrections across axes."""
    rng = np.random.default_rng(5)
    x, _ = _rand_sources(64, 2, rng, [2 * np.pi, 0.5])
    s = rng.uniform(-40, 40, size=(2, 32))
    plan = plan_type3(s, [2 * np.pi, 0.5], 6e-8, 2.0)
    assert len(plan.ft_coefs) == 2 and len(plan.ft_xi_max) == 2
    for axis in range(2):
        assert plan.ft_coefs[axis] is not None
        xi = np.linspace(0, plan.ft_xi_max[axis], 257)
        from fftvis_tpu.nufft.kernels import es_kernel_ft_cheb

        want = es_kernel_ft(xi, plan.kernel.w, plan.kernel.beta)
        got = es_kernel_ft_cheb(xi, plan.ft_coefs[axis], plan.ft_xi_max[axis])
        np.testing.assert_allclose(got, want, rtol=1e-12)


def test_next_fast_size():
    assert next_fast_size(7) == 8
    assert next_fast_size(16) == 16
    assert next_fast_size(121) == 128 or next_fast_size(121) % 2 == 0
    n = next_fast_size(973)
    m = n
    for p in (2, 3, 5):
        while m % p == 0:
            m //= p
    assert m == 1 and n >= 973 and n % 2 == 0


def test_executor_subset_selection():
    """Split-phase executors: gather/interpolate with a static target subset."""
    from fftvis_tpu.nufft.transform import Type1Executor, Type3Executor

    rng = np.random.default_rng(21)
    n = 200
    x1 = rng.uniform(0, 2 * np.pi, size=(2, n))
    c = rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))
    modes = rng.integers(-10, 11, size=(2, 40))
    p1 = plan_type1(modes, 1e-8)
    ex1 = Type1Executor(p1)
    G = ex1.transform(ex1.spread(jnp.asarray(x1), jnp.asarray(c)))
    full = np.asarray(ex1.gather(G))
    sel = np.array([3, 7, 20])
    np.testing.assert_allclose(np.asarray(ex1.gather(G, sel)), full[:, sel], rtol=1e-12)

    x3 = rng.uniform(-np.pi, np.pi, size=(2, n))
    s = rng.uniform(-20, 20, size=(2, 50))
    p3 = plan_type3(s, [np.pi, np.pi], 1e-8)
    ex3 = Type3Executor(p3)
    G3 = ex3.transform(ex3.spread(jnp.asarray(x3), jnp.asarray(c)))
    full3 = np.asarray(ex3.interpolate(G3))
    np.testing.assert_allclose(
        np.asarray(ex3.interpolate(G3, sel)), full3[:, sel], rtol=1e-12
    )


def test_strip_spreader_unit():
    """Strip-binned spread == scatter at exact capacity, with wrap sources."""
    from fftvis_tpu.nufft.kernels import ESKernel
    from fftvis_tpu.nufft.transform import (
        _spread_scatter,
        _spread_strip_matmul,
        pick_strip_width,
    )

    rng = np.random.default_rng(22)
    k = ESKernel.from_eps(1e-9, 2.0)
    nf = (64, 120)
    n = 700
    uy = jnp.asarray(rng.uniform(0, nf[0], n))
    ux = jnp.asarray(rng.uniform(0, nf[1], n))
    c = jnp.asarray(rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n)))
    strip = pick_strip_width(nf[1], 32)
    assert nf[1] % strip == 0
    sid = np.clip(np.asarray(ux) // strip, 0, nf[1] // strip - 1).astype(int)
    cap = int(np.bincount(sid, minlength=nf[1] // strip).max())
    a = np.asarray(_spread_scatter([uy, ux], c, nf, k.w, k.beta))
    b = np.asarray(_spread_strip_matmul([uy, ux], c, nf, k.w, k.beta, strip, cap))
    np.testing.assert_allclose(b, a, atol=1e-12 * np.abs(a).max(), rtol=0)


def test_ztaps_3d_spread_matches_scatter():
    """The 3D z-tap spreader == scatter reference, with wrap sources."""
    from fftvis_tpu.nufft.kernels import ESKernel
    from fftvis_tpu.nufft.transform import _spread_3d_ztaps, _spread_scatter

    rng = np.random.default_rng(23)
    k = ESKernel.from_eps(1e-8, 2.0)
    nf = (40, 48, 24)
    n = 300
    u = [jnp.asarray(rng.uniform(0, nf[i], n)) for i in range(3)]
    c = jnp.asarray(rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n)))
    a = np.asarray(_spread_scatter(u, c, nf, k.w, k.beta))
    b = np.asarray(_spread_3d_ztaps(u, c, nf, k.w, k.beta))
    np.testing.assert_allclose(b, a, atol=1e-12 * np.abs(a).max(), rtol=0)


@pytest.mark.parametrize(
    "zspread,eps,zlo",
    [(5.0, 1e-6, 0.0), (5.0, 1e-10, 0.0), (30.0, 1e-8, 0.0), (0.5, 1e-12, -np.pi)],
)
def test_type3_lowrank_z_matches_direct(zspread, eps, zlo):
    """3D type-3 via the low-rank Chebyshev z factorization == dense DFT.

    Device replacement for finufft nufft3d3 (ref cpu/nufft.py:62-118):
    the error must track the requested eps and K must stay small for
    near-coplanar targets.
    """
    import jax

    from fftvis_tpu.nufft.transform import (
        make_type3_lowrank_z_fn,
        plan_type3_lowrank_z,
    )

    rng = np.random.default_rng(11)
    n, m, C = 600, 250, 3
    X = np.pi
    x = np.stack(
        [
            rng.uniform(-X, X, n),
            rng.uniform(-X, X, n),
            rng.uniform(zlo, X, n),
        ]
    )
    s = np.stack(
        [
            rng.uniform(-60, 60, m),
            rng.uniform(-60, 60, m),
            rng.uniform(-zspread, zspread, m),
        ]
    )
    c = rng.normal(size=(C, n)) + 1j * rng.normal(size=(C, n))
    plan = plan_type3_lowrank_z(s, [X, X, X], eps=eps, x_range_z=(zlo, X))
    # Rank must scale like |s_z| * zh + O(log 1/eps), far below a 3D grid.
    zh = 0.5 * (X - zlo)
    assert plan.K <= zspread * zh + 14 * np.log10(1.0 / eps) + 16
    fn = jax.jit(make_type3_lowrank_z_fn(plan))
    got = np.asarray(fn(jnp.asarray(x), jnp.asarray(c)))
    want = c @ np.exp(1j * (x.T @ s))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 50 * eps


def test_type3_lowrank_z_out_of_range_sources_masked():
    """Sources outside the planned z range with zero weight must not NaN.

    (The engine masks below-horizon sources by zeroing weights while their
    coordinates stay arbitrary; the Chebyshev recurrence would overflow
    without the executor's clamp.)
    """
    import jax

    from fftvis_tpu.nufft.transform import (
        make_type3_lowrank_z_fn,
        plan_type3_lowrank_z,
    )

    rng = np.random.default_rng(12)
    n, m = 100, 50
    X = np.pi
    x = np.stack(
        [
            rng.uniform(-X, X, n),
            rng.uniform(-X, X, n),
            rng.uniform(0, X, n),
        ]
    )
    x[2, 50:] = rng.uniform(-X, -0.2, 50)  # below-horizon coords
    c = (rng.normal(size=(1, n)) + 1j * rng.normal(size=(1, n)))
    c[:, 50:] = 0.0  # masked
    s = np.stack(
        [rng.uniform(-40, 40, m), rng.uniform(-40, 40, m), rng.uniform(-3, 3, m)]
    )
    plan = plan_type3_lowrank_z(s, [X, X, X], eps=1e-8, x_range_z=(0.0, X))
    got = np.asarray(
        jax.jit(make_type3_lowrank_z_fn(plan))(jnp.asarray(x), jnp.asarray(c))
    )
    assert np.all(np.isfinite(got))
    want = c[:, :50] @ np.exp(1j * (x[:, :50].T @ s))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-6


def test_type3_lowrank_z_executor_subset():
    """interpolate(sel) slices both the 2D taps and the z coefficients."""
    import jax

    from fftvis_tpu.nufft.transform import (
        Type3LowrankZExecutor,
        plan_type3_lowrank_z,
    )

    rng = np.random.default_rng(13)
    n, m = 200, 60
    X = np.pi
    x = np.stack(
        [rng.uniform(-X, X, n), rng.uniform(-X, X, n), rng.uniform(0, X, n)]
    )
    s = np.stack(
        [rng.uniform(-40, 40, m), rng.uniform(-40, 40, m), rng.uniform(-4, 4, m)]
    )
    c = rng.normal(size=(2, n)) + 1j * rng.normal(size=(2, n))
    plan = plan_type3_lowrank_z(s, [X, X, X], eps=1e-9, x_range_z=(0.0, X))
    ex = Type3LowrankZExecutor(plan)
    sel = np.array([3, 17, 41, 59])

    def full(x, c):
        return ex.interpolate(ex.transform(ex.spread(x, c)))

    def subset(x, c):
        return ex.interpolate(ex.transform(ex.spread(x, c)), sel=sel)

    a = np.asarray(jax.jit(full)(jnp.asarray(x), jnp.asarray(c)))
    b = np.asarray(jax.jit(subset)(jnp.asarray(x), jnp.asarray(c)))
    np.testing.assert_allclose(b, a[:, sel], rtol=0, atol=1e-12 * np.abs(a).max())


@pytest.mark.parametrize(
    "nf,n,C", [((64, 120), 700, 2), ((256, 384), 3000, 1), ((640, 1200), 9000, 2)]
)
def test_tiled_spreader_matches_scatter(nf, n, C):
    """The (y, x) tile-binned matmul spreader == scatter reference exactly.

    Selected by FFTVIS_SPREADER=tiled (work per source is one tile window
    instead of a full grid row; supersedes the strip form).
    """
    from fftvis_tpu.nufft.kernels import ESKernel
    from fftvis_tpu.nufft.transform import (
        _spread_scatter,
        _spread_tiled_matmul,
        pick_tile_shape,
    )

    rng = np.random.default_rng(31)
    k = ESKernel.from_eps(1e-9, 2.0)
    uy = jnp.asarray(rng.uniform(0, nf[0], n))
    ux = jnp.asarray(rng.uniform(0, nf[1], n))
    c = jnp.asarray(rng.normal(size=(C, n)) + 1j * rng.normal(size=(C, n)))
    ty, sx = pick_tile_shape(nf, k.w, 2 * C)
    nty, ntx = -(-nf[0] // ty), -(-nf[1] // sx)
    tid = (
        np.clip(np.asarray(uy) // ty, 0, nty - 1) * ntx
        + np.clip(np.asarray(ux) // sx, 0, ntx - 1)
    ).astype(int)
    cap = int(np.bincount(tid, minlength=nty * ntx).max())
    a = np.asarray(_spread_scatter([uy, ux], c, nf, k.w, k.beta))
    b = np.asarray(
        _spread_tiled_matmul([uy, ux], c, nf, k.w, k.beta, ty, sx, cap)
    )
    np.testing.assert_allclose(b, a, atol=1e-12 * np.abs(a).max(), rtol=0)


def test_tiled_spreader_engine_path(monkeypatch):
    """Engine end-to-end with the tiled spreader forced == direct oracle."""
    from fftvis_tpu import TelescopeLocation, simulate_vis
    from fftvis_tpu.beams import GaussianBeam

    monkeypatch.setenv("FFTVIS_SPREADER", "tiled")
    rng = np.random.default_rng(32)
    loc = TelescopeLocation(np.deg2rad(-30.7), np.deg2rad(21.4), 1000.0)
    nsrc = 120
    kw = dict(
        ants={i: np.array([*rng.uniform(-80, 80, 2), 0.0]) for i in range(8)},
        fluxes=rng.uniform(0.1, 1, (nsrc, 2)),
        ra=rng.uniform(0, 2 * np.pi, nsrc),
        dec=np.clip(loc.lat + rng.normal(0, 0.4, nsrc), -np.pi / 2, np.pi / 2),
        freqs=np.linspace(1e8, 1.2e8, 2),
        times=2459863.2 + np.linspace(0, 0.01, 2),
        beam=GaussianBeam(diameter=12.0),
        telescope_loc=loc,
        precision=2,
        force_use_type3=True,
    )
    got = simulate_vis(**kw)
    want = simulate_vis(backend="direct", **kw)
    np.testing.assert_allclose(
        got, want, atol=1e-10 * np.abs(want).max(), rtol=0
    )


@pytest.mark.parametrize("ity,isx", [(32, 64), (48, 80), (128, 128)])
def test_tiled_interp_matches_gather(ity, isx):
    """Host-planned tiled interpolation == the tap-gather formula.

    Includes tile sizes that do NOT divide the grid (the last tile's
    window overhangs the period and must be covered by the wrap pad --
    regression for a clamped-dynamic-slice offset bug), plus subset
    selection (the per-pair routing path).
    """
    import jax

    from fftvis_tpu.nufft.transform import _TiledInterp, plan_type3

    rng = np.random.default_rng(41)
    m = 900
    s = np.stack([rng.uniform(-60, 60, m), rng.uniform(-25, 60, m)])
    plan = plan_type3(s, [np.pi, np.pi], eps=1e-9)
    nfy, nfx = plan.nf
    C = 2
    G = jnp.asarray(
        rng.normal(size=(C, nfy, nfx)) + 1j * rng.normal(size=(C, nfy, nfx))
    )
    ti = [jnp.asarray(t) for t in plan.tap_idx]
    tv = [jnp.asarray(t) for t in plan.tap_val]
    sub = G[:, ti[0][:, :, None], ti[1][:, None, :]]
    want = np.asarray(jnp.einsum("cmab,ma,mb->cm", sub, tv[0], tv[1]))
    got = np.asarray(jax.jit(_TiledInterp(plan, ity=ity, isx=isx))(G))
    np.testing.assert_allclose(got, want, atol=1e-13 * np.abs(want).max(), rtol=0)

    sel = np.sort(rng.choice(m, size=m // 4, replace=False))
    got_s = np.asarray(jax.jit(_TiledInterp(plan, sel, ity=ity, isx=isx))(G))
    np.testing.assert_allclose(
        got_s, want[:, sel], atol=1e-13 * np.abs(want).max(), rtol=0
    )


def test_tiled_interp_engine_path(monkeypatch):
    """Engine end-to-end with tiled interpolation forced == direct oracle."""
    from fftvis_tpu import TelescopeLocation, simulate_vis
    from fftvis_tpu.beams import GaussianBeam

    monkeypatch.setenv("FFTVIS_INTERP", "tiled")
    rng = np.random.default_rng(42)
    loc = TelescopeLocation(np.deg2rad(-30.7), np.deg2rad(21.4), 1000.0)
    nsrc = 150
    kw = dict(
        ants={i: np.array([*rng.uniform(-80, 80, 2), 0.0]) for i in range(7)},
        fluxes=rng.uniform(0.1, 1, (nsrc, 2)),
        ra=rng.uniform(0, 2 * np.pi, nsrc),
        dec=np.clip(loc.lat + rng.normal(0, 0.4, nsrc), -np.pi / 2, np.pi / 2),
        freqs=np.linspace(1e8, 1.2e8, 2),
        times=2459863.2 + np.linspace(0, 0.01, 3),
        beam=GaussianBeam(diameter=12.0),
        telescope_loc=loc,
        precision=2,
        force_use_type3=True,
    )
    got = simulate_vis(**kw)
    want = simulate_vis(backend="direct", **kw)
    np.testing.assert_allclose(
        got, want, atol=1e-10 * np.abs(want).max(), rtol=0
    )


def test_tiled_spreader_balanced_classes():
    """Multi-class (balanced-occupancy) tile schedule == scatter reference.

    Rim-clustered coordinates (the realistic transform-space sky: the
    sin-projection piles sources at the horizon ring) with per-class
    capacities and provably-empty tiles excluded from every class.
    """
    from fftvis_tpu.nufft.kernels import ESKernel
    from fftvis_tpu.nufft.transform import (
        _spread_scatter,
        _spread_tiled_matmul,
    )

    rng = np.random.default_rng(33)
    nf, n, C = (144, 120), 3000, 2
    k = ESKernel.from_eps(1e-9, 2.0)
    th = rng.uniform(0, 2 * np.pi, n)
    r = 55 * (1 - rng.exponential(0.04, n)).clip(0, 1)
    uy = np.mod(72 + r * np.sin(th), nf[0])
    ux = np.mod(60 + 0.8 * r * np.cos(th), nf[1])
    c = jnp.asarray(rng.normal(size=(C, n)) + 1j * rng.normal(size=(C, n)))
    ty, sx = 24, 24
    nty, ntx = -(-nf[0] // ty), -(-nf[1] // sx)
    tid = (
        np.clip(uy // ty, 0, nty - 1) * ntx + np.clip(ux // sx, 0, ntx - 1)
    ).astype(int)
    counts = np.bincount(tid, minlength=nty * ntx)
    occupied = np.flatnonzero(counts > 0)
    assert occupied.size < nty * ntx  # the ring leaves genuinely empty tiles
    order = occupied[np.argsort(counts[occupied])[::-1]]
    third = max(1, order.size // 3)
    classes = tuple(
        (ids, int(counts[ids].max()))
        for ids in (order[:third], order[third : 2 * third], order[2 * third :])
        if ids.size
    )
    uj, xj = jnp.asarray(uy), jnp.asarray(ux)
    want = np.asarray(_spread_scatter([uj, xj], c, nf, k.w, k.beta))
    got = np.asarray(
        _spread_tiled_matmul(
            [uj, xj], c, nf, k.w, k.beta, ty, sx, int(counts.max()), classes
        )
    )
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max(), rtol=0)


def test_tiled_spreader_class_overflow_detected(monkeypatch):
    """FFTVIS_DEBUG flags both class-capacity overflow and sources landing
    in tiles no class covers (either silently drops sources otherwise)."""
    from fftvis_tpu.nufft.kernels import ESKernel
    from fftvis_tpu.nufft.transform import _spread_tiled_matmul

    monkeypatch.setenv("FFTVIS_DEBUG", "1")
    rng = np.random.default_rng(34)
    nf, n = (96, 96), 400
    k = ESKernel.from_eps(1e-9, 2.0)
    uy = jnp.asarray(rng.uniform(0, nf[0], n))
    ux = jnp.asarray(rng.uniform(0, nf[1], n))
    c = jnp.asarray(rng.normal(size=(1, n)) + 0j)
    ty = sx = 24
    nty, ntx = nf[0] // ty, nf[1] // sx
    ntiles = nty * ntx
    # Class capacity 1 on all tiles: overflow.
    with pytest.raises(Exception, match="capacity overflow"):
        np.asarray(
            _spread_tiled_matmul(
                [uy, ux], c, nf, k.w, k.beta, ty, sx, n,
                ((np.arange(ntiles), 1),),
            )
        )
    # Cover only half the tiles: occupied-but-unscanned tiles flagged.
    with pytest.raises(Exception, match="unscanned"):
        np.asarray(
            _spread_tiled_matmul(
                [uy, ux], c, nf, k.w, k.beta, ty, sx, n,
                ((np.arange(ntiles // 2), n),),
            )
        )


def test_engine_tile_class_planner_is_rigorous(monkeypatch):
    """The engine's host-planned class schedule must cover every tile the
    device assigns sources to, at sufficient capacity (FFTVIS_DEBUG would
    raise inside the jitted spread otherwise)."""
    from fftvis_tpu import TelescopeLocation, simulate_vis
    from fftvis_tpu.beams import GaussianBeam
    from fftvis_tpu.geometry import hex_array

    monkeypatch.setenv("FFTVIS_SPREADER", "tiled")
    monkeypatch.setenv("FFTVIS_DEBUG", "1")
    rng = np.random.default_rng(35)
    loc = TelescopeLocation(np.deg2rad(-30.7), np.deg2rad(21.4), 1000.0)
    nsrc = 600
    ra = rng.uniform(0, 2 * np.pi, nsrc)
    dec = np.clip(loc.lat + rng.normal(0, 0.5, nsrc), -np.pi / 2, np.pi / 2)
    ants = hex_array(5, sep=110.0)  # wide array -> large type-3 grid
    vis = simulate_vis(
        ants=ants,
        fluxes=rng.uniform(0.1, 1.0, (nsrc, 2)),
        ra=ra, dec=dec,
        freqs=np.array([1.0e8, 1.3e8]),
        times=2459863.2 + np.linspace(0, 0.05, 3),
        beam=GaussianBeam(diameter=12.0),
        telescope_loc=loc,
        polarized=False,
        precision=2,
        force_use_type3=True,
    )
    assert np.all(np.isfinite(vis))


def test_fit_plan_precorr_fills_probe_plans():
    """Plans built with fit_precorr=False (engine cost-model probes) carry
    no chebfit; fit_plan_precorr fills them to match an eagerly-fitted
    plan, and is a no-op on already-fitted plans."""
    from fftvis_tpu.nufft.transform import fit_plan_precorr, plan_type3

    rng = np.random.default_rng(11)
    s = rng.uniform(-40, 40, (2, 64))
    lazy = plan_type3(s, [2 * np.pi, 2 * np.pi], 1e-6, 2.0, fit_precorr=False)
    assert all(c is None for c in lazy.ft_coefs)
    eager = plan_type3(s, [2 * np.pi, 2 * np.pi], 1e-6, 2.0)
    fitted = fit_plan_precorr(lazy)
    assert fit_plan_precorr(fitted) is fitted
    for cf, ce in zip(fitted.ft_coefs, eager.ft_coefs):
        np.testing.assert_array_equal(cf, ce)
    # deconv/taps are unaffected by the fit flag
    for a, b in zip(lazy.deconv, eager.deconv):
        np.testing.assert_array_equal(a, b)


def test_type1_exact_unknown_cmm_raises(monkeypatch):
    """A typo'd FFTVIS_EXACT_CMM must raise, not silently measure the
    default contraction (the silent-knob trap class)."""
    from fftvis_tpu.nufft.transform import Type1ExactExecutor, plan_type1_exact

    rng = np.random.default_rng(35)
    n, C, km = 300, 70, 8
    x = rng.uniform(0, 2 * np.pi, size=(2, n))
    c = rng.normal(size=(C, n)) + 1j * rng.normal(size=(C, n))
    modes = rng.integers(-km, km + 1, size=(2, 61))
    ex = Type1ExactExecutor(plan_type1_exact(modes))
    monkeypatch.setenv("FFTVIS_EXACT_OUTER", "1")
    monkeypatch.setenv("FFTVIS_EXACT_CMM", "karastuba")  # typo
    with pytest.raises(ValueError, match="FFTVIS_EXACT_CMM"):
        ex.spread(jnp.asarray(x), jnp.asarray(c))
