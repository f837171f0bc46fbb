"""Differentiable-simulation front-end (fftvis_tpu.autodiff).

The reference cannot differentiate through finufft/Numba; here the whole
simulation is one pure XLA program, so ``build_differentiable_sim`` must:
(a) reproduce ``simulate_vis`` exactly on the same configuration, and
(b) deliver correct reverse-mode gradients (validated against finite
differences and against the linearity of vis in the source coherency).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fftvis_tpu import TelescopeLocation, build_differentiable_sim, simulate_vis
from fftvis_tpu.beams import AiryBeam, GaussianBeam
from fftvis_tpu.beams.gridded import GriddedBeam
from fftvis_tpu.geometry import hex_array

LOC = TelescopeLocation(np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
JD0 = 2459863.2


def _case(rng, nsrc=48, ntimes=2, nfreq=2, polarized=False, stokes=False,
          nant=6, **extra):
    ants = {i: np.array([*rng.uniform(-60, 60, 2), 0.0]) for i in range(nant)}
    ra = rng.uniform(0, 2 * np.pi, nsrc)
    dec = np.clip(LOC.lat + rng.normal(0, 0.4, nsrc), -np.pi / 2, np.pi / 2)
    freqs = np.linspace(1.0e8, 1.1e8, nfreq)
    if stokes:
        flux = np.zeros((nsrc, nfreq, 4))
        flux[..., 0] = rng.uniform(0.5, 1.0, (nsrc, nfreq))
        flux[..., 1] = rng.uniform(-0.2, 0.2, (nsrc, nfreq))
        flux[..., 2] = rng.uniform(-0.2, 0.2, (nsrc, nfreq))
        flux[..., 3] = rng.uniform(-0.1, 0.1, (nsrc, nfreq))
    else:
        flux = rng.uniform(0.1, 1.0, (nsrc, nfreq))
    times = JD0 + np.linspace(0, 0.02, ntimes)
    return dict(
        ants=ants, fluxes=flux, ra=ra, dec=dec, freqs=freqs, times=times,
        beam=GaussianBeam(diameter=10.0), telescope_loc=LOC,
        polarized=polarized, precision=2, **extra,
    )


@pytest.mark.parametrize(
    "polarized,stokes,force3",
    [(False, False, True), (True, False, True), (True, True, True),
     (False, False, False)],
)
def test_sim_fn_matches_simulate_vis(polarized, stokes, force3):
    rng = np.random.default_rng(3)
    kw = _case(rng, polarized=polarized, stokes=stokes,
               force_use_type3=force3)
    if not force3:
        kw["ants"] = hex_array(3)
    want = simulate_vis(backend="tpu", **kw)
    sim_fn, params = build_differentiable_sim(**kw)
    got = np.asarray(sim_fn(params))
    assert got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-12 * scale, rtol=0)


def test_grad_fluxes_matches_finite_difference():
    rng = np.random.default_rng(5)
    kw = _case(rng, nsrc=24, force_use_type3=True)
    sim_fn, params = build_differentiable_sim(**kw)

    data = sim_fn(params) * 0.9  # synthetic "measured" target

    def loss(p):
        r = sim_fn(p) - data
        return jnp.sum(jnp.abs(r) ** 2)

    g = jax.grad(loss)(params)["fluxes"]
    assert g.shape == params["fluxes"].shape

    # vis is LINEAR in flux, so loss is quadratic: central differences are
    # exact up to roundoff.
    f0 = np.asarray(params["fluxes"])
    for idx in [(0, 0), (7, 1), (23, 0)]:
        h = 1e-3
        fp, fm = f0.copy(), f0.copy()
        fp[idx] += h
        fm[idx] -= h
        lp = float(loss({"fluxes": jnp.asarray(fp)}))
        lm = float(loss({"fluxes": jnp.asarray(fm)}))
        fd = (lp - lm) / (2 * h)
        assert np.isfinite(fd)
        np.testing.assert_allclose(float(g[idx]), fd, rtol=1e-6, atol=1e-12)


def test_grad_linearity_exactness():
    """d(vis)/d(flux_j) contracted with w == vis evaluated at flux=w."""
    rng = np.random.default_rng(6)
    kw = _case(rng, nsrc=16, nfreq=1, ntimes=1, force_use_type3=True)
    sim_fn, params = build_differentiable_sim(**kw)

    w = rng.uniform(0.1, 1.0, params["fluxes"].shape)
    # loss = Re <vis, c> for a fixed complex probe c  =>  grad wrt flux is
    # Re(J^H c); and vis(w) = J w by linearity.
    c = rng.normal(size=sim_fn(params).shape) + 1j * rng.normal(
        size=sim_fn(params).shape
    )

    def lin(p):
        return jnp.sum(jnp.real(sim_fn(p) * jnp.conj(jnp.asarray(c))))

    g = np.asarray(jax.grad(lin)(params)["fluxes"])
    lhs = float(np.sum(g * w))
    rhs = float(np.sum(np.real(np.asarray(sim_fn({"fluxes": jnp.asarray(w)}))
                               * np.conj(c))))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)


def test_grad_beam_table():
    # Per-antenna beam calibration scenario: >= 2 same-grid tabulated
    # beams ride the engine's stacked-table input (the differentiable
    # surface); a lone tabulated beam is a closure constant instead.
    rng = np.random.default_rng(7)
    gbs = [
        GriddedBeam.from_function(
            GaussianBeam(diameter=10.0 + 0.5 * i), n_az=73, n_za=37,
            freqs=(1.0e8, 1.1e8),
        )
        for i in range(2)
    ]
    kw = _case(rng, nsrc=20, force_use_type3=True)
    kw["beam"] = gbs
    kw["beam_idx"] = np.arange(len(kw["ants"])) % 2
    sim_fn, params = build_differentiable_sim(differentiate_beam=True, **kw)
    assert "beam_table" in params

    data = sim_fn(params) * 1.05

    def loss(p):
        r = sim_fn(p) - data
        return jnp.sum(jnp.abs(r) ** 2)

    g = jax.grad(loss)(params)
    gt = np.asarray(g["beam_table"])
    assert gt.shape == params["beam_table"].shape
    assert np.isfinite(gt).all()
    assert np.abs(gt).max() > 0  # gradients actually flow into the table

    # Finite-difference check at the largest-|grad| WELL-CONDITIONED entry:
    # the unpolarized path's sqrt(B_i * B_j) has unbounded local slope where
    # the power beam underflows toward zero (far tail), so finite
    # differences only probe the derivative where the table value is
    # meaningfully nonzero (the autodiff module docstring documents this).
    t0 = np.asarray(params["beam_table"], dtype=float)
    cond = np.abs(t0) > 1e-2 * np.abs(t0).max()
    flat = np.argmax(np.abs(np.where(cond, gt, 0.0)))
    idx = np.unravel_index(flat, gt.shape)
    h = 1e-4 * max(1.0, abs(t0[idx]))
    tp, tm = t0.copy(), t0.copy()
    tp[idx] += h
    tm[idx] -= h
    lp = float(loss({**params, "beam_table": jnp.asarray(tp)}))
    lm = float(loss({**params, "beam_table": jnp.asarray(tm)}))
    fd = (lp - lm) / (2 * h)
    np.testing.assert_allclose(float(gt[idx]), fd, rtol=5e-4)


def test_differentiate_beam_requires_table():
    rng = np.random.default_rng(8)
    kw = _case(rng, force_use_type3=True)
    kw["beam"] = AiryBeam(diameter=10.0)
    with pytest.raises(ValueError, match="tabulated"):
        build_differentiable_sim(differentiate_beam=True, **kw)


def test_ds_path_rejected():
    rng = np.random.default_rng(9)
    import os

    os.environ["FFTVIS_DS"] = "1"
    try:
        # DS engages only on fp32 compute (precision=1 here; on the GPU
        # precision=2 also resolves to fp32).
        kw = _case(rng, force_use_type3=True)
        kw["precision"] = 1
        with pytest.raises(ValueError, match="double-single"):
            build_differentiable_sim(**kw)
    finally:
        del os.environ["FFTVIS_DS"]


def test_jit_and_optimizer_recover_fluxes():
    """End-to-end calibration: gradient descent recovers perturbed fluxes."""
    rng = np.random.default_rng(11)
    kw = _case(rng, nsrc=12, nfreq=1, ntimes=1, nant=5, force_use_type3=True)
    sim_fn, params = build_differentiable_sim(**kw)
    true_flux = np.asarray(params["fluxes"])
    data = sim_fn({"fluxes": jnp.asarray(true_flux)})

    def loss(p):
        r = sim_fn(p) - data
        return jnp.sum(jnp.abs(r) ** 2)

    import optax

    step = jax.jit(jax.value_and_grad(loss))
    x = jnp.asarray(true_flux * (1.0 + 0.3 * rng.standard_normal(true_flux.shape)))
    opt = optax.adam(3e-2)
    state = opt.init(x)
    l0 = None
    for _ in range(300):
        val, g = step({"fluxes": x})
        if l0 is None:
            l0 = float(val)
        upd, state = opt.update(g["fluxes"], state)
        x = optax.apply_updates(x, upd)
    assert float(val) < 1e-4 * l0  # loss dropped by >= 4 orders of magnitude


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_sim_and_grad_match_single_device():
    """Mesh-sharded differentiable sim: values AND gradients must equal the
    single-device ones (gradients flow through shard_map + psum)."""
    from fftvis_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(12)
    kw = _case(rng, nsrc=40, ntimes=4, nfreq=2, force_use_type3=True)
    sim_fn, params = build_differentiable_sim(**kw)
    sim_fn_sh, params_sh = build_differentiable_sim(
        mesh=make_mesh(time=2, source=4), **kw
    )

    got = np.asarray(sim_fn_sh(params_sh))
    want = np.asarray(sim_fn(params))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=1e-11 * scale, rtol=0)

    data = want * 0.93

    def loss(fn):
        return lambda p: jnp.sum(jnp.abs(fn(p) - data) ** 2)

    g = np.asarray(jax.grad(loss(sim_fn))(params)["fluxes"])
    g_sh = np.asarray(jax.grad(loss(sim_fn_sh))(params_sh)["fluxes"])
    np.testing.assert_allclose(g_sh, g, atol=1e-10 * np.abs(g).max(), rtol=0)


@pytest.mark.parametrize("polarized", [False, True])
def test_gains_unity_and_formula(polarized):
    """Unity gains are a no-op; arbitrary gains apply the engine-convention
    factor conj(g_i^b) g_j^a (single shared beam -> no pair flips here)."""
    rng = np.random.default_rng(13)
    kw = _case(rng, nsrc=20, polarized=polarized, force_use_type3=True)
    sim_fn, params = build_differentiable_sim(differentiate_gains=True, **kw)
    assert "gains" in params

    base = np.asarray(sim_fn({"fluxes": params["fluxes"]}))
    unity = np.asarray(sim_fn(params))
    np.testing.assert_allclose(unity, base, rtol=0, atol=0)

    g = np.asarray(params["gains"]).copy()
    g[0] = rng.uniform(0.5, 1.5, g[0].shape)
    g[1] = rng.uniform(-0.5, 0.5, g[1].shape)
    got = np.asarray(sim_fn({**params, "gains": jnp.asarray(g)}))

    # Independent host-side application: out[a, b] of baseline (i, j) is
    # <conj(v_i^b) v_j^a>, so gains enter as conj(g_i^b) g_j^a.
    from fftvis_tpu.core.utils import get_pos_reds

    bls = [red[0] for red in get_pos_reds(kw["ants"], include_autos=True)]
    ant_index = {a: i for i, a in enumerate(kw["ants"])}
    gc = g[0] + 1j * g[1]  # (nant, nf[, 2])
    want = base.copy()
    for b, (a0, a1) in enumerate(bls):
        i, j = ant_index[a0], ant_index[a1]
        if polarized:
            for fa in range(2):
                for fb in range(2):
                    want[:, :, fa, fb, b] *= np.conj(gc[i, :, fb, None]) * gc[
                        j, :, fa, None
                    ]
        else:
            want[:, :, b] *= (np.conj(gc[i]) * gc[j])[:, None]
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)


def test_gains_equal_phased_per_antenna_beams():
    """The convention anchor: applying params['gains'] must EXACTLY equal
    baking the same complex per-feed factors into each antenna's own
    E-field beam and re-simulating -- including on baselines the beam-pair
    router flips (where the engine, like the reference, conjugates without
    swapping feed axes; ref cpu_simulate.py:298-300)."""
    rng = np.random.default_rng(15)
    nant = 4
    kw = _case(rng, nsrc=18, nfreq=2, ntimes=2, nant=nant, polarized=True,
               force_use_type3=True)
    base = GriddedBeam.from_function(
        GaussianBeam(diameter=11.0), n_az=73, n_za=37, freqs=tuple(kw["freqs"])
    )
    gc = (rng.uniform(0.6, 1.4, (nant, 2, 2))
          * np.exp(1j * rng.uniform(-1.2, 1.2, (nant, 2, 2))))  # (ant, nf, feed)

    beams = []
    for k in range(nant):
        data = np.array(base.data_array)  # (vec, feed, nf, za, az)
        data *= gc[k].T[None, :, :, None, None]
        beams.append(GriddedBeam(data, base.axis1_array, base.axis2_array,
                                 base.freq_array, beam_type="efield"))
    kw_beams = {**kw, "beam": beams, "beam_idx": np.arange(nant)}
    want = simulate_vis(backend="tpu", **kw_beams)

    kw_base = {**kw, "beam": [base.copy() for _ in range(nant)],
               "beam_idx": np.arange(nant)}
    sim_fn, params = build_differentiable_sim(
        differentiate_gains=True, **kw_base
    )
    g = np.stack([gc.real, gc.imag]).astype(np.float32)
    got = np.asarray(sim_fn({**params, "gains": jnp.asarray(g)}))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=3e-6 * scale, rtol=0)

    # The anchor is only meaningful if some baselines actually flipped.
    from fftvis_tpu.core.utils import get_pos_reds

    bls = [red[0] for red in get_pos_reds(kw["ants"], include_autos=True)]
    ant_index = {a: i for i, a in enumerate(kw["ants"])}
    assert any(ant_index[a0] > ant_index[a1] for a0, a1 in bls)


def test_gain_calibration_recovers_products():
    """Fitting gains against gain-corrupted data recovers g_i g_j*
    (the observable combination; one global phase is degenerate)."""
    rng = np.random.default_rng(14)
    kw = _case(rng, nsrc=16, nfreq=1, ntimes=3, nant=6, force_use_type3=True)
    sim_fn, params = build_differentiable_sim(differentiate_gains=True, **kw)

    g_true = np.asarray(params["gains"]).copy()
    g_true[0] += 0.2 * rng.standard_normal(g_true[0].shape)
    g_true[1] += 0.2 * rng.standard_normal(g_true[1].shape)
    data = sim_fn({**params, "gains": jnp.asarray(g_true)})

    def loss(g):
        r = sim_fn({**params, "gains": g}) - data
        return jnp.sum(jnp.abs(r) ** 2)

    import optax

    step = jax.jit(jax.value_and_grad(loss))
    x = params["gains"]
    opt = optax.adam(2e-2)
    state = opt.init(x)
    for _ in range(500):
        val, grad = step(x)
        upd, state = opt.update(grad, state)
        x = optax.apply_updates(x, upd)
    assert float(val) < 1e-10

    gc_t = g_true[0] + 1j * g_true[1]
    gc_f = np.asarray(x[0] + 1j * x[1])
    prod_t = gc_t[:, None] * np.conj(gc_t[None, :])
    prod_f = gc_f[:, None] * np.conj(gc_f[None, :])
    np.testing.assert_allclose(prod_f, prod_t, rtol=0, atol=2e-3)
