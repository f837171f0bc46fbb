"""The plain tap-gather interpolation of the type-3 transform.

On every backend the type-2 half of the type-3 transform evaluates the
deconvolved fine grid at each target with a w x w gather of taps
(``Type3Executor.interpolate``). These tests pin it against the exact
direct sum (the transform's last step is the only place the target
coordinates enter) and against the host-planned window form that
``FFTVIS_INTERP=tiled`` selects, at clustered target sets like those of a
baseline distribution.

Reference anchor: the interpolation half of finufft type-3
(ref /root/reference/src/fftvis/cpu/nufft.py:48-118).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fftvis_tpu.nufft import direct_type3_np, plan_type3
from fftvis_tpu.nufft.transform import Type3Executor, _TiledInterp

# (targets m, channels C, fine-grid size hint): a few hundred targets
# clustered at the origin on 400-512 cell grids.
GEOMETRIES = [(300, 1, 400), (700, 2, 400), (500, 1, 512)]


def _targets(m, nf_hint, seed):
    """m clustered 2D targets; nf ~ 2 sigma^2 X S / pi with X = 2 pi sets
    the target half-extent S ~ nf_hint / 16 at sigma = 2."""
    rng = np.random.default_rng(seed)
    S = nf_hint / 16.0
    return np.concatenate(
        [rng.normal(0, S / 10, (2, m // 2)), rng.uniform(-S, S, (2, m - m // 2))],
        axis=1,
    )


@pytest.mark.parametrize("subset", [False, True])
@pytest.mark.parametrize("m,C,nf_hint", GEOMETRIES)
def test_gather_interp_matches_direct_sum(m, C, nf_hint, subset):
    """spread -> FFT -> tap gather equals the exact type-3 sum, on all
    targets or on a static subset (the engine's per-beam-pair slices)."""
    rng = np.random.default_rng(m + C)
    s = _targets(m, nf_hint, seed=m)
    plan = plan_type3(s, x_extent=2 * np.pi, eps=1e-6, upsample_factor=2.0)
    n = 400
    x = rng.uniform(-np.pi, np.pi, (2, n))
    c = rng.normal(size=(C, n)) + 1j * rng.normal(size=(C, n))
    sel = None
    if subset:
        sel = np.sort(rng.choice(m, size=m // 3, replace=False))
    ex = Type3Executor(plan)
    G = ex.transform(ex.spread(jnp.asarray(x), jnp.asarray(c)))
    got = np.asarray(ex.interpolate(G, sel))
    want = direct_type3_np(x, c, s if sel is None else s[:, sel])
    assert got.shape == want.shape == (C, m if sel is None else len(sel))
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 30 * 1e-6, err


@pytest.mark.parametrize("m,C,nf_hint", GEOMETRIES)
def test_gather_interp_matches_window_form(m, C, nf_hint, monkeypatch):
    """The default gather and the FFTVIS_INTERP=tiled window form read the
    same host-planned taps: only the schedule differs."""
    rng = np.random.default_rng(3 * m)
    plan = plan_type3(_targets(m, nf_hint, seed=m + 1), x_extent=2 * np.pi,
                      eps=1e-6, upsample_factor=2.0)
    G = jnp.asarray(
        rng.normal(size=(C,) + tuple(plan.nf))
        + 1j * rng.normal(size=(C,) + tuple(plan.nf)),
        jnp.complex64,
    )
    monkeypatch.setenv("FFTVIS_INTERP", "auto")
    got = np.asarray(Type3Executor(plan).interpolate(G))
    want = np.asarray(_TiledInterp(plan)(G))
    np.testing.assert_allclose(got, want, atol=3e-6 * np.abs(want).max(), rtol=0)
