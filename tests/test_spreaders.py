"""The 2D ES spreaders vs an independent float64 NumPy spread.

``FFTVIS_SPREADER=auto`` lowers to XLA scatter-add on every backend, and
the dense-matmul form stays selectable. Both must reproduce the direct
definition of spreading: each source adds ``c * psi(u_y - k_y) *
psi(u_x - k_x)`` to every fine-grid cell ``k`` within the kernel's support,
with periodic wraps. The reference here evaluates that definition densely
in float64 (periodic distance to every cell), sharing nothing with the
device code but the kernel formula.

Reference anchor: the spreading half of finufft type-1/type-3
(ref /root/reference/src/fftvis/cpu/nufft.py:48-175).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fftvis_tpu.nufft.kernels import ESKernel, es_kernel_grid
from fftvis_tpu.nufft.transform import _spread_auto, _spread_dense_matmul


def _mk(n, nf, C, seed, cluster):
    """Uniform sources, or sources clustered across the periodic seam of
    both axes (every wrap path at once)."""
    rng = np.random.default_rng(seed)
    if cluster:
        u = [np.mod(rng.normal(0, 2.0, n), m) for m in nf]
    else:
        u = [rng.uniform(0, m, n) for m in nf]
    c = rng.normal(size=(C, n)) + 1j * rng.normal(size=(C, n))
    return u, c


def _reference(u, c, nf, kern):
    """Dense float64 spread by definition: (C, nfy, nfx)."""
    fac = []
    for ua, m in zip(u, nf):
        k = np.arange(m)
        t = np.mod(ua[:, None] - k[None, :] + m / 2, m) - m / 2  # periodic
        fac.append(es_kernel_grid(t, kern.w, kern.beta))
    return np.einsum("cn,ny,nx->cyx", c, fac[0], fac[1])


GEOMETRIES = [
    (97, (64, 80)),     # few sources, many empty cells
    (400, (48, 48)),    # square grid, heavy wraps
    (1000, (128, 96)),  # many sources
]


@pytest.mark.parametrize("spreader", ["auto", "dense"])
@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("cluster", [False, True])
@pytest.mark.parametrize("n,nf", GEOMETRIES)
def test_spreader_matches_definition(n, nf, C, cluster, spreader, monkeypatch):
    kern = ESKernel.from_eps(1e-6, sigma=2.0)
    u, c = _mk(n, nf, C, seed=n + C, cluster=cluster)
    monkeypatch.setenv("FFTVIS_SPREADER", spreader)
    got = np.asarray(
        _spread_auto([jnp.asarray(a) for a in u], jnp.asarray(c), nf,
                     kern.w, kern.beta)
    )
    want = _reference(u, c, nf, kern)
    assert got.shape == want.shape == (C,) + nf
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max(), rtol=0)


def test_ds_low_parts_shift_sources():
    """Double-single low parts move every source by their value: the
    spread equals the definition at the shifted positions."""
    kern = ESKernel.from_eps(1e-6, sigma=2.0)
    nf, n = (64, 64), 300
    u, c = _mk(n, nf, 1, seed=3, cluster=False)
    lo = [np.full(n, 0.25), np.full(n, -0.25)]
    got = np.asarray(
        _spread_dense_matmul([jnp.asarray(a) for a in u], jnp.asarray(c), nf,
                             kern.w, kern.beta,
                             u_lo_list=[jnp.asarray(a) for a in lo])
    )
    want = _reference([np.mod(a + b, m) for a, b, m in zip(u, lo, nf)], c, nf,
                      kern)
    np.testing.assert_allclose(got, want, atol=1e-12 * np.abs(want).max(), rtol=0)
