"""Double-single arithmetic: each primitive vs float64 ground truth.

The DS layer (fftvis_tpu/tpu/ds.py) underpins the fp64-class direct path
of the fp32 engine; these tests pin every building block at its expected
accuracy (error-free transformations exactly; composite ops at ~2^-45;
sincos at the f32-transcendental floor) on the CPU backend, where float64
reference values are available in-process, and the ``gpu``-marked class
repeats the invariants jitted on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from fftvis_tpu.tpu import ds

RNG = np.random.default_rng(42)


def _rand(n=20000, scale_pow=6):
    return RNG.normal(size=n) * np.exp(RNG.uniform(-scale_pow, scale_pow, n))


def _f32(x):
    return jnp.asarray(np.asarray(x, dtype=np.float32))


class TestErrorFree:
    def test_two_sum_exact(self):
        a64, b64 = _rand(), _rand()
        a, b = _f32(a64), _f32(b64)
        s, e = ds.two_sum(a, b)
        got = np.asarray(s, np.float64) + np.asarray(e, np.float64)
        want = np.asarray(a, np.float64) + np.asarray(b, np.float64)
        np.testing.assert_array_equal(got, want)

    def test_two_prod_exact(self):
        a, b = _f32(_rand()), _f32(_rand())
        p, e = ds.two_prod(a, b)
        got = np.asarray(p, np.float64) + np.asarray(e, np.float64)
        want = np.asarray(a, np.float64) * np.asarray(b, np.float64)
        np.testing.assert_array_equal(got, want)


def _ds_of(x64):
    hi, lo = ds.split64(x64)
    return jnp.asarray(hi), jnp.asarray(lo)


def _val(pair):
    return np.asarray(pair[0], np.float64) + np.asarray(pair[1], np.float64)


class TestComposite:
    def test_split64_roundtrip(self):
        x = _rand()
        hi, lo = ds.split64(x)
        np.testing.assert_array_equal(
            hi.astype(np.float64) + lo.astype(np.float64),
            x.astype(np.float32).astype(np.float64)
            + (x - x.astype(np.float32).astype(np.float64)).astype(
                np.float32
            ).astype(np.float64),
        )
        # ~49-bit effective mantissa.
        assert np.max(np.abs(hi.astype(np.float64) + lo - x) / np.abs(x)) < 2**-45

    def test_ds_add(self):
        a64, b64 = _rand(), _rand()
        got = _val(ds.ds_add(*_ds_of(a64), *_ds_of(b64)))
        want = a64 + b64
        denom = np.maximum(np.abs(want), np.abs(a64) + np.abs(b64))
        assert np.max(np.abs(got - want) / denom) < 2**-44

    def test_ds_mul(self):
        a64, b64 = _rand(), _rand()
        got = _val(ds.ds_mul(*_ds_of(a64), *_ds_of(b64)))
        want = a64 * b64
        assert np.max(np.abs(got - want) / np.abs(want)) < 2**-44

    def test_ds_mul_f32(self):
        a64 = _rand()
        b = np.asarray(_rand(), dtype=np.float32)
        got = _val(ds.ds_mul_f32(*_ds_of(a64), jnp.asarray(b)))
        want = a64 * b.astype(np.float64)
        assert np.max(np.abs(got - want) / np.abs(want)) < 2**-44

    def test_ds_dot3(self):
        a64 = [_rand(1000, 2) for _ in range(3)]
        b64 = [_rand(1000, 2) for _ in range(3)]
        got = _val(ds.ds_dot3([_ds_of(a) for a in a64], [_ds_of(b) for b in b64]))
        want = sum(a * b for a, b in zip(a64, b64))
        scale = sum(np.abs(a * b) for a, b in zip(a64, b64))
        assert np.max(np.abs(got - want) / scale) < 2**-40


class TestAngles:
    def test_mod_two_pi_large_angles(self):
        theta = RNG.uniform(-3e4, 3e4, 20000)
        h, l = ds.ds_mod_two_pi(*_ds_of(theta))
        got = _val((h, l))
        want = theta - 2 * np.pi * np.round(theta / (2 * np.pi))
        # Compare as angles (mod 2pi): both in (-2pi, 2pi).
        diff = np.abs(np.exp(1j * got) - np.exp(1j * want))
        assert diff.max() < 1e-6

    def test_sincos_accuracy(self):
        theta = RNG.uniform(-3e4, 3e4, 20000)
        s, c = ds.ds_sincos(*_ds_of(theta))
        err = np.hypot(
            np.asarray(s, np.float64) - np.sin(theta),
            np.asarray(c, np.float64) - np.cos(theta),
        )
        # f32-transcendental floor (vs ~2e-3 for plain f32 at |theta|=3e4).
        assert err.max() < 5e-7
        plain = np.hypot(
            np.sin(theta.astype(np.float32)).astype(np.float64) - np.sin(theta),
            np.cos(theta.astype(np.float32)).astype(np.float64) - np.cos(theta),
        )
        assert err.max() < plain.max() / 100

    def test_unit_circle(self):
        theta = RNG.uniform(-1e3, 1e3, 5000)
        s, c = ds.ds_sincos(*_ds_of(theta))
        r = np.asarray(s, np.float64) ** 2 + np.asarray(c, np.float64) ** 2
        assert np.abs(r - 1).max() < 1e-6


class TestModN:
    def test_mod_n_matches_f64(self):
        """General integer modulus: DS value into [0, n) at DS accuracy
        (grid-coordinate reduction for the fp32 NUFFT paths)."""
        from fftvis_tpu.tpu.ds import split64

        for n in (82, 96, 4096, 250000):
            y = RNG.uniform(-40, 40, 20000) * n  # |y|/n up to 40
            h, l = ds.ds_mod_n(*(jnp.asarray(p) for p in split64(y)), n)
            got = np.asarray(h, np.float64) + np.asarray(l, np.float64)
            want = np.mod(y, n)
            d = np.abs(got - want)
            d = np.minimum(d, n - d)  # 0 == n wrap
            # DS floor scales with the PRE-mod magnitude |y| (the input
            # pair's own representation error), not with n.
            assert d.max() < np.abs(y).max() * 2**-45
            hv = np.asarray(h, np.float64)
            assert hv.min() >= 0.0 and hv.max() <= n

    def test_mod_n_plain_f32_is_much_worse(self):
        n = 4096
        y = RNG.uniform(-40, 40, 20000) * n
        from fftvis_tpu.tpu.ds import split64

        h, l = ds.ds_mod_n(*(jnp.asarray(p) for p in split64(y)), n)
        got = np.asarray(h, np.float64) + np.asarray(l, np.float64)
        want = np.mod(y, n)
        plain = np.mod(y.astype(np.float32), np.float32(n)).astype(np.float64)
        d_ds = np.minimum(np.abs(got - want), n - np.abs(got - want)).max()
        d_pl = np.minimum(np.abs(plain - want), n - np.abs(plain - want)).max()
        assert d_ds < d_pl / 1e4


class TestReduction:
    def test_pairwise_sum_vs_f64(self):
        # Adversarial: large cancelling values + small residuals.
        big = _rand(4096, 6)
        x = np.concatenate([big, -big + RNG.normal(size=4096) * 1e-6])
        RNG.shuffle(x)
        h, l = ds.ds_sum_pairwise(*_ds_of(x.reshape(1, -1)), axis=1)
        got = float((np.asarray(h, np.float64) + np.asarray(l, np.float64)).reshape(()))
        want = float(np.sum(x))
        f32_err = abs(float(np.sum(x.astype(np.float32))) - want)
        assert abs(got - want) <= max(1e-9 * np.abs(x).sum(), f32_err / 1e4)

    def test_pairwise_sum_axis_and_shape(self):
        x = _rand(6 * 35, 3).reshape(6, 35)
        h, l = ds.ds_sum_pairwise(*_ds_of(x), axis=1)
        assert h.shape == (6,)
        np.testing.assert_allclose(
            np.asarray(h, np.float64) + np.asarray(l, np.float64),
            x.sum(axis=1),
            rtol=2**-40, atol=0,
        )


@pytest.mark.gpu
class TestJittedOnGPU:
    """The same invariants with each primitive inside one jitted program.

    XLA on the GPU may contract a multiply and an add into one FMA, which
    would break the error-free transformations; eager dispatch (the tests
    above) never fuses, so these compile the primitives first.
    """

    def test_two_sum_and_two_prod_exact(self):
        import jax

        a, b = _f32(_rand()), _f32(_rand())
        s, e = jax.jit(ds.two_sum)(a, b)
        p, q = jax.jit(ds.two_prod)(a, b)
        a64, b64 = np.asarray(a, np.float64), np.asarray(b, np.float64)
        np.testing.assert_array_equal(_val((s, e)), a64 + b64)
        np.testing.assert_array_equal(_val((p, q)), a64 * b64)

    def test_ds_mul_and_mod_n(self):
        import jax

        a64, b64 = _rand(), _rand()
        got = _val(jax.jit(ds.ds_mul)(*_ds_of(a64), *_ds_of(b64)))
        assert np.max(np.abs(got - a64 * b64) / np.abs(a64 * b64)) < 2**-44
        n = 4096
        y = RNG.uniform(-40, 40, 20000) * n
        h, l = jax.jit(ds.ds_mod_n, static_argnums=2)(*_ds_of(y), n)
        d = np.abs(_val((h, l)) - np.mod(y, n))
        assert np.minimum(d, n - d).max() < np.abs(y).max() * 2**-45

    def test_sincos_accuracy(self):
        import jax

        theta = RNG.uniform(-3e4, 3e4, 20000)
        s, c = jax.jit(ds.ds_sincos)(*_ds_of(theta))
        err = np.hypot(
            np.asarray(s, np.float64) - np.sin(theta),
            np.asarray(c, np.float64) - np.cos(theta),
        )
        assert err.max() < 5e-7
