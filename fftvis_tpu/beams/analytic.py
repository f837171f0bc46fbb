"""Analytic primary beams, evaluable in JAX.

Standalone replacements for the pyuvdata analytic beams the reference relies
on (AiryBeam / GaussianBeam, used throughout its tests and tutorials; ref
SURVEY section 2.4). Conventions follow pyuvdata so the two ecosystems agree:

  - E-field beams have Naxes_vec = 2 (az, za components) and Nfeeds = 2.
    For azimuthally-symmetric unpolarized beams every (vec, feed) component
    is amplitude / sqrt(2), so the power beam is amplitude^2.
  - GaussianBeam(diameter) uses the pyuvdata diameter_to_sigma mapping
    sigma = 2/2.355 * arcsin(2.2 * lambda / (pi * diameter)); the E-field
    amplitude is exp(-za^2 / (2 sigma^2)).
  - AiryBeam(diameter): 2 J1(x)/x with x = pi * diameter * sin(za) * f / c.

All evaluations are pure jnp (traceable under jit/vmap); J1 is implemented
from the Abramowitz & Stegun rational approximations, since jax.scipy has no
Bessel J1 to trace into the device program.
"""

from __future__ import annotations

import numpy as np

from ..core.utils import speed_of_light


def bessel_j1(x):
    """Bessel function of the first kind, order 1 (A&S 9.4.4-9.4.6).

    Absolute accuracy ~< 1e-7 everywhere (the classic single-precision
    rational fits), adequate for beam amplitudes. Works on np or jnp arrays.
    """
    import jax.numpy as jnp

    xp = jnp if not isinstance(x, np.ndarray) else np
    ax = xp.abs(x)

    # |x| < 8: rational polynomial fit.
    y = x * x
    num = x * (
        72362614232.0
        + y
        * (
            -7895059235.0
            + y
            * (
                242396853.1
                + y * (-2972611.439 + y * (15704.48260 + y * (-30.16036606)))
            )
        )
    )
    den = 144725228442.0 + y * (
        2300535178.0
        + y * (18583304.74 + y * (99447.43394 + y * (376.9991397 + y)))
    )
    small = num / den

    # |x| >= 8: asymptotic form.
    z = 8.0 / xp.where(ax < 1e-30, 1e-30, ax)
    y2 = z * z
    xx = ax - 2.356194491
    p0 = (
        1.0
        + y2
        * (0.183105e-2 + y2 * (-0.3516396496e-4 + y2 * (0.2457520174e-5 + y2 * (-0.240337019e-6))))
    )
    q0 = 0.04687499995 + y2 * (
        -0.2002690873e-3 + y2 * (0.8449199096e-5 + y2 * (-0.88228987e-6 + y2 * 0.105787412e-6))
    )
    big = (
        xp.sqrt(0.636619772 / xp.where(ax < 1e-30, 1e-30, ax))
        * (xp.cos(xx) * p0 - z * xp.sin(xx) * q0)
        * xp.sign(x)
    )
    return xp.where(ax < 8.0, small, big)


def diameter_to_sigma(diameter: float, freqs):
    """pyuvdata's Gaussian-width-from-dish-diameter mapping."""
    import jax.numpy as jnp

    xp = jnp if not isinstance(freqs, (float, np.ndarray)) else np
    wavelengths = speed_of_light / freqs
    scale = 2.2  # pyuvdata's Airy-to-Gaussian width ratio
    return xp.arcsin(scale * wavelengths / (np.pi * diameter)) * 2.0 / 2.355


class AnalyticBeam:
    """Base class: azimuthally-symmetric unpolarized analytic E-field beam."""

    beam_type = "efield"
    basis = "az_za"
    Nfeeds = 2
    Naxes_vec = 2

    def amplitude(self, za, freq):
        """Scalar E-field amplitude at zenith angle ``za`` (jnp-traceable)."""
        raise NotImplementedError

    def efield(self, az, za, freq):
        """Jones response, shape (2 vec, 2 feed, nsrc) complex."""
        import jax.numpy as jnp

        amp = self.amplitude(za, freq) / jnp.sqrt(2.0)
        one = jnp.broadcast_to(amp, jnp.shape(az))
        return jnp.broadcast_to(one[None, None, :], (2, 2, one.shape[0])) + 0j

    def power(self, az, za, freq, feed: str = "x"):
        """Power response for a single feed, shape (nsrc,) real."""
        import jax.numpy as jnp

        del feed  # symmetric beams: feeds identical
        amp = self.amplitude(za, freq)
        return jnp.asarray(amp) ** 2


class GaussianBeam(AnalyticBeam):
    """Gaussian beam, from an explicit sigma or a dish diameter.

    Parameters mirror pyuvdata: exactly one of ``sigma`` / ``diameter``;
    ``spectral_index`` scales sigma as (f / reference_frequency)^alpha.
    """

    def __init__(
        self,
        diameter: float | None = None,
        sigma: float | None = None,
        spectral_index: float = 0.0,
        reference_frequency: float | None = None,
    ):
        if (diameter is None) == (sigma is None):
            raise ValueError("GaussianBeam needs exactly one of diameter/sigma.")
        if spectral_index != 0.0 and reference_frequency is None:
            raise ValueError("spectral_index requires reference_frequency.")
        self.diameter = diameter
        self.sigma = sigma
        self.spectral_index = spectral_index
        self.reference_frequency = reference_frequency

    def _sigma(self, freq):
        if self.diameter is not None:
            return diameter_to_sigma(self.diameter, freq)
        sigma = self.sigma
        if self.spectral_index != 0.0:
            sigma = sigma * (freq / self.reference_frequency) ** self.spectral_index
        return sigma

    def amplitude(self, za, freq):
        import jax.numpy as jnp

        sigma = self._sigma(freq)
        return jnp.exp(-(za**2) / (2.0 * sigma**2))


class AiryBeam(AnalyticBeam):
    """Uniform-disk (Airy) beam for a dish of the given diameter (m)."""

    def __init__(self, diameter: float):
        self.diameter = diameter

    def amplitude(self, za, freq):
        import jax.numpy as jnp

        x = np.pi * self.diameter * freq / speed_of_light * jnp.sin(za)
        small = jnp.abs(x) < 1e-6
        xs = jnp.where(small, 1.0, x)
        return jnp.where(small, 1.0 - x * x / 8.0, 2.0 * bessel_j1(xs) / xs)


class UniformBeam(AnalyticBeam):
    """Unit response everywhere (above and below horizon alike)."""

    def amplitude(self, za, freq):
        import jax.numpy as jnp

        return jnp.ones_like(jnp.asarray(za))


class ShortDipoleBeam(AnalyticBeam):
    """Crossed short (Hertzian) dipoles: a genuinely polarized analytic beam.

    Feed x is an east-west dipole, feed y north-south; components follow the
    standard (az, za) basis with the UVBeam azimuth convention (east = 0,
    counterclockwise toward north).
    """

    def efield(self, az, za, freq):
        import jax.numpy as jnp

        caz, saz = jnp.cos(az), jnp.sin(az)
        cza = jnp.cos(za)
        # rows: vec (az, za); cols: feed (x, y)
        row_az = jnp.stack([-saz, caz], axis=0)  # (2 feed, n)
        row_za = jnp.stack([cza * caz, cza * saz], axis=0)
        return jnp.stack([row_az, row_za], axis=0) + 0j  # (2, 2, n)

    def amplitude(self, za, freq):  # pragma: no cover - not used for dipoles
        raise NotImplementedError("ShortDipoleBeam has no scalar amplitude.")

    def power(self, az, za, freq, feed: str = "x"):
        import jax.numpy as jnp

        e = self.efield(az, za, freq)
        fi = {"x": 0, "y": 1}[feed]
        return jnp.real(jnp.sum(jnp.abs(e[:, fi, :]) ** 2, axis=0))
