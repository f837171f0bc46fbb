"""pyuvdata-UVBeam attribute-layout conformance.

pyuvdata is not installable in this image, so ``GriddedBeam.from_uvbeam``
is duck-typed; these tests drive it with synthetic objects replicating
pyuvdata's REAL attribute surface (UVBeam as of pyuvdata >= 3.1.2, the
reference's pinned minimum -- ref pyproject.toml:37):

- ``data_array`` axis order (Naxes_vec, Nfeeds, Nfreqs, Naxes2, Naxes1)
  for efield and (1, Npols, Nfreqs, Naxes2, Naxes1) for power, plus the
  legacy 6D (Nspws) layout;
- ``axis1_array`` = azimuth (rad, UVBeam convention: 0 = east, CCW toward
  north), ``axis2_array`` = zenith angle (rad, ascending from 0);
- ``freq_array`` modern (Nfreqs,) and legacy (1, Nfreqs) shapes;
- ``feed_array`` ('x','y') vs ('e','n') vs reversed orderings;
- ``x_orientation`` "east" vs "north" (which swaps the MEANING of the
  'x'/'y' labels);
- ``basis_vector_array`` (Naxes_vec, 2, Naxes2, Naxes1) -- must be the
  standard az/za unit basis;
- 4-pol power beams (polarization_array [-5,-6,-7,-8]) whose pol axis
  cannot be silently feed-reordered.

The end-to-end cases run a polarized simulation through the public API
with the adapted beam and compare against the same simulation with the
directly-constructed GriddedBeam (exact equality -- the adapter must be a
pure relabeling) and against the fp64 direct-DFT oracle.
"""

import numpy as np
import pytest

from fftvis_tpu import TelescopeLocation, simulate_vis
from fftvis_tpu.beams import GaussianBeam
from fftvis_tpu.beams.gridded import GriddedBeam

LOC = TelescopeLocation(np.deg2rad(-30.7), np.deg2rad(21.4), 1000.0)
FREQ = 1.1e8


def _native_beam(n_az=72, n_za=46, nfreq=1):
    freqs = FREQ + np.arange(nfreq) * 1e6
    return GriddedBeam.from_function(
        GaussianBeam(diameter=13.0), n_az=n_az, n_za=n_za, freqs=freqs,
        za_max=np.pi / 2,
    )


class FakeUVBeam:
    """Synthetic object with pyuvdata >= 3.1.2's UVBeam attribute surface."""

    def __init__(self, gb: GriddedBeam, *, feed_order=("x", "y"),
                 x_orientation="east", legacy_spw=False, legacy_freq=False,
                 with_basis=True, coordinate_system="az_za"):
        nvec, nfeed, nfreq, nza, naz = gb.data_array.shape
        self.Naxes_vec = nvec
        self.Nfeeds = nfeed
        self.Nfreqs = nfreq
        self.Naxes1 = naz
        self.Naxes2 = nza
        self.beam_type = gb.beam_type
        self.pixel_coordinate_system = coordinate_system
        self.data_normalization = "physical"
        self.axis1_array = gb.axis1_array.copy()
        self.axis2_array = gb.axis2_array.copy()
        self.freq_array = (
            gb.freq_array[None, :].copy() if legacy_freq else gb.freq_array.copy()
        )
        self.feed_array = np.asarray(feed_order)
        self.x_orientation = x_orientation
        data = gb.data_array.copy()
        # Native layout stores the east feed at index 0; express the data
        # in the requested pyuvdata feed labeling.
        order = []
        for f in feed_order:
            label = str(f).lower()
            if x_orientation == "north":
                label = {"x": "n", "y": "e", "e": "e", "n": "n"}[label]
            order.append({"x": 0, "e": 0, "y": 1, "n": 1}[label])
        data = data[:, order]
        if legacy_spw:
            data = data[:, None]  # (Naxes_vec, Nspws=1, Nfeeds, ...)
            self.Nspws = 1
        self.data_array = data
        if with_basis:
            bva = np.zeros((2, 2, nza, naz))
            bva[0, 0] = 1.0
            bva[1, 1] = 1.0
            self.basis_vector_array = bva


def _sim_kwargs(nsrc=40, polarized=True):
    rng = np.random.default_rng(2)
    ants = {i: np.array([*rng.uniform(-40, 40, 2), 0.0]) for i in range(4)}
    ra = rng.uniform(0, 2 * np.pi, nsrc)
    dec = np.clip(LOC.lat + rng.normal(0, 0.4, nsrc), -np.pi / 2, np.pi / 2)
    return dict(
        ants=ants, fluxes=rng.uniform(0.1, 1.0, (nsrc, 1)), ra=ra, dec=dec,
        freqs=np.array([FREQ]), times=2459863.2 + np.linspace(0, 0.01, 2),
        telescope_loc=LOC, polarized=polarized, precision=2,
    )


class TestAdapterLayouts:
    def test_modern_efield_layout_identical(self):
        gb = _native_beam()
        got = GriddedBeam.from_uvbeam(FakeUVBeam(gb))
        np.testing.assert_array_equal(got.data_array, gb.data_array)
        np.testing.assert_array_equal(got.axis1_array, gb.axis1_array)
        np.testing.assert_array_equal(got.axis2_array, gb.axis2_array)
        np.testing.assert_array_equal(got.freq_array, gb.freq_array)

    def test_legacy_spw_and_freq_layouts(self):
        gb = _native_beam(nfreq=2)
        got = GriddedBeam.from_uvbeam(
            FakeUVBeam(gb, legacy_spw=True, legacy_freq=True)
        )
        np.testing.assert_array_equal(got.data_array, gb.data_array)
        np.testing.assert_array_equal(got.freq_array, gb.freq_array)

    @pytest.mark.parametrize(
        "feed_order", [("x", "y"), ("e", "n"), ("n", "e"), ("y", "x")]
    )
    def test_feed_orderings_all_converge(self, feed_order):
        """Any pyuvdata feed ordering must adapt to east-first data."""
        gb = _native_beam()
        got = GriddedBeam.from_uvbeam(FakeUVBeam(gb, feed_order=feed_order))
        np.testing.assert_array_equal(got.data_array, gb.data_array)

    @pytest.mark.parametrize("feed_order", [("x", "y"), ("y", "x")])
    def test_x_orientation_north_swaps_feed_meaning(self, feed_order):
        """Under x_orientation='north' the 'x' label IS the north dipole;
        the adapter must land east at feed 0 regardless."""
        gb = _native_beam()
        got = GriddedBeam.from_uvbeam(
            FakeUVBeam(gb, feed_order=feed_order, x_orientation="north")
        )
        np.testing.assert_array_equal(got.data_array, gb.data_array)

    def test_bad_x_orientation_raises(self):
        gb = _native_beam()
        fake = FakeUVBeam(gb)
        fake.x_orientation = "up"
        with pytest.raises(ValueError, match="x_orientation"):
            GriddedBeam.from_uvbeam(fake)

    def test_rotated_basis_vectors_raise(self):
        gb = _native_beam()
        fake = FakeUVBeam(gb)
        fake.basis_vector_array = np.broadcast_to(
            np.array([[0.0, 1.0], [1.0, 0.0]])[:, :, None, None],
            fake.basis_vector_array.shape,
        ).copy()
        with pytest.raises(ValueError, match="basis"):
            GriddedBeam.from_uvbeam(fake)

    def test_healpix_coordinate_system_rejected(self):
        gb = _native_beam()
        with pytest.raises(ValueError, match="az_za"):
            GriddedBeam.from_uvbeam(
                FakeUVBeam(gb, coordinate_system="healpix")
            )

    def test_four_pol_power_beam_y_first_raises(self):
        """A 4-pol power beam (polarization_array xx,yy,xy,yx) with y-first
        feeds cannot be feed-reordered by axis reversal; the adapter must
        refuse rather than map 'x' onto a cross-pol product."""
        gb = _native_beam().as_power_beam()  # (1, 2, ...) xx/yy powers
        data4 = np.concatenate(
            [gb.data_array, 0.1 * gb.data_array], axis=1
        )  # (1, 4, ...) standing in for xx,yy,xy,yx
        pb4 = GriddedBeam(
            data4, gb.axis1_array, gb.axis2_array, gb.freq_array, "power"
        )
        fake = FakeUVBeam.__new__(FakeUVBeam)
        fake.pixel_coordinate_system = "az_za"
        fake.beam_type = "power"
        fake.data_array = pb4.data_array
        fake.axis1_array = pb4.axis1_array
        fake.axis2_array = pb4.axis2_array
        fake.freq_array = pb4.freq_array
        fake.feed_array = np.asarray(["n", "e"])
        fake.x_orientation = "east"
        fake.polarization_array = np.array([-5, -6, -7, -8])
        with pytest.raises(ValueError, match="reorder"):
            GriddedBeam.from_uvbeam(fake)


class TestEndToEnd:
    def test_polarized_sim_matches_native_and_oracle(self):
        """An (n,e)-ordered, x_orientation='north' UVBeam driven through
        the public API equals the natively-built beam exactly and matches
        the fp64 oracle."""
        gb = _native_beam()
        fake = FakeUVBeam(gb, feed_order=("n", "e"), x_orientation="north")
        kw = _sim_kwargs(polarized=True)
        v_fake = simulate_vis(beam=fake, **kw)
        v_native = simulate_vis(beam=gb, **kw)
        np.testing.assert_array_equal(v_fake, v_native)
        v_oracle = simulate_vis(beam=gb, backend="direct", **kw)
        scale = np.abs(v_oracle).max()
        np.testing.assert_allclose(v_fake, v_oracle, atol=1e-5 * scale, rtol=0)

    def test_unpolarized_power_sim_matches_oracle(self):
        gb = _native_beam()
        fake = FakeUVBeam(gb)
        kw = _sim_kwargs(polarized=False)
        v_fake = simulate_vis(beam=fake, **kw)
        v_oracle = simulate_vis(beam=gb, backend="direct", **kw)
        scale = np.abs(v_oracle).max()
        np.testing.assert_allclose(v_fake, v_oracle, atol=1e-5 * scale, rtol=0)
