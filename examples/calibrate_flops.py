"""Calibrate flops.py's analytic model against XLA's traced op counts.

The MFU numerator for the matmul-dominated rows is an exact MAC count,
but the elementwise per-source constants (rotation 40, beam eval 22,
coherency 80) are engineering estimates -- and on the elementwise-bound
rows the MFU claim is only as good as those constants. This script compares, for each headline program, the analytic
model's total against the compiled executable's own cost analysis
(``Compiled.cost_analysis()``: HLO-level flops + transcendentals), which
is the closest thing to a traced op count the runtime exposes.

Interpretation:

- XLA counts a ``while``-loop BODY once, ignoring the trip count, so the
  engine's per-time scan must be normalized out: compare the model's
  per-time-step flops (total / ntimes) against the XLA number.
- XLA counts a complex dot_general at 6 real flops per complex MAC
  (3-mult form); the model uses the textbook 8. Matmul-dominated rows
  therefore read model/XLA ~ 1.3 by convention alone.
- 'transcendentals' count sin/cos/exp/rsqrt as ONE each; the model
  costs them ~8-10 flops.

The ratios have not been measured on the GPU. Run on the GPU (the lowering
differs from the CPU's):  python examples/calibrate_flops.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def rows():
    from fftvis_tpu import TelescopeLocation
    from fftvis_tpu.beams import AiryBeam, GaussianBeam
    from fftvis_tpu.beams.interface import (
        BeamInterface,
        prepare_beam_unpolarized,
    )
    from fftvis_tpu.geometry import hex_array
    from fftvis_tpu.utils.healpix import healpix_radec

    loc = TelescopeLocation(np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
    ra, dec = healpix_radec(64)
    nsrc = ra.size
    rng = np.random.default_rng(0)

    # Tutorial row (the 8.5%-MFU program the calibration is really for).
    ants_t = hex_array(3, sep=14.6)
    freqs_t = np.linspace(1.0e8, 1.2e8, 20)
    times_t = 2459863.2 + np.linspace(0, 30 / 60 / 24, 30)
    flux_t = rng.lognormal(0, 0.5, nsrc)[:, None] * (freqs_t / 1e8) ** -2.7
    bt = prepare_beam_unpolarized(BeamInterface(AiryBeam(diameter=14.0)))
    yield "tutorial", dict(
        ants=ants_t, fluxes=flux_t, ra=ra, dec=dec, freqs=freqs_t,
        times=times_t, beam_list=[bt], telescope_loc=loc,
        polarized=False, precision=2,
    ), times_t.size

    # Eigenbeam row (19% MFU).
    from fftvis_tpu import compute_beam_basis

    ants_e = hex_array(4, sep=14.6)
    ant_beams = [
        GaussianBeam(diameter=13.0 + 0.05 * i) for i in range(len(ants_e))
    ]
    eig, coefs = compute_beam_basis(
        ant_beams, 1.0e8, polarized=True, threshold=1e-8,
        n_axis1=181, n_axis2=91,
    )
    times_e = 2459863.2 + np.linspace(0, 4 / 60 / 24, 4)
    flux_e = rng.uniform(0.1, 1.0, (nsrc, 1))
    yield "eigen", dict(
        ants=ants_e, fluxes=flux_e, ra=ra, dec=dec,
        freqs=np.array([1.0e8]), times=times_e,
        beam_list=[BeamInterface(b) for b in eig],
        beam_coefs=coefs[:, :, None], telescope_loc=loc,
        polarized=True, precision=2,
    ), times_e.size

    # North-star row (matmul-dominated control: the model should be
    # nearly exact here).
    from fftvis_tpu.beams.io import read_beamfits
    from fftvis_tpu.beams.synth import perturbed_variants

    ants_h = hex_array(11, sep=14.6)
    asset = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "tests", "data", "structured_dipole_100MHz.beamfits",
    )
    beams_h = perturbed_variants(read_beamfits(asset), 37)
    times_h = 2459863.2 + np.linspace(0, 4 / 60 / 24, 2)
    yield "north_star", dict(
        ants=ants_h, fluxes=rng.uniform(0.1, 1.0, (nsrc, 1)), ra=ra,
        dec=dec, freqs=np.array([1.0e8]), times=times_h,
        beam_list=[BeamInterface(b) for b in beams_h],
        beam_idx=np.arange(len(ants_h)) % 37, telescope_loc=loc,
        polarized=True, precision=2,
    ), times_h.size


def main():
    import jax

    from fftvis_tpu.flops import program_model_flops
    from fftvis_tpu.tpu.engine import TPUSimulationEngine

    for name, kw, ntimes in rows():
        run, inputs, info = TPUSimulationEngine().simulate(
            return_program="full", **kw
        )
        model = program_model_flops(info["program_config"], ntimes=ntimes)
        try:
            cost = jax.jit(run).lower(*inputs).compile().cost_analysis()
            if isinstance(cost, list):  # older jax: one dict per computation
                cost = cost[0]
        except Exception as e:  # pragma: no cover
            print(f"[{name}] cost_analysis unavailable: {e}")
            continue
        xla_fl = float(cost.get("flops", float("nan")))
        xla_tr = float(cost.get("transcendentals", 0.0))
        tot = model["total"]
        per_step = tot / ntimes  # XLA counts the while body once
        print(
            f"[{name}] model {tot / 1e9:.2f} GFLOP ({per_step / 1e9:.2f} "
            f"G/time-step) | XLA body count {xla_fl / 1e9:.2f} G flops + "
            f"{xla_tr / 1e9:.2f} G transcendentals | model_per_step/xla = "
            f"{per_step / max(xla_fl, 1e-9):.2f} (1.33 expected on "
            f"complex-matmul rows from the 8-vs-6 flops/MAC convention)"
        )
        for k, v in sorted(model.items()):
            if k != "total":
                print(f"    model term {k:18s} {v / 1e9:10.3f} G")
        sys.stdout.flush()


if __name__ == "__main__":
    main()
