"""Profile a headline workload's jitted program and print the op-time table.

Usage: python examples/trace_report.py {gridded|tutorial|type3|eigen} [top_n]

Captures a jax.profiler trace of one steady-state execution (until
``block_until_ready``) and aggregates device op durations by instruction
name -- the practical way to find which fusion dominates a program without
TensorBoard.
"""

import collections
import glob
import gzip
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def build(which: str):
    import jax
    import jax.numpy as jnp

    from fftvis_tpu import TelescopeLocation, compute_beam_basis
    from fftvis_tpu.beams import AiryBeam, GaussianBeam
    from fftvis_tpu.beams.interface import (
        BeamInterface,
        prepare_beam_unpolarized,
    )
    from fftvis_tpu.geometry import hex_array
    from fftvis_tpu.tpu.engine import TPUSimulationEngine
    from fftvis_tpu.utils.healpix import healpix_radec

    loc = TelescopeLocation(np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
    ra, dec = healpix_radec(64)
    nsrc = ra.size
    rng = np.random.default_rng(0)
    freqs2 = np.array([1.0e8, 1.1e8])
    times3 = 2459863.2 + np.linspace(0, 0.01, 3)
    flux2 = rng.uniform(0.1, 1.0, (nsrc, 2))

    if which == "gridded":
        ants = hex_array(11, sep=14.6, outriggers=2)
        keys = list(ants.keys())
        bls = [
            (keys[i], keys[j])
            for i in range(len(keys))
            for j in range(i, len(keys))
        ]
        beam = prepare_beam_unpolarized(BeamInterface(GaussianBeam(diameter=14.0)))
        return TPUSimulationEngine().simulate(
            ants=ants, fluxes=flux2, ra=ra, dec=dec, freqs=freqs2,
            times=times3, beam_list=[beam], telescope_loc=loc, baselines=bls,
            polarized=False, precision=2, return_program=True,
        )
    if which == "tutorial":
        ants = hex_array(3, sep=14.6)
        freqs = np.linspace(1.0e8, 1.2e8, 20)
        times = 2459863.2 + np.linspace(0, 30 / 60 / 24, 30)
        flux = rng.lognormal(0, 0.5, nsrc)[:, None] * (freqs / 1e8) ** -2.7
        beam = prepare_beam_unpolarized(BeamInterface(AiryBeam(diameter=14.0)))
        return TPUSimulationEngine().simulate(
            ants=ants, fluxes=flux, ra=ra, dec=dec, freqs=freqs, times=times,
            beam_list=[beam], telescope_loc=loc, polarized=False, precision=2,
            return_program=True,
        )
    if which == "type3":
        ants = hex_array(8, sep=14.6)
        keys = list(ants.keys())
        bls = [
            (keys[i], keys[j])
            for i in range(len(keys))
            for j in range(i, len(keys))
        ]
        beam = prepare_beam_unpolarized(BeamInterface(GaussianBeam(diameter=14.0)))
        return TPUSimulationEngine(nufft_mode="type3").simulate(
            ants=ants, fluxes=flux2, ra=ra, dec=dec, freqs=freqs2,
            times=times3, beam_list=[beam], telescope_loc=loc, baselines=bls,
            polarized=False, precision=2, force_use_type3=True,
            return_program=True,
        )
    if which == "northstar":
        # bench.py row 5: HERA-331 polarized, 37 distinct STRUCTURED
        # per-antenna beams (the committed beamfits asset + perturbed
        # variants -- the scored north star; auto-rank engages at K=7).
        from fftvis_tpu.beams.io import read_beamfits
        from fftvis_tpu.beams.synth import perturbed_variants

        ants = hex_array(11, sep=14.6)
        asset = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "tests", "data", "structured_dipole_100MHz.beamfits",
        )
        beams = perturbed_variants(read_beamfits(asset), 37)
        beam_idx = np.arange(len(ants)) % 37
        times = 2459863.2 + np.linspace(0, 4 / 60 / 24, 2)
        return TPUSimulationEngine().simulate(
            ants=ants, fluxes=rng.uniform(0.1, 1.0, (nsrc, 1)), ra=ra,
            dec=dec, freqs=np.array([1.0e8]), times=times,
            beam_list=beams, beam_idx=beam_idx, telescope_loc=loc,
            polarized=True, precision=2, return_program=True,
        )
    if which == "longobs":
        # bench.py row 6: 24h observation, nside=128 sky (196k sources),
        # hex-8 gridded array -> banded + blocked type-1 path.
        ra128, dec128 = healpix_radec(128)
        ants = hex_array(8, sep=14.6)
        keys = list(ants.keys())
        bls = [
            (keys[i], keys[j])
            for i in range(len(keys))
            for j in range(i, len(keys))
        ]
        times24 = 2459863.2 + np.linspace(0, 1.0, 24)
        flux24 = rng.uniform(0.1, 1.0, (ra128.size, 2))
        beam = prepare_beam_unpolarized(BeamInterface(GaussianBeam(diameter=14.0)))
        return TPUSimulationEngine().simulate(
            ants=ants, fluxes=flux24, ra=ra128, dec=dec128, freqs=freqs2,
            times=times24, beam_list=[beam], telescope_loc=loc,
            baselines=bls, polarized=False, precision=2,
            return_program=True,
        )
    if which == "longobs3":
        # The 24h nside-128 workload forced down the type-3 path: the
        # per-time compaction + banded NUFFT program.
        ra128, dec128 = healpix_radec(128)
        ants = hex_array(8, sep=14.6)
        keys = list(ants.keys())
        bls = [
            (keys[i], keys[j])
            for i in range(len(keys))
            for j in range(i, len(keys))
        ]
        times24 = 2459863.2 + np.linspace(0, 1.0, 24)
        flux24 = rng.uniform(0.1, 1.0, (ra128.size, 2))
        beam = prepare_beam_unpolarized(BeamInterface(GaussianBeam(diameter=14.0)))
        return TPUSimulationEngine(nufft_mode="type3").simulate(
            ants=ants, fluxes=flux24, ra=ra128, dec=dec128, freqs=freqs2,
            times=times24, beam_list=[beam], telescope_loc=loc,
            baselines=bls, polarized=False, precision=2,
            force_use_type3=True, return_program=True,
        )
    if which == "sustained":
        # bench.py row 5b: the north-star array + structured beams at
        # production extents (8f x 8t, one call).
        from fftvis_tpu.beams.io import read_beamfits
        from fftvis_tpu.beams.synth import perturbed_variants

        ants = hex_array(11, sep=14.6)
        asset = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "tests", "data", "structured_dipole_100MHz.beamfits",
        )
        beams = perturbed_variants(read_beamfits(asset), 37)
        beam_idx = np.arange(len(ants)) % 37
        freqs_sus = np.linspace(1.0e8, 1.1e8, 8)
        times_sus = 2459863.2 + np.linspace(0, 8 / 60 / 24, 8)
        flux_sus = rng.uniform(0.1, 1.0, (nsrc, 8))
        return TPUSimulationEngine().simulate(
            ants=ants, fluxes=flux_sus, ra=ra, dec=dec, freqs=freqs_sus,
            times=times_sus, beam_list=beams, beam_idx=beam_idx,
            telescope_loc=loc, polarized=True, precision=2,
            return_program=True,
        )
    if which == "eigen":
        ants = hex_array(4, sep=14.6)
        ant_beams = [
            GaussianBeam(diameter=13.0 + 0.05 * i) for i in range(len(ants))
        ]
        eig, coefs = compute_beam_basis(
            ant_beams, 1.0e8, polarized=True, threshold=1e-8,
            n_axis1=181, n_axis2=91,
        )
        times = 2459863.2 + np.linspace(0, 4 / 60 / 24, 4)
        return TPUSimulationEngine().simulate(
            ants=ants, fluxes=rng.uniform(0.1, 1.0, (nsrc, 1)), ra=ra,
            dec=dec, freqs=np.array([1.0e8]), times=times,
            beam_list=[BeamInterface(b) for b in eig],
            beam_coefs=coefs[:, :, None], telescope_loc=loc, polarized=True,
            precision=2, return_program=True,
        )
    raise SystemExit(f"unknown workload {which!r}")


def main():
    import jax

    which = sys.argv[1] if len(sys.argv) > 1 else "gridded"
    top_n = int(sys.argv[2]) if len(sys.argv) > 2 else 25
    run, inputs = build(which)
    jax.block_until_ready(run(*inputs))  # compile + warm

    logdir = tempfile.mkdtemp(prefix=f"fftvis_trace_{which}_")
    jax.profiler.start_trace(logdir)
    jax.block_until_ready(run(*inputs))
    jax.profiler.stop_trace()

    (path,) = glob.glob(f"{logdir}/plugins/profile/*/*.trace.json.gz")
    with gzip.open(path) as f:
        tr = json.load(f)
    agg: collections.Counter = collections.Counter()
    cnt: collections.Counter = collections.Counter()
    meta: dict = {}
    for e in tr.get("traceEvents", []):
        if e.get("ph") == "X":
            agg[e["name"]] += e.get("dur", 0)
            cnt[e["name"]] += 1
            # XLA op events carry source attribution (the jax name_stack /
            # named_scope path) in args; keep one sample per op name so
            # fusions are attributable to pipeline stages.
            args = e.get("args") or {}
            tag = args.get("tf_op") or args.get("long_name")
            if tag and e["name"] not in meta:
                meta[e["name"]] = str(tag)
    print(f"== {which}: top {top_n} ops by total device time ==")
    for name, dur in agg.most_common(top_n):
        extra = meta.get(name, "")
        if extra:
            extra = f"  [{extra[:90]}]"
        print(f"{dur / 1e3:9.2f} ms  x{cnt[name]:5d}  {name[:80]}{extra}")
    print(f"trace dir: {logdir}")


if __name__ == "__main__":
    main()
