"""Command-line interface: ``fftvis-tpu run-profile``.

Parity target: the reference's typer CLI (ref /root/reference/src/fftvis/
cli.py:30-159 -- options nants/nfreq/ntimes/nsource/hera/nside/backend/...),
built on argparse (typer is not a dependency here) and profiling via
cProfile + optional XLA traces instead of line_profiler/flameprof.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fftvis-tpu")
    sub = p.add_subparsers(dest="command", required=True)

    rp = sub.add_parser("run-profile", help="profile a standard simulation")
    rp.add_argument("--analytic-beam", action="store_true", default=True)
    rp.add_argument("--nfreq", type=int, default=1)
    rp.add_argument("--ntimes", type=int, default=5)
    rp.add_argument("--nants", type=int, default=10)
    rp.add_argument("--nsource", type=int, default=1000)
    rp.add_argument("--nside", type=int, default=0,
                    help="use an nside HEALPix sky instead of random sources")
    rp.add_argument("--hera", type=int, default=0,
                    help="use a hera-style hex array with this hex number")
    rp.add_argument("--outriggers", type=int, default=0)
    rp.add_argument(
        "--backend", default="tpu", choices=["tpu", "gpu", "cpu", "direct"]
    )
    rp.add_argument("--precision", type=int, default=2, choices=[1, 2])
    rp.add_argument("--polarized", action="store_true")
    rp.add_argument("--force-use-type3", action="store_true")
    rp.add_argument("--nprocesses", type=int, default=1)
    rp.add_argument("--naz", type=int, default=360)
    rp.add_argument("--nza", type=int, default=180)
    rp.add_argument("--coord-method", default="CoordinateRotationERFA")
    rp.add_argument("--trace-dir", default=None,
                    help="write an XLA profiler trace to this directory")
    rp.add_argument("--cprofile", action="store_true",
                    help="also run under cProfile and print the top functions")
    rp.add_argument("--repeats", type=int, default=2)
    rp.add_argument("--pipeline", type=int, default=0, metavar="N",
                    help="also measure N in-flight async_fetch sims "
                         "(pipelined per-sim wall; 0 = skip)")
    rp.add_argument("--verbose", "-v", action="store_true")
    return p


def get_standard_sim_params(args):
    """Standard simulation inputs (the matvis get_standard_sim_params role,
    ref cli.py:60-79), built from this package's own generators."""
    from .beams import GaussianBeam
    from .coords import TelescopeLocation
    from .geometry import hex_array
    from .utils.healpix import healpix_radec

    rng = np.random.default_rng(0)
    loc = TelescopeLocation(np.deg2rad(-30.72), np.deg2rad(21.43), 1050.0)

    if args.hera > 0:
        ants = hex_array(args.hera, outriggers=args.outriggers)
    else:
        ants = {
            i: np.array([*rng.uniform(-100, 100, 2), 0.0])
            for i in range(args.nants)
        }

    if args.nside > 0:
        ra, dec = healpix_radec(args.nside)
    else:
        ra = rng.uniform(0, 2 * np.pi, args.nsource)
        dec = np.arcsin(rng.uniform(-1, 1, args.nsource))

    freqs = np.linspace(1.0e8, 1.2e8, args.nfreq)
    flux = rng.uniform(0.1, 1.0, (ra.size, args.nfreq))
    times = 2459863.2 + np.linspace(0, 0.1, args.ntimes)
    beam = GaussianBeam(diameter=14.0)
    return dict(
        ants=ants, fluxes=flux, ra=ra, dec=dec, freqs=freqs, times=times,
        beam=beam, telescope_loc=loc,
    )


def run_profile(args) -> int:
    from . import simulate_vis
    from .profiling import xla_trace

    params = get_standard_sim_params(args)
    kw = dict(
        params,
        precision=args.precision,
        polarized=args.polarized,
        force_use_type3=args.force_use_type3,
        nprocesses=args.nprocesses,
        coord_method=args.coord_method,
        backend=args.backend,
    )

    print(
        f"run-profile: {len(params['ants'])} ants, {params['ra'].size} sources, "
        f"{args.nfreq} freqs x {args.ntimes} times, backend={args.backend}",
        file=sys.stderr,
    )

    # Warm-up (trace + compile).
    t0 = time.perf_counter()
    vis = simulate_vis(**kw)
    compile_and_run = time.perf_counter() - t0

    best = np.inf
    with xla_trace(args.trace_dir):
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            simulate_vis(**kw)
            best = min(best, time.perf_counter() - t0)

    if args.cprofile:
        pr = cProfile.Profile()
        pr.enable()
        simulate_vis(**kw)
        pr.disable()
        buf = io.StringIO()
        pstats.Stats(pr, stream=buf).sort_stats("cumulative").print_stats(50)
        print(buf.getvalue(), file=sys.stderr)

    pipe = None
    if args.pipeline > 0:
        # N sims dispatched before any result is collected: each output
        # transfer overlaps the next sim's compute (see README "Sweeps").
        for _ in range(max(args.repeats, 1)):
            t0 = time.perf_counter()
            futs = [
                simulate_vis(async_fetch=True, **kw)
                for _ in range(args.pipeline)
            ]
            for f in futs:
                f.result()
            dt = (time.perf_counter() - t0) / args.pipeline
            pipe = dt if pipe is None else min(pipe, dt)

    nbl = vis.shape[-1]
    points = nbl * args.nfreq * args.ntimes
    payload = {
        "wall_first_s": compile_and_run,
        "wall_steady_s": best,
        "vis_points": points,
        "vis_points_per_s": points / best,
        "output_shape": list(vis.shape),
    }
    if pipe is not None:
        payload["wall_pipelined_s"] = pipe
        payload["vis_points_per_s_pipelined"] = points / pipe
    print(json.dumps(payload))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.verbose:
        import logging

        logging.basicConfig(level=logging.INFO)
    if args.command == "run-profile":
        return run_profile(args)
    raise SystemExit(f"unknown command {args.command}")  # pragma: no cover


if __name__ == "__main__":
    raise SystemExit(main())
