"""Run fftvis-tpu's main path on an NVIDIA GPU and check what comes out.

    python chip_smoke.py                # one card: phases 1-6 below
    python chip_smoke.py --four-cards   # four cards: the sharded phase only
    python chip_smoke.py --rehearse     # CPU, toy sizes (JAX_PLATFORMS=cpu)

Phases (one card):

1. device: JAX's platform, device kind and count, the card's name and power
   limit from nvidia-smi (read before JAX starts), JAX's version and the
   compile-cache directory;
2. tutorial: hex_array(3), 20 freqs x 30 times, nside-64 sky (49,152
   sources), unpolarized Airy beam, whatever path the planner picks;
3. forced type-3: hex_array(8) with all baselines, 2 freqs x 3 times,
   nside 64, unpolarized and then polarized (4 feed channels);
4. gridded HERA: hex_array(11, outriggers=2) with all 63,190 baselines,
   2 freqs x 3 times, nside 64 (the exact type-1 path);
5. north star: hex_array(11) = 331 antennas, polarized, 37 per-antenna
   beams perturbed from the committed structured beamfits, 1 freq x 2
   times, nside 64 (auto-rank engages);
6. the ``gpu``-marked tests, run in this process with ``pytest.main``.

Each of phases 2-5 prints its compile time, the first call's wall, the
warm wall (host clock; ``simulate_vis`` returns host arrays), the program's
``memory_analysis()``, the process's peak device memory, and the maximum
error, relative to max|V|, against the fp64 direct oracle
(reference/direct_engine.py): the engine runs a 4,096-source subset of the
sky with every baseline at the first (freq, time), and the oracle computes
a subset of those baselines. The gate is 1e-5 (BASELINE.json).

With ``--four-cards`` the script runs only phase 3's unpolarized
deployment on ``make_mesh(time=2, source=2)`` over four cards, checks that
every card holds a shard of the inputs and of the output, and compares
with the single-card result at 1e-5 of max|V|.

Exit status 0 only when every phase passed; the last line of standard
output is then one JSON object naming the device. With no GPU (and no
``--rehearse``) the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
GATE = 1e-5
N_ACC_SOURCES = 4096
N_ACC_BASELINES = 256


def nvidia_smi() -> str | None:
    """The card's name and power limit, or None without nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()


def sizes(rehearse: bool) -> dict:
    """Deployment sizes: the real ones, or toy ones for the CPU rehearsal."""
    if rehearse:
        return dict(nside=4, tut_freqs=3, tut_times=2, hex3=3, hexg=3,
                    hexh=3, nbeams=4, acc_sources=64, repeats=1)
    return dict(nside=64, tut_freqs=20, tut_times=30, hex3=8, hexg=11,
                hexh=11, nbeams=37, acc_sources=N_ACC_SOURCES, repeats=3)


def all_baselines(ants):
    keys = list(ants.keys())
    return [(keys[i], keys[j]) for i in range(len(keys))
            for j in range(i, len(keys))]


def deployments(sz: dict, only_type3: bool = False):
    """(name, simulate_vis kwargs, nufft_mode) of phases 2-5."""
    from fftvis_tpu import TelescopeLocation
    from fftvis_tpu.beams import AiryBeam, GaussianBeam
    from fftvis_tpu.beams.io import read_beamfits
    from fftvis_tpu.beams.synth import perturbed_variants
    from fftvis_tpu.geometry import hex_array
    from fftvis_tpu.utils.healpix import healpix_radec

    loc = TelescopeLocation(np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
    ra, dec = healpix_radec(sz["nside"])
    nsrc = ra.size
    rng = np.random.default_rng(0)
    freqs2 = np.array([1.0e8, 1.1e8])
    times3 = 2459863.2 + np.linspace(0, 0.01, 3)
    flux2 = rng.uniform(0.1, 1.0, (nsrc, 2))
    sky = dict(ra=ra, dec=dec, telescope_loc=loc, precision=2, backend="gpu")

    ants3 = hex_array(sz["hex3"], sep=14.6)
    type3 = dict(
        ants=ants3, fluxes=flux2, freqs=freqs2, times=times3,
        beam=GaussianBeam(diameter=14.0), baselines=all_baselines(ants3),
        force_use_type3=True, **sky,
    )
    out = [
        ("type3_unpolarized", dict(type3, polarized=False), "type3"),
        ("type3_polarized", dict(type3, polarized=True), "type3"),
    ]
    if only_type3:
        return out[:1]

    freqs_t = np.linspace(1.0e8, 1.2e8, sz["tut_freqs"])
    times_t = 2459863.2 + np.linspace(0, 30 / 60 / 24, sz["tut_times"])
    tutorial = dict(
        ants=hex_array(3, sep=14.6), freqs=freqs_t, times=times_t,
        fluxes=rng.lognormal(0, 0.5, nsrc)[:, None] * (freqs_t / 1e8) ** -2.7,
        beam=AiryBeam(diameter=14.0), polarized=False, **sky,
    )
    antsg = hex_array(sz["hexg"], sep=14.6, outriggers=2)
    gridded = dict(
        ants=antsg, fluxes=flux2, freqs=freqs2, times=times3,
        beam=GaussianBeam(diameter=14.0), baselines=all_baselines(antsg),
        polarized=False, **sky,
    )
    antsh = hex_array(sz["hexh"], sep=14.6)
    nbeams = min(sz["nbeams"], len(antsh))
    base_beam = read_beamfits(
        os.path.join(REPO, "tests", "data", "structured_dipole_100MHz.beamfits")
    )
    north = dict(
        ants=antsh, fluxes=rng.uniform(0.1, 1.0, (nsrc, 1)),
        freqs=np.array([1.0e8]),
        times=2459863.2 + np.linspace(0, 4 / 60 / 24, 2),
        beam=perturbed_variants(base_beam, nbeams),
        beam_idx=np.arange(len(antsh)) % nbeams, polarized=True, **sky,
    )
    return [("tutorial", tutorial, "auto")] + out + [
        ("gridded_hera", gridded, "auto"),
        ("north_star", north, "auto"),
    ]


def engine_call(kw: dict, nufft_mode: str, **extra):
    """The engine behind simulate_vis, with the wrapper's beam preparation."""
    from fftvis_tpu.tpu.engine import TPUSimulationEngine
    from fftvis_tpu.wrapper import prepare_beam_list

    kw = {k: v for k, v in kw.items() if k != "backend"}
    beam_list, beam_idx = prepare_beam_list(
        kw.pop("beam"), kw["freqs"], kw["polarized"], kw.get("beam_coefs"),
        "x", len(kw["ants"]), kw.pop("beam_idx", None),
    )
    mesh = extra.pop("mesh", None)
    eng = TPUSimulationEngine(nufft_mode=nufft_mode, mesh=mesh)
    return eng.simulate(beam_list=beam_list, beam_idx=beam_idx, **kw, **extra)


def compile_program(kw: dict, nufft_mode: str):
    """AOT-compile the phase's program; (compiled, inputs, info, seconds)."""
    import jax

    run, inputs, info = engine_call(kw, nufft_mode, return_program="full")
    t0 = time.perf_counter()
    with jax.default_matmul_precision(info["program_config"].matmul_precision):
        compiled = run.__wrapped__.lower(*inputs).compile()
    return compiled, inputs, info, time.perf_counter() - t0


def accuracy(kw: dict, nufft_mode: str, mode: str, n_src: int) -> float:
    """Max |engine - oracle| / max|oracle| on a source/baseline subset."""
    from fftvis_tpu.core.utils import get_pos_reds
    from fftvis_tpu.reference.direct_engine import DirectSimulationEngine
    from fftvis_tpu.wrapper import prepare_beam_list

    rng = np.random.default_rng(17)
    nsrc = kw["ra"].size
    sel = np.sort(rng.choice(nsrc, size=min(n_src, nsrc), replace=False))
    sub = dict(
        kw, ra=kw["ra"][sel], dec=kw["dec"][sel], fluxes=kw["fluxes"][sel][:, :1],
        freqs=kw["freqs"][:1], times=kw["times"][:1],
    )
    if sub.get("baselines") is None:
        reds = get_pos_reds(sub["ants"], include_autos=True)
        sub["baselines"] = [red[0] for red in reds]
    _, _, info = engine_call(sub, nufft_mode, return_program="full")
    got_mode = info["program_config"].plan.mode
    if got_mode != mode:
        raise AssertionError(
            f"accuracy subset took the {got_mode} path, the phase {mode}"
        )
    got = engine_call(sub, nufft_mode)
    bls = sub["baselines"]
    pick = np.unique(np.linspace(0, len(bls) - 1, N_ACC_BASELINES).astype(int))
    beam_list, beam_idx = prepare_beam_list(
        sub["beam"], sub["freqs"], sub["polarized"], None, "x",
        len(sub["ants"]), sub.get("beam_idx"),
    )
    oracle_kw = {k: v for k, v in sub.items()
                 if k not in ("beam", "beam_idx", "backend", "baselines",
                              "force_use_type3")}
    want = DirectSimulationEngine().simulate(
        beam_list=beam_list, beam_idx=beam_idx,
        baselines=[bls[i] for i in pick], **oracle_kw,
    )
    got = got[..., pick]
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def peak_bytes() -> int | None:
    import jax

    return (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")


def run_phase(name: str, kw: dict, nufft_mode: str, sz: dict) -> None:
    from fftvis_tpu import simulate_vis

    compiled, _, info, t_compile = compile_program(kw, nufft_mode)
    mode = info["program_config"].plan.mode
    t0 = time.perf_counter()
    vis = simulate_vis(**kw)
    t_first = time.perf_counter() - t0
    if not np.all(np.isfinite(vis)):
        raise AssertionError(f"{name}: non-finite visibilities")
    walls = []
    for _ in range(sz["repeats"]):
        t0 = time.perf_counter()
        simulate_vis(**kw)
        walls.append(time.perf_counter() - t0)
    err = accuracy(kw, nufft_mode, mode, sz["acc_sources"])
    print(
        f"[{name}] path={mode} shape={vis.shape} compile_s={t_compile:.3f} "
        f"first_call_s={t_first:.3f} warm_wall_s={min(walls):.6f} "
        f"(median {float(np.median(walls)):.6f} of {len(walls)}) "
        f"peak_bytes_in_use={peak_bytes()} max_rel_err={err:.3e} "
        f"gate={GATE:g}"
    )
    print(f"[{name}] memory_analysis: {compiled.memory_analysis()}")
    if not err <= GATE:
        raise AssertionError(f"{name}: error {err:.3e} above {GATE:g}")


def four_cards(sz: dict) -> None:
    """Phase 3's unpolarized deployment sharded over four cards."""
    import jax

    from fftvis_tpu import simulate_vis
    from fftvis_tpu.parallel.mesh import make_mesh

    devices = jax.devices()
    if len(devices) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, found {len(devices)}")
    mesh = make_mesh(time=2, source=2, devices=devices[:4])
    ((name, kw, nufft_mode),) = deployments(sz, only_type3=True)

    # Every card holds a shard of each input and of the output.
    run, inputs, info = engine_call(kw, nufft_mode, return_program="full",
                                    mesh=mesh)
    with jax.default_matmul_precision(info["program_config"].matmul_precision):
        compiled = run.__wrapped__.lower(*inputs).compile()
    # An input the compiled program does not read has no sharding.
    placed = [jax.device_put(x, s)
              for x, s in zip(inputs, compiled.input_shardings[0])]
    out = compiled(*placed)
    out.block_until_ready()
    want_devs = set(devices[:4])
    checked = [(f"input {i}", x) for i, (x, s) in
               enumerate(zip(placed, compiled.input_shardings[0]))
               if s is not None] + [("output", out)]
    for label, x in checked:
        held = {sh.device for sh in x.addressable_shards if sh.data.size}
        if held != want_devs:
            raise AssertionError(f"{label} is on {len(held)} of 4 cards")
    print(f"[four_cards] {len(checked) - 1} program inputs and the output "
          f"hold shards on all 4 cards (output spec {out.sharding.spec})")

    single = simulate_vis(**kw)
    t0 = time.perf_counter()
    single = simulate_vis(**kw)
    t_single = time.perf_counter() - t0
    sharded = simulate_vis(mesh=mesh, **kw)
    t0 = time.perf_counter()
    sharded = simulate_vis(mesh=mesh, **kw)
    t_sharded = time.perf_counter() - t0
    err = float(np.abs(sharded - single).max() / np.abs(single).max())
    print(f"[four_cards] {name} on make_mesh(time=2, source=2): "
          f"sharded vs single-card max_rel_err={err:.3e} gate={GATE:g} "
          f"single_warm_wall_s={t_single:.6f} sharded_warm_wall_s={t_sharded:.6f}")
    if not err <= GATE:
        raise AssertionError(f"four_cards: error {err:.3e} above {GATE:g}")


def gpu_tests() -> None:
    import pytest

    rc = pytest.main([
        os.path.join(REPO, "tests"), "-q", "-m", "gpu", "-p", "no:cacheprovider",
        "-p", "no:randomly", "-p", "no:xdist",
    ])
    print(f"[gpu_tests] pytest -m gpu exit code {int(rc)}")
    if rc != 0:
        raise AssertionError(f"gpu-marked tests failed (exit code {int(rc)})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded phase, on four cards")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at toy sizes; never reports a GPU")
    args = ap.parse_args(argv)

    # Phase 1: the card, read by a subprocess before JAX starts.
    smi = nvidia_smi()
    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.four_cards:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + " --xla_force_host_platform_device_count=4"
            ).strip()
    elif smi is None:
        print("nvidia-smi found no card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import jax

    import fftvis_tpu

    devices = jax.devices()
    platform = devices[0].platform
    want = "cpu" if args.rehearse else "gpu"
    if platform != want:
        print(f"JAX found platform {platform!r}, need {want!r}", file=sys.stderr)
        return 1
    count = 4 if args.four_cards else 1
    if len(devices) < count:
        print(f"need {count} devices, JAX found {len(devices)}", file=sys.stderr)
        return 1
    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR") or (
        jax.config.jax_compilation_cache_dir
    )
    print(f"[device] platform={platform} kind={devices[0].device_kind} "
          f"count={len(devices)} jax={jax.__version__} "
          f"compile_cache={cache} package={fftvis_tpu.__file__}")
    print(f"[device] nvidia-smi name, power.limit: {smi}")
    if smi is not None:
        print(smi)

    sz = sizes(args.rehearse)
    failed = []

    def attempt(name, fn, *a):
        try:
            fn(*a)
        except Exception:
            traceback.print_exc()
            print(f"[{name}] FAILED", flush=True)
            failed.append(name)

    if args.four_cards:
        attempt("four_cards", four_cards, sz)
    else:
        for name, kw, nufft_mode in deployments(sz):
            attempt(name, run_phase, name, kw, nufft_mode, sz)
        attempt("gpu_tests", gpu_tests)

    if failed:
        print(f"failed phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": platform, "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
