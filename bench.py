"""Benchmark: the reference's two wall-clock headline workloads.

1. TUTORIAL workload (BASELINE.md row "fftvis wall time, tutorial sim"):
   hex array, 20 freqs x 30 times, nside=64 HEALPix sky (49152 sources),
   unpolarized, fp64 API. Reference: 3.32 s wall -> with its 46 default
   baselines that is 46*600/3.32 = 8313 vis-points/s (matvis: 19.5 s).
   This is the PRIMARY metric (vis-points/s normalized per baseline count,
   so array-size differences cancel).

2. GRIDDED workload (BASELINE.md row "Type-1 (gridded array) wall"):
   hex_array(11, outriggers=2)-class lattice, ALL ~63k baselines, 2 freqs x
   3 times, same sky. Reference: 0.482 s -> ~6.4e5 vis-points/s. Reported
   inside the metric string and on stderr.

Each scored row also reports the analytic-model FLOP count
(fftvis_tpu/flops.py: closed-form spread/FFT/interp/coherency terms from
the executed plan), the achieved FLOP/s against the row's device-compute
time, and MFU as a fraction of the device's peak for the traced matmul
precision. Times are host walls: a simulation's ends when its result is on
the host, a program's when ``block_until_ready`` returns. Every printed row
names the platform, device kind and device count.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"rows"} -- "rows" carries each scored row as a compact machine-readable
dict (also emitted per-row as `[bench-row] {...}` stderr lines).
"""

import json
import os
import sys
import time

import numpy as np

TUTORIAL_BASELINE_PTS_PER_S = 8313.0  # 46 bls * 600 (t,f) / 3.32 s
GRIDDED_BASELINE_PTS_PER_S = 6.4e5
# Reference "Type-3 forced, same sim": 6.69 s for the gridded workload
# (fftvis_gridded_array.ipynb cell 19) -> 63190 * 6 / 6.69.
TYPE3_BASELINE_PTS_PER_S = 5.67e4
# Reference eigenbeam path (K=8): 3.47 s for 33 ants x 1f x 4t, polarized,
# one baseline per redundant group (beam_decomposition.ipynb cells 5/19);
# at the comparable ~64 groups of our hex array: 64 * 4 / 3.47.
EIGEN_BASELINE_PTS_PER_S = 73.8
# Reference per-antenna path (33 distinct beams): 51.7 s for the same
# 1f x 4t polarized sim (beam_decomposition.ipynb cell 10) -> 64*4/51.7.
PERANT_BASELINE_PTS_PER_S = 4.95


ROWS: dict = {}
# "<platform> <device_kind> x<count>", set by main() once JAX has started.
DEVICE = "unknown"


def _row(name, **fields):
    """Record one scored row and emit it as a greppable JSON line.

    Every row lands (a) on stderr as ``[bench-row] {...}`` and (b) in the
    final stdout JSON under ``rows`` -- machine-readable round-over-round,
    while the prose lines remain the human-readable record. Floats are
    rounded to 4 significant digits to keep the final line compact (the
    driver truncates long output tails).
    """
    clean = {}
    for k, v in fields.items():
        if v is None:
            continue
        if isinstance(v, (float, np.floating)):
            clean[k] = float(f"{float(v):.4g}")
        elif isinstance(v, (int, np.integer)):
            clean[k] = int(v)
        else:
            clean[k] = v
    ROWS[name] = clean
    print("[bench-row] " + json.dumps({"row": name, "device": DEVICE, **clean}),
          file=sys.stderr)


def _mfu_val(fl, seconds):
    """MFU as a percentage float (or None) -- delegates to the single
    formula in fftvis_tpu.flops so rows and prose cannot drift."""
    from fftvis_tpu.flops import mfu_value

    if fl is None or seconds is None:
        return None
    return mfu_value(fl[0], seconds, fl[1])


def _steady(fn, repeats):
    """Median host wall of ``fn()`` after one warm-up call (trace +
    compile). ``simulate_vis`` returns host arrays, so each call's wall
    ends when its result is on the host."""
    fn()
    walls = []
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def _pipelined_wall(call_async, repeats, depth=8, width=2):
    """Median per-call wall of ``depth`` in-flight async_fetch simulations.

    The production consumption pattern: a dispatcher issues simulations
    while ``width`` collector threads drain their results -- host-side
    dispatch (planning, hashing, input prep) overlaps the device-to-host
    transfers (the blocking fetch releases the GIL).
    """
    from concurrent.futures import ThreadPoolExecutor

    walls = []
    with ThreadPoolExecutor(width) as collector:
        for _ in range(max(1, repeats)):
            t0 = time.perf_counter()
            handles = [collector.submit(call_async().result)
                       for _ in range(depth)]
            for h in handles:
                h.result()
            walls.append((time.perf_counter() - t0) / depth)
    return float(np.median(walls))


def _device_compute_time(run, inputs, repeats):
    """Median host wall of one execution of a jitted program, from
    dispatch to ``block_until_ready`` (no host transfer of the output)."""
    import jax

    jax.block_until_ready(run(*inputs))  # compile
    walls = []
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        jax.block_until_ready(run(*inputs))
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def _model_flops(info, ntimes):
    """(total analytic FLOPs, traced matmul precision) for one simulation."""
    from fftvis_tpu.flops import program_model_flops

    cfg = info.get("program_config")
    if cfg is None:
        return None
    return (
        program_model_flops(cfg, ntimes=ntimes)["total"],
        cfg.matmul_precision,
    )


def _mfu_str(fl, seconds):
    """fl is the (flops, matmul_precision) pair from _model_flops: MFU is
    reported against the peak of the precision the program actually
    traced (FFTVIS_MATMUL_PRECISION=high runs on the TF32 peak)."""
    from fftvis_tpu.flops import mfu_string

    if fl is None or seconds is None:
        return ""
    return " [" + mfu_string(fl[0], seconds, fl[1]) + "]"


def main():
    import jax

    from fftvis_tpu import TelescopeLocation, simulate_vis
    from fftvis_tpu.beams import AiryBeam, GaussianBeam
    from fftvis_tpu.geometry import hex_array
    from fftvis_tpu.utils.healpix import healpix_radec

    hex_size = int(os.environ.get("FFTVIS_BENCH_HEX", "11"))
    nside = int(os.environ.get("FFTVIS_BENCH_NSIDE", "64"))
    repeats = int(os.environ.get("FFTVIS_BENCH_REPEATS", "5"))
    # Sub-default repeat counts (the CPU smoke test runs REPEATS=1) also
    # shrink the pipelining depths and the sustained/large-sky rows.
    full_scale = repeats >= 5
    wall_reps = repeats

    loc = TelescopeLocation(np.deg2rad(-30.72), np.deg2rad(21.43), 1000.0)
    ra, dec = healpix_radec(nside)
    nsrc = ra.size
    rng = np.random.default_rng(0)
    backend_name = jax.default_backend()
    global DEVICE
    dev0 = jax.devices()[0]
    DEVICE = f"{dev0.platform} {dev0.device_kind} x{len(jax.devices())}"

    from fftvis_tpu.beams.interface import (
        BeamInterface,
        prepare_beam_unpolarized,
    )
    from fftvis_tpu.flops import chip_peak_flops
    from fftvis_tpu.reference.direct_engine import DirectSimulationEngine
    from fftvis_tpu.tpu.engine import TPUSimulationEngine

    peak, peak_label = chip_peak_flops()
    print(f"[bench {DEVICE}] chip peak model: {peak_label}", file=sys.stderr)

    # ---------------- 1. tutorial workload (primary) ----------------
    ants_t = hex_array(3, sep=14.6)
    freqs_t = np.linspace(1.0e8, 1.2e8, 20)
    times_t = 2459863.2 + np.linspace(0, 30 / 60 / 24, 30)
    flux_t = rng.lognormal(0, 0.5, nsrc)[:, None] * (freqs_t / 1e8) ** -2.7
    kw_t = dict(
        ants=ants_t, fluxes=flux_t, ra=ra, dec=dec, freqs=freqs_t,
        times=times_t, beam=AiryBeam(diameter=14.0), telescope_loc=loc,
        polarized=False, precision=2, backend="gpu",
    )
    vt = simulate_vis(**kw_t)
    assert np.all(np.isfinite(vt)), "tutorial benchmark produced non-finite output"
    nbl_t = vt.shape[-1]
    wall_t = _steady(lambda: simulate_vis(**kw_t), wall_reps)
    rate_t = nbl_t * freqs_t.size * times_t.size / wall_t
    ratio_t = rate_t / TUTORIAL_BASELINE_PTS_PER_S
    pipe_t = _pipelined_wall(
        lambda: simulate_vis(async_fetch=True, **kw_t), wall_reps,
        depth=8 if full_scale else 2,
    )
    rate_tp = nbl_t * freqs_t.size * times_t.size / pipe_t
    ratio_tp = rate_tp / TUTORIAL_BASELINE_PTS_PER_S
    # Device-compute time + MFU for the same program.
    ekw_t = {k: v for k, v in kw_t.items() if k not in ("beam", "backend")}
    bt = prepare_beam_unpolarized(BeamInterface(AiryBeam(diameter=14.0)))
    run_t, in_t, info_t = TPUSimulationEngine().simulate(
        beam_list=[bt], return_program="full", **ekw_t
    )
    dev_t = _device_compute_time(run_t, in_t, repeats)
    fl_t = _model_flops(info_t, times_t.size)
    print(
        f"[bench {DEVICE}] tutorial: {nbl_t} bls x 20f x 30t in {wall_t:.3f} s = "
        f"{rate_t:.3e} pts/s ({ratio_t:.1f}x ref fftvis-CPU, "
        f"{19.5 / wall_t:.0f}x matvis wall); pipelined (8 in-flight "
        f"async_fetch, threaded collect) {pipe_t * 1e3:.1f} ms/sim = "
        f"{rate_tp:.3e} pts/s ({ratio_tp:.1f}x); device "
        f"{dev_t * 1e3:.1f} ms{_mfu_str(fl_t, dev_t)}",
        file=sys.stderr,
    )
    _row(
        "tutorial", ratio=ratio_t, wall_ms=wall_t * 1e3,
        pipe_ms=pipe_t * 1e3, pipe_ratio=ratio_tp, dev_ms=dev_t * 1e3,
        mfu_pct=_mfu_val(fl_t, dev_t),
    )

    # ---------------- 2. gridded workload (secondary) ----------------
    ants_g = hex_array(hex_size, sep=14.6, outriggers=2)
    keys = list(ants_g.keys())
    nant = len(keys)
    baselines = [(keys[i], keys[j]) for i in range(nant) for j in range(i, nant)]
    freqs_g = np.array([1.0e8, 1.1e8])
    times_g = 2459863.2 + np.linspace(0, 0.01, 3)
    flux_g = rng.uniform(0.1, 1.0, (nsrc, freqs_g.size))
    kw_g = dict(
        ants=ants_g, fluxes=flux_g, ra=ra, dec=dec, freqs=freqs_g,
        times=times_g, beam=GaussianBeam(diameter=14.0), telescope_loc=loc,
        baselines=baselines, polarized=False, precision=2, backend="gpu",
    )
    vg = simulate_vis(**kw_g)
    assert np.all(np.isfinite(vg)), "gridded benchmark produced non-finite output"
    wall_g = _steady(lambda: simulate_vis(**kw_g), wall_reps)
    npts_g = len(baselines) * freqs_g.size * times_g.size
    rate_g = npts_g / wall_g
    ratio_g = rate_g / GRIDDED_BASELINE_PTS_PER_S
    # Pipelined wall: 12 in-flight async_fetch sims with two collector
    # threads (production consumption).
    depth_g = 12 if full_scale else 2
    pipe_g = _pipelined_wall(
        lambda: simulate_vis(async_fetch=True, **kw_g), wall_reps,
        depth=depth_g,
    )
    rate_gp = npts_g / pipe_g
    ratio_gp = rate_gp / GRIDDED_BASELINE_PTS_PER_S

    # Device-compute rate for the same program (no output transfer).
    eng_kw = dict(kw_g)
    for k in ("backend",):
        eng_kw.pop(k)
    beam_obj = prepare_beam_unpolarized(BeamInterface(eng_kw.pop("beam")))
    run_g, in_g, info_g = TPUSimulationEngine().simulate(
        beam_list=[beam_obj], return_program="full", **eng_kw
    )
    dev_g = _device_compute_time(run_g, in_g, repeats)
    rate_gd = npts_g / dev_g
    ratio_gd = rate_gd / GRIDDED_BASELINE_PTS_PER_S
    fl_g = _model_flops(info_g, times_g.size)
    print(
        f"[bench {DEVICE}] gridded: {len(baselines)} bls x 2f x 3t in {wall_g:.3f} s "
        f"wall = {rate_g:.3e} pts/s ({ratio_g:.1f}x ref fftvis-CPU type-1 "
        f"wall); pipelined ({depth_g} in-flight, threaded collect) "
        f"{pipe_g * 1e3:.1f} ms/sim = {rate_gp:.3e} pts/s ({ratio_gp:.1f}x "
        f"ref); device compute {dev_g * 1e3:.1f} ms = {rate_gd:.3e} pts/s "
        f"({ratio_gd:.1f}x ref){_mfu_str(fl_g, dev_g)}",
        file=sys.stderr,
    )
    _row(
        "gridded", ratio=ratio_g, wall_ms=wall_g * 1e3,
        pipe_ms=pipe_g * 1e3, pipe_ratio=ratio_gp, dev_ms=dev_g * 1e3,
        mfu_pct=_mfu_val(fl_g, dev_g),
    )

    # -------- 2b. gridded BATCHED sweep (one device program) --------
    # The production sweep pattern with the per-call fixed costs removed
    # at the ROOT: NB sweep steps' flux columns stacked on a tiled freq
    # axis run as ONE device program with ONE stacked output -- one
    # dispatch, one D2H, per-call host phases divided by NB (equivalence
    # with separate sims is asserted in tests/test_batched_paths.py).
    # Two batches stay in flight so batch k+1's dispatch/compute
    # overlaps batch k's transfer.
    NB = 8 if full_scale else 2
    freqs_gb = np.tile(freqs_g, NB)
    flux_gb = rng.uniform(0.1, 1.0, (nsrc, freqs_gb.size))
    kw_gb = dict(kw_g)
    kw_gb["freqs"] = freqs_gb
    kw_gb["fluxes"] = flux_gb
    v_gb = simulate_vis(**kw_gb)
    assert np.all(np.isfinite(v_gb)), "batched gridded non-finite"
    batch_wall = _pipelined_wall(
        lambda: simulate_vis(async_fetch=True, **kw_gb),
        max(1, wall_reps // 2), depth=2,
    )
    pipe_b = batch_wall / NB
    rate_gb = npts_g / pipe_b
    ratio_gb = rate_gb / GRIDDED_BASELINE_PTS_PER_S
    print(
        f"[bench {DEVICE}] gridded BATCHED sweep ({NB} sims/call, stacked freq "
        f"axis): {pipe_b * 1e3:.1f} ms/sim = "
        f"{rate_gb:.3e} pts/s ({ratio_gb:.1f}x ref)",
        file=sys.stderr,
    )
    _row("gridded_batched", ratio=ratio_gb, pipe_ms=pipe_b * 1e3, batch=NB)

    # ------------- 3. forced type-3 workload (secondary) -------------
    # The reference forces type-3 on the same gridded sim: 6.69 s
    # (vs 0.482 s type-1). Exercises the ES spread + FFT + tap-gather
    # interpolation path. Smaller hex keeps bench wall sane; pts/s
    # normalizes the comparison.
    ants_3 = hex_array(8, sep=14.6)
    k3 = list(ants_3.keys())
    bl3 = [(k3[i], k3[j]) for i in range(len(k3)) for j in range(i, len(k3))]
    kw_3 = dict(
        ants=ants_3, fluxes=flux_g, ra=ra, dec=dec, freqs=freqs_g,
        times=times_g, beam=GaussianBeam(diameter=14.0), telescope_loc=loc,
        baselines=bl3, polarized=False, precision=2, backend="gpu",
        force_use_type3=True,
    )
    eng3 = TPUSimulationEngine(nufft_mode="type3")
    ekw3 = {k: v for k, v in kw_3.items() if k not in ("beam", "backend")}
    b3 = prepare_beam_unpolarized(BeamInterface(GaussianBeam(diameter=14.0)))
    run3, in3, info3 = eng3.simulate(
        beam_list=[b3], return_program="full", **ekw3
    )
    dev_3 = _device_compute_time(run3, in3, repeats)
    npts_3 = len(bl3) * freqs_g.size * times_g.size
    rate_3 = npts_3 / dev_3
    ratio_3 = rate_3 / TYPE3_BASELINE_PTS_PER_S
    fl_3 = _model_flops(info3, times_g.size)
    print(
        f"[bench {DEVICE}] type-3 forced: {len(bl3)} bls x 2f x 3t device "
        f"{dev_3 * 1e3:.1f} ms = {rate_3:.3e} pts/s ({ratio_3:.0f}x ref "
        f"forced-type-3 wall){_mfu_str(fl_3, dev_3)}",
        file=sys.stderr,
    )
    _row(
        "type3_forced", ratio=ratio_3, dev_ms=dev_3 * 1e3,
        mfu_pct=_mfu_val(fl_3, dev_3),
    )

    # ------- 3b. 3D non-coplanar type-3 (w-term / low-rank-z path) -------
    # The reference's tilted-array workloads exercise nufft3d3 (ref
    # cpu/nufft.py:62-118, cpu_simulate.py:640-659). A plane-fit residual
    # above flat_array_tol cannot be rotated away, so antennas with
    # meter-scale z scatter drive the genuine 3D path (low-rank z-tap
    # executor, nufft/transform.py plan_type3_lowrank_z). Device time,
    # MFU, and an on-hardware accuracy assert vs the fp64 oracle.
    rng_z = np.random.default_rng(23)
    ants_z = {
        k: np.array([p[0], p[1], rng_z.uniform(-2.0, 2.0)])
        for k, p in ants_3.items()
    }
    kw_z = dict(
        ants=ants_z, fluxes=flux_g, ra=ra, dec=dec, freqs=freqs_g,
        times=times_g, beam=GaussianBeam(diameter=14.0),
        telescope_loc=loc, baselines=bl3, polarized=False, precision=2,
        backend="gpu",
    )
    v_z = simulate_vis(**kw_z)
    assert np.all(np.isfinite(v_z)), "non-coplanar 3D benchmark non-finite"
    ekw_z = {k: v for k, v in kw_z.items() if k not in ("beam", "backend")}
    run_z, in_z, info_z = TPUSimulationEngine().simulate(
        beam_list=[b3], return_program="full", **ekw_z
    )
    dev_z = _device_compute_time(run_z, in_z, repeats)
    rate_z = npts_3 / dev_z
    ratio_z = rate_z / TYPE3_BASELINE_PTS_PER_S
    fl_z = _model_flops(info_z, times_g.size)
    # Accuracy: 512-source subproblem on the same 3D array vs fp64 oracle.
    sel_z = np.random.default_rng(29).choice(nsrc, size=512, replace=False)
    kw_za = dict(
        ants=ants_z, fluxes=flux_g[sel_z], ra=ra[sel_z], dec=dec[sel_z],
        freqs=freqs_g, times=times_g[:1], baselines=bl3[:400],
        telescope_loc=loc, polarized=False, precision=2,
    )
    v_za = simulate_vis(beam=GaussianBeam(diameter=14.0), backend="gpu", **kw_za)
    v_zo = DirectSimulationEngine().simulate(beam_list=[b3], **kw_za)
    acc_z = float(np.abs(v_za - v_zo).max() / max(np.abs(v_zo).max(), 1e-30))
    print(
        f"[bench {DEVICE}] 3D non-coplanar type-3 ({len(ants_z)} ants, +-2 m z "
        f"scatter): device {dev_z * 1e3:.1f} ms = {rate_z:.3e} pts/s "
        f"({ratio_z:.0f}x ref forced-type-3 wall){_mfu_str(fl_z, dev_z)}; "
        f"accuracy {acc_z:.2e} vs fp64 oracle (gate 1e-4)",
        file=sys.stderr,
    )
    assert acc_z < 1e-4, f"3D non-coplanar accuracy gate FAILED: {acc_z:.2e}"
    _row(
        "noncoplanar_3d", ratio=ratio_z, dev_ms=dev_z * 1e3,
        mfu_pct=_mfu_val(fl_z, dev_z), acc=acc_z,
    )

    # ------------- 4. eigenbeam workload (secondary) -------------
    # Reference: 33 distinct per-antenna beams, K=8 eigenbeams, polarized,
    # 1 freq x 4 times, nside=64 (3.47 s; beam_decomposition.ipynb).
    from fftvis_tpu import compute_beam_basis
    from fftvis_tpu.beams import GaussianBeam as _GB

    ants_e = hex_array(4, sep=14.6)
    nant_e = len(ants_e)
    ant_beams = [
        _GB(diameter=13.0 + 0.05 * i) for i in range(nant_e)
    ]
    eig, coefs = compute_beam_basis(
        ant_beams, float(freqs_g[0]), polarized=True, threshold=1e-8,
        n_axis1=181, n_axis2=91,
    )
    times_e = 2459863.2 + np.linspace(0, 4 / 60 / 24, 4)
    flux_e = rng.uniform(0.1, 1.0, (nsrc, 1))
    kw_e = dict(
        ants=ants_e, fluxes=flux_e, ra=ra, dec=dec,
        freqs=np.array([freqs_g[0]]), times=times_e,
        beam=eig, beam_coefs=coefs[:, :, None], telescope_loc=loc,
        polarized=True, precision=2, backend="gpu",
    )
    ve = simulate_vis(**kw_e)
    assert np.all(np.isfinite(ve)), "eigenbeam benchmark non-finite"
    wall_e = _steady(lambda: simulate_vis(**kw_e), wall_reps)
    npts_e = ve.shape[-1] * 1 * times_e.size
    rate_e = npts_e / wall_e
    ratio_e = rate_e / EIGEN_BASELINE_PTS_PER_S
    pipe_e = _pipelined_wall(
        lambda: simulate_vis(async_fetch=True, **kw_e), wall_reps,
        depth=8 if full_scale else 2,
    )
    ratio_ep = npts_e / pipe_e / EIGEN_BASELINE_PTS_PER_S
    ekw_e = {k: v for k, v in kw_e.items() if k not in ("beam", "backend")}
    run_e, in_e, info_e = TPUSimulationEngine().simulate(
        beam_list=[BeamInterface(b) for b in eig], return_program="full",
        **ekw_e,
    )
    dev_e = _device_compute_time(run_e, in_e, repeats)
    fl_e = _model_flops(info_e, times_e.size)
    print(
        f"[bench {DEVICE}] eigenbeam (K={len(eig)}): {ve.shape[-1]} bls x 1f x 4t in "
        f"{wall_e:.3f} s wall = {rate_e:.3e} pts/s ({ratio_e:.0f}x ref "
        f"eigenbeam wall); pipelined {pipe_e * 1e3:.1f} ms/sim "
        f"({ratio_ep:.0f}x); device {dev_e * 1e3:.1f} ms"
        f"{_mfu_str(fl_e, dev_e)}",
        file=sys.stderr,
    )
    _row(
        "eigenbeam", ratio=ratio_e, wall_ms=wall_e * 1e3,
        pipe_ms=pipe_e * 1e3, pipe_ratio=ratio_ep, dev_ms=dev_e * 1e3,
        mfu_pct=_mfu_val(fl_e, dev_e),
    )

    # ------- 5. NORTH STAR: HERA-331 polarized per-antenna beams -------
    # BASELINE.md:34-36: ">=10x the finufft-CPU visibility throughput per
    # chip, at <=1e-5 relative error vs the matvis-style direct-DFT
    # reference on HERA-331 polarized simulations". This row scores that
    # configuration directly: 331-antenna HERA-class hex lattice, full
    # redundant-group baseline set, polarized, REALISTIC STRUCTURED
    # tabulated per-antenna beams (the committed CST-class beamfits asset
    # -- Airy sidelobes, deep nulls, complex cross-pol, az ripple, 1 deg
    # gridding -- loaded through the in-repo beamfits reader, with
    # per-antenna perturbed variants; fftvis_tpu/beams/synth.py), the
    # nside=64 sky. Wall + device-compute throughput + MFU, then an
    # ON-HARDWARE accuracy assert at <= 1e-5 vs the in-repo fp64
    # direct-DFT oracle on a 512-source subproblem.
    from fftvis_tpu.beams.io import read_beamfits
    from fftvis_tpu.beams.synth import perturbed_variants

    hera_hex = int(os.environ.get("FFTVIS_BENCH_HERA_HEX", "11"))
    ants_h = hex_array(hera_hex, sep=14.6)  # 11 -> 331 antennas (HERA-331)
    nd_beams = min(int(os.environ.get("FFTVIS_BENCH_NBEAMS", "37")), len(ants_h))
    freq_h = 1.0e8
    asset_path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "tests", "data", "structured_dipole_100MHz.beamfits",
    )
    base_beam = read_beamfits(asset_path)
    hera_beams = perturbed_variants(base_beam, nd_beams)
    beam_idx_h = np.arange(len(ants_h)) % nd_beams
    times_h = 2459863.2 + np.linspace(0, 4 / 60 / 24, 2)
    flux_h = rng.uniform(0.1, 1.0, (nsrc, 1))
    kw_h = dict(
        ants=ants_h, fluxes=flux_h, ra=ra, dec=dec,
        freqs=np.array([freq_h]), times=times_h, beam=hera_beams,
        beam_idx=beam_idx_h, telescope_loc=loc, polarized=True,
        precision=2, backend="gpu",
    )
    vh = simulate_vis(**kw_h)
    assert np.all(np.isfinite(vh)), "hera-331 benchmark non-finite"
    nbl_h = vh.shape[-1]
    wall_h = _steady(lambda: simulate_vis(**kw_h), wall_reps)
    npts_h = nbl_h * 1 * times_h.size
    rate_h = npts_h / wall_h
    ratio_h = rate_h / PERANT_BASELINE_PTS_PER_S
    pipe_h = _pipelined_wall(
        lambda: simulate_vis(async_fetch=True, **kw_h), wall_reps,
        depth=8 if full_scale else 2,
    )
    ratio_hp = npts_h / pipe_h / PERANT_BASELINE_PTS_PER_S
    ekw_h = {k: v for k, v in kw_h.items() if k not in ("beam", "backend")}
    run_h, in_h, info_h = TPUSimulationEngine().simulate(
        beam_list=[BeamInterface(b) for b in hera_beams],
        return_program="full", **ekw_h,
    )
    dev_h = _device_compute_time(run_h, in_h, repeats)
    fl_h = _model_flops(info_h, times_h.size)

    # On-hardware accuracy at the north-star configuration (512-source
    # subproblem, same array/structured beams/routing, vs the fp64 direct
    # oracle).
    np_rng_h = np.random.default_rng(17)
    sel_h = np_rng_h.choice(nsrc, size=min(512, nsrc), replace=False)
    kw_ha = dict(
        ants=ants_h, fluxes=flux_h[sel_h], ra=ra[sel_h], dec=dec[sel_h],
        freqs=np.array([freq_h]), times=times_h[:1], beam_idx=beam_idx_h,
        telescope_loc=loc, polarized=True, precision=2,
    )
    vha = simulate_vis(beam=hera_beams, backend="gpu", **kw_ha)
    vho = DirectSimulationEngine().simulate(
        beam_list=[BeamInterface(b) for b in hera_beams], **kw_ha
    )
    acc_h = float(np.abs(vha - vho).max() / max(np.abs(vho).max(), 1e-30))
    print(
        f"[bench {DEVICE}] NORTH STAR hera-{len(ants_h)} polarized per-antenna "
        f"({nd_beams} structured beamfits-loaded beams): {nbl_h} bls x 1f "
        f"x 2t in {wall_h:.3f} s wall = {rate_h:.3e} pts/s ({ratio_h:.0f}x "
        f"ref per-antenna wall); pipelined {pipe_h * 1e3:.1f} ms/sim "
        f"({ratio_hp:.0f}x); device {dev_h * 1e3:.1f} ms"
        f"{_mfu_str(fl_h, dev_h)}; accuracy {acc_h:.2e} max rel vs fp64 "
        f"direct oracle (gate 1e-5)",
        file=sys.stderr,
    )
    assert acc_h < 1e-5, f"north-star accuracy gate FAILED: {acc_h:.2e}"
    _row(
        "north_star", ratio=ratio_h, wall_ms=wall_h * 1e3,
        pipe_ms=pipe_h * 1e3, pipe_ratio=ratio_hp, dev_ms=dev_h * 1e3,
        mfu_pct=_mfu_val(fl_h, dev_h), acc=acc_h,
    )

    # ------- 5b. NORTH STAR sustained (production-shaped extents) -------
    # The headline rows inherit the reference's tiny (freq x time) extents
    # (1f x 2t), so per-sim fixed costs (planning, dispatch, transfer) weigh
    # heavily in their pts/s. A production sweep runs many (freq, time)
    # channels per call; this row scores the SAME north-star array and
    # structured beams at 8 freqs x 8 times in ONE call -- one dispatch,
    # one D2H -- where fixed costs amortize and the number is sustained
    # throughput, robust to runtime jitter.
    nf_sus, nt_sus = (8, 8) if full_scale else (2, 2)
    freqs_sus = np.linspace(1.0e8, 1.1e8, nf_sus)
    times_sus = 2459863.2 + np.linspace(0, 8 / 60 / 24, nt_sus)
    flux_sus = rng.uniform(0.1, 1.0, (nsrc, nf_sus))
    kw_sus = dict(
        ants=ants_h, fluxes=flux_sus, ra=ra, dec=dec, freqs=freqs_sus,
        times=times_sus, beam=hera_beams, beam_idx=beam_idx_h,
        telescope_loc=loc, polarized=True, precision=2, backend="gpu",
    )
    v_sus = simulate_vis(**kw_sus)
    assert np.all(np.isfinite(v_sus)), "sustained north-star non-finite"
    wall_sus = _steady(lambda: simulate_vis(**kw_sus), max(2, repeats // 2))
    npts_sus = nbl_h * nf_sus * nt_sus
    rate_sus = npts_sus / wall_sus
    ratio_sus = rate_sus / PERANT_BASELINE_PTS_PER_S
    ekw_sus = {k: v for k, v in kw_sus.items() if k not in ("beam", "backend")}
    run_sus, in_sus, info_sus = TPUSimulationEngine().simulate(
        beam_list=[BeamInterface(b) for b in hera_beams],
        return_program="full", **ekw_sus,
    )
    dev_sus = _device_compute_time(run_sus, in_sus, max(2, repeats // 2))
    fl_sus = _model_flops(info_sus, nt_sus)
    print(
        f"[bench {DEVICE}] north-star SUSTAINED ({nf_sus}f x {nt_sus}t, one call): "
        f"{nbl_h} bls, wall {wall_sus:.3f} s = {rate_sus:.3e} pts/s "
        f"({ratio_sus:.0f}x ref per-antenna); device {dev_sus * 1e3:.1f} ms"
        f"{_mfu_str(fl_sus, dev_sus)}",
        file=sys.stderr,
    )
    _row(
        "north_star_sustained", ratio=ratio_sus, wall_ms=wall_sus * 1e3,
        dev_ms=dev_sus * 1e3, mfu_pct=_mfu_val(fl_sus, dev_sus),
    )

    # ------- 6. 24h observation, large sky: block sizing + banding -------
    # Long observations see only ~60-80% of the (already-culled) sky at
    # any one time; the banded scan skips the invisible blocks (beam
    # eval + coherency + spread), and large catalogs additionally gain
    # from the engine's ~4k-source block floor. Equivalence is asserted in
    # tests/test_banding.py; this row measures the realized DEVICE saving
    # on a 196k-source sky.
    nside24 = 128 if full_scale else max(nside // 2, 4)
    ra24, dec24 = healpix_radec(nside24)
    n24 = ra24.size
    times_24h = 2459863.2 + np.linspace(0, 1.0, 24)
    flux_24 = rng.uniform(0.1, 1.0, (n24, 2))
    ekw24 = dict(
        ants=ants_3, fluxes=flux_24, ra=ra24, dec=dec24, freqs=freqs_g,
        times=times_24h, beam_list=[b3], telescope_loc=loc,
        polarized=False, precision=2,
    )
    run24b, in24b = TPUSimulationEngine().simulate(return_program=True, **ekw24)
    dev_24b = _device_compute_time(run24b, in24b, repeats)
    os.environ["FFTVIS_BAND"] = "0"
    os.environ["FFTVIS_BLOCK"] = "0"
    try:
        run24p, in24p = TPUSimulationEngine().simulate(
            return_program=True, **ekw24
        )
        dev_24p = _device_compute_time(run24p, in24p, repeats)
    finally:
        del os.environ["FFTVIS_BAND"]
        del os.environ["FFTVIS_BLOCK"]
    band_gain = dev_24p / dev_24b
    print(
        f"[bench {DEVICE}] 24h observation (nside={nside24} sky, {n24} srcs): device "
        f"{dev_24b * 1e3:.1f} ms banded+blocked vs {dev_24p * 1e3:.1f} ms "
        f"plain = {band_gain:.2f}x from horizon banding + block sizing",
        file=sys.stderr,
    )
    _row(
        "obs24h_banding", dev_ms=dev_24b * 1e3, plain_dev_ms=dev_24p * 1e3,
        gain=band_gain,
    )

    # ------- 7. million-source scale rows (SURVEY section 5) -------
    # "Tens of millions of HEALPix pixels" is the reference's long-context
    # analog; these rows take the gridded headline array to an nside-256
    # (786k-source) and an nside-512 (3.1M-source) 24h sky: horizon
    # culling + banding + static blocking at catalog scale. Each reports
    # device compute, the planner's input footprint, and an accuracy
    # spot-check of a 512-source subsample against the fp64 oracle.
    scale_rows = []
    scale_cfgs = (
        [(256, 24), (512, 24), (1024, 24)]
        if full_scale
        else [(max(nside, 4), 3)]  # smoke: one config (a second identical
        # entry would just rerun the row and overwrite its ROWS slot)
    )
    for sc_nside, sc_times in scale_cfgs:
        ra_s, dec_s = healpix_radec(sc_nside)
        n_s = ra_s.size
        times_s = 2459863.2 + np.linspace(0, 1.0, sc_times)
        flux_s = rng.uniform(0.1, 1.0, (n_s, 1)).astype(np.float64)
        ekw_s = dict(
            ants=ants_g, fluxes=flux_s, ra=ra_s, dec=dec_s,
            freqs=np.array([freqs_g[0]]), times=times_s,
            beam_list=[beam_obj], baselines=baselines, telescope_loc=loc,
            polarized=False, precision=2,
        )
        run_s, in_s, info_s = TPUSimulationEngine().simulate(
            return_program="full", **ekw_s
        )
        # The 12.6M-source program runs seconds per sim; 2 repeats keep
        # the row's wall sane.
        huge = n_s > 4_000_000
        dev_s = _device_compute_time(
            run_s, in_s, 2 if huge else max(2, repeats // 2)
        )
        in_bytes = sum(
            int(np.prod(a.shape)) * a.dtype.itemsize for a in in_s
        )
        # Device-memory high-water after the run (allocator peak), when
        # the backend exposes it.
        hbm_peak = None
        try:
            stats = jax.local_devices()[0].memory_stats()
            hbm_peak = stats.get("peak_bytes_in_use")
        except Exception:
            pass
        fl_s = _model_flops(info_s, sc_times)
        # FULL-CATALOG accuracy: the whole sky through the blocked/banded
        # engine on a handful of baselines vs the fp64 direct oracle --
        # this measures the ACCUMULATED fp32 spread/sum error over n_s
        # sources (a subsample check would not; the error trend over
        # 786k -> 3.1M -> 12.6M sources against the 1e-5 gate is the
        # point of these rows).
        bl_acc = baselines[:: max(1, len(baselines) // 8)][:8]
        kw_sa = dict(
            ants=ants_g, fluxes=flux_s, ra=ra_s, dec=dec_s,
            freqs=np.array([freqs_g[0]]), times=times_s[:1],
            baselines=bl_acc, telescope_loc=loc, polarized=False,
            precision=2,
        )
        v_sa = simulate_vis(beam=GaussianBeam(diameter=14.0), backend="gpu", **kw_sa)
        v_so = DirectSimulationEngine().simulate(beam_list=[beam_obj], **kw_sa)
        acc_s = float(
            np.abs(v_sa - v_so).max() / max(np.abs(v_so).max(), 1e-30)
        )
        rate_s = len(baselines) * sc_times / dev_s
        scale_rows.append(
            (n_s, sc_times, dev_s, rate_s, in_bytes, acc_s, fl_s)
        )
        hbm_str = (
            f", HBM peak {hbm_peak / 1e9:.2f} GB" if hbm_peak else ""
        )
        print(
            f"[bench {DEVICE}] scale row nside={sc_nside}: {n_s} srcs x "
            f"{len(baselines)} bls x 1f x {sc_times}t, device "
            f"{dev_s * 1e3:.1f} ms/sim = {rate_s:.3e} pts/s; device inputs "
            f"{in_bytes / 1e6:.0f} MB{hbm_str}{_mfu_str(fl_s, dev_s)}; "
            f"FULL-catalog accuracy {acc_s:.2e} vs fp64 oracle "
            f"({len(bl_acc)} bls)",
            file=sys.stderr,
        )
        assert acc_s < 1e-4, f"scale-row accuracy regression: {acc_s:.2e}"
        _row(
            f"scale_{n_s}", dev_ms=dev_s * 1e3,
            mfu_pct=_mfu_val(fl_s, dev_s), acc=acc_s,
            in_mb=in_bytes / 1e6,
            hbm_gb=(hbm_peak / 1e9) if hbm_peak else None,
        )

    # ------------- 8. accuracy probe (quality guard) -------------
    # A small sub-problem against the in-repo exact float64 direct-DFT
    # oracle (host NumPy): catches silent numerical regressions alongside
    # the throughput numbers. Target: < 1e-5 relative (BASELINE.json).
    np_rng = np.random.default_rng(7)
    sel = np_rng.choice(nsrc, size=min(512, nsrc), replace=False)
    kw_a = dict(
        ants=ants_t, fluxes=flux_t[sel][:, :1], ra=ra[sel], dec=dec[sel],
        freqs=freqs_t[:1], times=times_t[:2], telescope_loc=loc,
        polarized=False, precision=2,
    )
    va = simulate_vis(beam=AiryBeam(diameter=14.0), backend="gpu", **kw_a)
    vo = DirectSimulationEngine().simulate(beam_list=[bt], **kw_a)
    acc = float(np.abs(va - vo).max() / max(np.abs(vo).max(), 1e-30))
    print(f"[bench {DEVICE}] accuracy probe: {acc:.2e} max rel vs fp64 direct oracle",
          file=sys.stderr)
    assert acc < 1e-4, f"accuracy probe regression: {acc:.2e}"

    _row("accuracy_probe", acc=acc)

    # Final line: compact and machine-readable (the full prose record is
    # on stderr, and each row was also emitted as a `[bench-row]` JSON
    # line above). Per-row keys: ratio = multiple of that row's own
    # reference-CPU baseline; wall/pipe/dev in ms; mfu in percent;
    # acc = max relative error vs the in-repo fp64 direct oracle.
    print(
        json.dumps(
            {
                "metric": (
                    f"tutorial-row sequential-wall throughput "
                    f"({DEVICE}, peak {peak_label}; "
                    f"per-row details in 'rows': ratio = x over each "
                    f"row's reference-CPU baseline, ms walls, MFU %, "
                    f"accuracy vs in-repo fp64 oracle)"
                ),
                "value": rate_t,
                "unit": "vis_points/s",
                "vs_baseline": ratio_t,
                "rows": ROWS,
            }
        )
    )


if __name__ == "__main__":
    main()
