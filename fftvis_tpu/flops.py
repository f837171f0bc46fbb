"""Analytic FLOP model + the accelerator peak table for MFU reporting.

The benchmark (bench.py) reports, for each scored row, the achieved
FLOP/s and the fraction of the device's peak (MFU). The numerator is the
ALGORITHM's arithmetic for the transform path the engine chose --
closed-form from the plan (spread / FFT / interp / coherency / factor
terms), not an HLO op count -- so padding waste and implementation
detours count AGAINST utilization, the standard MFU convention.

The dominant terms are exact MAC counts (the type-1 exact factored DFT's
``8 C n nmy nmx``, the direct path's ``8 C n nbl``, the ES spread/FFT
cells); the elementwise per-source constants (rotation 40, beam eval 22,
coherency 80) are estimates. The model has not been calibrated against
the GPU's compiled cost analysis (not measured).

The denominator is the device's peak for the unit the engine's float32
matmuls run on, which follows the traced matmul precision: full fp32
('float32', the engine's default) or TF32 tensor cores.
"""

from __future__ import annotations

import numpy as np

# Peak rates per device, keyed by jax.Device.device_kind. Source: NVIDIA
# H100 data sheet, SXM part, dense rates (no sparsity), at its 700 W power
# limit; a card set to a lower limit cannot hold these clocks.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "float32": 67e12,
        "tf32": 495e12,
        "bf16": 989e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}

# jax.default_matmul_precision value -> the peak its float32 matmuls run
# at on the GPU. 'high' is the rate of what that setting lowers to on the
# card (see PERF.md).
_PRECISION_PEAK = {
    "float32": "float32",
    "highest": "float32",
    "high": "tf32",
    "tensorfloat32": "tf32",
    "default": "tf32",
    "bfloat16": "bf16",
}


def chip_peak_flops(matmul_precision: str = "float32"):
    """(peak FLOP/s, human label) of the default device.

    Returns ``(None, kind)`` on the CPU test backend, where there is no
    device peak. A GPU missing from :data:`PEAKS` raises: a peak is never
    guessed.
    """
    import jax

    dev = jax.devices()[0]
    kind = dev.device_kind
    if dev.platform == "cpu":
        return None, kind
    if kind not in PEAKS:
        raise KeyError(f"no peak table entry for device kind {kind!r}")
    unit = _PRECISION_PEAK.get(str(matmul_precision).lower(), "float32")
    peak = PEAKS[kind][unit]
    return peak, f"{kind}: {peak / 1e12:.0f} TFLOP/s {unit}"


def program_model_flops(cfg, ntimes: int | None = None) -> dict:
    """Analytic FLOPs of one traced simulation program execution.

    ``cfg`` is the engine's :class:`fftvis_tpu.tpu.program.ProgramConfig`
    (obtainable via ``return_program="full"`` -> info["program_config"]).
    ``ntimes`` overrides the padded time count with the real one.

    Returns a dict of per-term FLOPs plus ``"total"``. Complex MAC = 8
    real FLOPs, complex multiply = 6; sincos is costed at ~10 FLOPs.
    """
    plan = cfg.plan
    nt = int(ntimes if ntimes is not None else cfg.nt_pad)
    nf = int(cfg.nfreqs)
    nfeeds = int(cfg.nfeeds)
    C = int(cfg.npairs) * nfeeds**2
    # Effective per-(time, freq) source count: banding reduces the scanned
    # axis to the K active blocks.
    n = float(cfg.K_band * plan.block if cfg.banded else plan.nsrc_pad)
    nbl = int(cfg.nbl)
    nbeam = max(len(cfg.beam_fps), 1)

    terms: dict[str, float] = {}

    # Coordinate chain, per time: aberration add + normalization (3 mul,
    # rsqrt ~ 8, 3 scale) + 3x3 rotation matvec (15) + az/za (~12).
    terms["rotation"] = nt * 40.0 * n

    # Beam evaluation, per (time, freq): bilinear/cubic table gather +
    # lerp or the analytic closed form, per feed-component.
    ncomp = 4 if cfg.polarized else 1
    terms["beam_eval"] = nt * nf * nbeam * n * 22.0 * ncomp

    # Coherency (A_i^dag C A_j rows), per (time, freq) per pair channel.
    coh_per = 80.0 if cfg.polarized else 8.0
    terms["coherency"] = nt * nf * int(cfg.npairs) * n * coh_per

    # Transform path.
    mode = plan.mode
    if mode == "direct":
        # Phase einsum (d-dim dot, ~2d) + sincos (~10) per (source,
        # baseline slot), then the complex MAC contraction. Multi-pair
        # routing restricts each pair channel to ITS baselines: the
        # padded einsum runs nfeeds^2 channels over (npairs x m_max)
        # slots, the per-pair loop partitions nbl across pairs -- in
        # both cases the contraction is 8 nfeeds^2 n slots, NOT
        # 8 C n slots (C already contains npairs). Only the basis /
        # single-pair paths contract every channel at every baseline.
        d = 2 if plan.is_coplanar else 3
        if cfg.use_basis or cfg.npairs <= 1:
            phase_slots = nbl
            contract = 8.0 * C * n * nbl
        elif cfg.pad_routing:
            phase_slots = int(cfg.npairs) * int(cfg.m_max)
            contract = 8.0 * nfeeds**2 * n * phase_slots
        else:  # work-optimal per-pair loop: pair sels partition nbl
            phase_slots = nbl
            contract = 8.0 * nfeeds**2 * n * nbl
        terms["direct_phase"] = nt * nf * n * phase_slots * (2.0 * d + 10.0)
        terms["direct_contract"] = nt * nf * contract
        if cfg.use_ds:
            # Compensated arithmetic: ~10x the plain op count (two_prod /
            # ds_add chains); approximate.
            terms["direct_phase"] *= 10.0
            terms["direct_contract"] *= 10.0
    elif mode == "type1":
        eplan = plan.executor.plan
        cells = float(np.prod(eplan.nf))
        if hasattr(eplan, "split"):  # Type1ExactPlan: factored separable DFT
            fac = sum(K + nhi for (K, nhi) in eplan.split)
            terms["t1x_factors"] = nt * nf * n * (fac * 12.0 + 2.0 * cells * 6.0 / max(C, 1))
            # The algorithm: C x (n x nm_y nm_x) complex MACs (identical
            # for the factored-einsum and outer-product formulations).
            terms["t1x_contract"] = nt * nf * 8.0 * C * n * cells
            terms["t1x_gather"] = nt * nf * 2.0 * C * nbl
        else:  # ES spread + FFT + deconvolved gather
            w = eplan.kernel.w
            # Dense matmul spread: (2C, n) x (n, cells) real MACs per axis
            # formulation ~ 4 C n cells; kernel evaluation ~ 12 w n.
            terms["t1_spread"] = nt * nf * (4.0 * C * n * cells + 12.0 * w * n)
            terms["t1_fft"] = nt * nf * 5.0 * C * cells * np.log2(max(cells, 2))
            terms["t1_gather"] = nt * nf * 8.0 * C * nbl
    else:  # type3
        ex = plan.executor
        eplan = ex.plan
        w = eplan.kernel.w
        cm = getattr(ex, "channel_multiplier", 1)
        C2 = C * cm
        cells = float(np.prod(eplan.nf))
        # Useful spreading work: each source updates a w^d window per
        # channel (+ ES kernel evaluation ~12 w per source per axis).
        terms["t3_spread"] = nt * nf * (8.0 * C2 * n * w**2 + 24.0 * w * n)
        terms["t3_fft"] = nt * nf * 5.0 * C2 * cells * np.log2(max(cells, 2))
        terms["t3_interp"] = nt * nf * 8.0 * C2 * nbl * w**2
        terms["t3_prephase"] = nt * nf * 20.0 * C2 * n

    # Eigenbeam coefficient contraction (basis path).
    if cfg.use_basis:
        terms["basis_contract"] = nt * nf * 16.0 * int(cfg.npairs) * nfeeds**2 * nbl

    terms["total"] = float(sum(terms.values()))
    return terms


def mfu_value(total_flops: float, seconds: float,
              matmul_precision: str = "float32") -> float | None:
    """MFU as a percentage (None on the CPU test backend). The single
    source of the formula; ``mfu_string`` and bench row emission both
    delegate here so the printed and machine-readable numbers cannot
    drift apart."""
    peak, _label = chip_peak_flops(matmul_precision)
    if not peak:
        return None
    return 100.0 * total_flops / max(seconds, 1e-12) / peak


def mfu_string(total_flops: float, seconds: float,
               matmul_precision: str = "float32") -> str:
    """Format 'X.X GFLOP, Y.Y TFLOP/s, mfu=Z.Z%' (mfu omitted on the CPU)."""
    rate = total_flops / max(seconds, 1e-12)
    s = f"{total_flops / 1e9:.1f} GFLOP at {rate / 1e12:.2f} TFLOP/s"
    mfu = mfu_value(total_flops, seconds, matmul_precision)
    if mfu is not None:
        s += f", mfu={mfu:.1f}%"
    return s
