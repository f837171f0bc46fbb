"""The jitted simulation program: builder + declared static configuration.

:class:`ProgramConfig` is the SINGLE declared structure of every static
ingredient that shapes the traced program. Two things follow from it by
construction:

* :func:`build_program` -- builds the ``program(...)`` callable (the
  time/freq/source-block ``lax.scan`` nest) reading ONLY ``cfg`` fields;
* :func:`cache_key` -- derives the compiled-program cache key by
  iterating the dataclass fields, so a new knob added to the config
  cannot be forgotten from the key (the round-3 review flagged the
  hand-enumerated ~40-ingredient key as a stale-program bug class).

Field key policy, declared per field via ``dataclasses.field(metadata=...)``:

* default -- the field value is hashed into the key (arrays by content);
* ``{"fp": fn}`` -- ``fn(value)`` is hashed instead (objects whose repr
  truncates or whose identity is irrelevant: plans, meshes, routings);
* ``{"key": False, "covered_by": "..."}`` -- explicitly excluded, with a
  written justification naming the fields that already cover it
  (derived objects only). An exclusion without justification raises.

Additionally every ``FFTVIS_*`` environment variable is folded into the
key: env switches bake spread/interp/beam-eval lowerings into the trace,
and enumerating them by hand is exactly the forgettable-knob failure mode
this module exists to remove. (Over-keying can only cost a recompile;
under-keying silently runs a stale program.)
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field

import numpy as np

from ..coords.rotation import enu_to_az_za
from ..core import coherency as coh_mod
from ..core.hashing import hash_parts as _hash_parts
from ..core.utils import speed_of_light
from .ds_lowering import (
    ds_coordinate_chain,
    ds_coords_spread,
    ds_direct_accumulate,
)
from .planning import device_memory_limit, sim_plan_fingerprint

TWO_PI = 2.0 * np.pi


def pair_plan_fingerprint(pp) -> tuple | None:
    if pp is None:
        return None
    return (tuple(pp.pairs), tuple(s for s in pp.bls_idxs))


def mesh_fingerprint(mesh) -> tuple | None:
    if mesh is None:
        return None
    return (
        tuple(mesh.axis_names),
        tuple(mesh.devices.shape),
        tuple(d.id for d in mesh.devices.flat),
    )


def _dtype_name(dt) -> str:
    return str(dt)


@dataclass
class ProgramConfig:
    """Every static ingredient of the traced simulation program."""

    # ---- path selection & numerics ----
    plan: object = field(metadata={"fp": sim_plan_fingerprint})
    use_ds: bool = False
    ds_coords: bool = False
    banded: bool = False
    band_compact: bool = False
    K_band: int = 0
    real_dtype: object = field(default=None, metadata={"fp": _dtype_name})
    complex_dtype: object = field(default=None, metadata={"fp": _dtype_name})
    eps: float = 0.0
    upsample_factor: float = 2.0
    matmul_precision: str = "float32"
    freq_vmap: bool = False
    # ---- problem extents ----
    nbl: int = 0
    nfeeds: int = 1
    npairs: int = 1
    nfreqs: int = 1
    nf_pad: int = 1
    nfreqs_local: int = 1
    nt_pad: int = 1
    n_fdev: int = 1
    polarized: bool = False
    polarized_sky: bool = False
    # ---- pair routing ----
    pair_plan: object = field(
        default=None, metadata={"fp": pair_plan_fingerprint}
    )
    flipped_global: np.ndarray | None = None
    pad_routing: bool = False
    m_max: int = 0
    # ---- eigenbeam basis ----
    use_basis: bool = False
    basis_kl_sym: bool = True
    kl_pairs: tuple | None = None
    # Auto-rank only: baselines whose per-antenna routing was flipped;
    # the basis output applies the reference's conj-without-feed-swap
    # convention there (a feed transpose of the plain result) so the
    # substitution is transparent. None for user-provided beam_coefs.
    basis_flip_transpose: np.ndarray | None = None
    coefs_host: np.ndarray | None = None
    ant1_dev: np.ndarray | None = None
    ant2_dev: np.ndarray | None = None
    # ---- beams ----
    # `prepared` / `batched_beams` are deterministic functions of the beam
    # list (fingerprinted in beam_fps), the simulation freqs (freqs_dev),
    # polarized, spline_opts_repr and interpolation_function -- all keyed.
    prepared: list = field(
        default=None,
        metadata={
            "key": False,
            "covered_by": "beam_fps, freqs_dev, polarized, "
            "spline_opts_repr, interpolation_function",
        },
    )
    batched_beams: object = field(
        default=None,
        metadata={
            "key": False,
            "covered_by": "beam_fps, freqs_dev, polarized, "
            "spline_opts_repr, interpolation_function",
        },
    )
    beam_fps: tuple = ()
    spline_opts_repr: str = "None"
    interpolation_function: str = "az_za_map_coordinates"
    # ---- host constants traced into the program ----
    freqs_dev: np.ndarray | None = None
    tg_ds_host: np.ndarray | None = None
    lat_ds_host: np.ndarray | None = None
    k2pi_c_ds: tuple | None = None
    freqs_ds_host: np.ndarray | None = None
    # ---- mesh / SPMD ----
    mesh: object = field(default=None, metadata={"fp": mesh_fingerprint})
    time_axis: str = "time"
    source_axis: str = "source"
    freq_axis: str = "freq"


def cache_key(cfg: ProgramConfig) -> str:
    """Program cache key derived from the declared config fields."""
    parts: list = ["pcfg-v1"]
    for f in dataclasses.fields(ProgramConfig):
        meta = f.metadata
        if meta.get("key", True) is False:
            if not meta.get("covered_by"):
                raise AssertionError(
                    f"ProgramConfig.{f.name} excluded from the cache key "
                    "without a covered_by justification"
                )
            continue
        v = getattr(cfg, f.name)
        fp = meta.get("fp")
        parts.append((f.name, fp(v) if fp is not None else v))
    # Trace-time env switches (FFTVIS_SPREADER/_INTERP/_BEAM_EVAL/_TILE/
    # _DEBUG/...) bake lowerings into the program; key them ALL.
    parts.append(
        tuple(
            sorted(
                (k, v)
                for k, v in os.environ.items()
                if k.startswith("FFTVIS_")
            )
        )
    )
    return _hash_parts(tuple(parts))


def per_freq_bytes(plan, npairs, nfeeds, pad_routing, m_max,
                   use_ds, band_compact, K_band, nbl) -> int:
    """Live-footprint estimate of one (time, freq) unit of the program."""
    _C_total = npairs * nfeeds**2
    if plan.mode == "direct":
        # Padded multi-pair routing materializes (block, P, m_max)
        # phase/fringe tensors -- (P * m_max) / nbl larger than the
        # per-baseline footprint when pair sizes are skewed.
        _eff_bl = npairs * m_max if pad_routing else nbl
        if use_ds:
            _eff_bl = nbl
        return (
            plan.block * _eff_bl * (96 * _C_total if use_ds else 12)
            + _C_total * nbl * 16
        )
    _cmult = getattr(plan.executor, "channel_multiplier", 1)
    _blk_eff = K_band * plan.block if band_compact else plan.block
    return (
        2 * _C_total * _cmult * int(np.prod(plan.executor.plan.nf)) * 8
        + _blk_eff * _C_total * _cmult * 16
    )


def choose_freq_vmap(plan, npairs, nfeeds, pad_routing, m_max,
                     use_ds, band_compact, K_band, nbl, nfreqs_local) -> bool:
    """Frequency-axis execution choice: vmap (one batched program) when
    the per-frequency live footprint allows, else a sequential scan."""
    _per_freq = per_freq_bytes(
        plan, npairs, nfeeds, pad_routing, m_max, use_ds, band_compact,
        K_band, nbl,
    )
    return (
        nfreqs_local > 1
        and nfreqs_local * _per_freq < device_memory_limit() // 12
    )


def _unship_complex(x, was_complex: bool):
    if not was_complex:
        return x
    return x[0] + 1j * x[1]


def build_program(cfg: ProgramConfig):
    """Build the jitted simulation program from the declared config.

    The returned ``program(mats, abvel, eq, coherency, valid, freqs,
    beam_table[, act_idx, act_val])`` is the full traced pipeline:
    per-time coordinate rotation -> beam evaluation -> coherency ->
    transform (type-1 / type-3 / direct, plain or double-single) ->
    per-pair routing / basis contraction -- a lax.scan nest over
    (times, freqs, source blocks). See the engine docstring for the
    structural inversion relative to the reference's Python loop nest
    (ref cpu_simulate.py:856-1071).
    """
    import jax
    import jax.numpy as jnp

    plan = cfg.plan
    mesh = cfg.mesh
    use_ds, ds_coords = cfg.use_ds, cfg.ds_coords
    banded, band_compact, K_band = cfg.banded, cfg.band_compact, cfg.K_band
    real_dtype, complex_dtype = cfg.real_dtype, cfg.complex_dtype
    nbl, nfeeds, npairs = cfg.nbl, cfg.nfeeds, cfg.npairs
    nfreqs, nf_pad, nfreqs_local = cfg.nfreqs, cfg.nf_pad, cfg.nfreqs_local
    n_fdev = cfg.n_fdev
    polarized, polarized_sky = cfg.polarized, cfg.polarized_sky
    pair_plan, pad_routing, m_max = cfg.pair_plan, cfg.pad_routing, cfg.m_max
    use_basis, basis_kl_sym = cfg.use_basis, cfg.basis_kl_sym
    kl_pairs = cfg.kl_pairs
    prepared, batched_beams = cfg.prepared, cfg.batched_beams
    freq_vmap = cfg.freq_vmap
    flipped_global = cfg.flipped_global
    coh_was_complex = polarized_sky  # IQUV coherency is (.., 2, 2) complex

    rotation_dev = plan.rotation_matrix.astype(real_dtype)
    lattice_dev = (
        plan.lattice_matrix.astype(real_dtype)
        if plan.lattice_matrix is not None
        else None
    )
    flip_dev = flipped_global

    if use_basis:
        coefs_host = cfg.coefs_host
        ant1_dev = cfg.ant1_dev
        ant2_dev = cfg.ant2_dev

    def eval_pair_rows(evals, bi, bj, flux_f):
        return coh_mod.apparent_coherency_rows(
            evals[bi], evals[bj], flux_f, polarized, polarized_sky
        ).astype(complex_dtype)

    # Same-grid tabulated beam lists (eigenbeam bases, per-antenna CST
    # sweeps) fuse into ONE interpolation + ONE pair einsum per block;
    # per-beam/per-pair op counts otherwise dominate device time.
    pairs_arr = np.asarray(
        kl_pairs if use_basis else list(pair_plan.pairs), dtype=np.int64
    ).reshape(-1, 2)
    pair_i, pair_j = pairs_arr[:, 0], pairs_arr[:, 1]

    # Pair routing partitions the baseline list; assembling per-pair
    # results via .at[sel].set() lowers to an XLA scatter, even for an
    # identity permutation. Concatenate in routing order instead and
    # apply one static inverse-permutation take (free: static-index
    # takes compile to copies), or nothing when routing is in order.
    if not use_basis:
        sel_concat = (
            np.concatenate(
                [np.asarray(s, dtype=np.int64) for s in pair_plan.bls_idxs]
            )
            if npairs
            else np.arange(nbl, dtype=np.int64)
        )
        sel_is_identity = np.array_equal(sel_concat, np.arange(nbl))
        inv_perm = None
        if not sel_is_identity:
            inv_perm = np.empty(nbl, dtype=np.int64)
            inv_perm[sel_concat] = np.arange(nbl, dtype=np.int64)
        # Padded pair routing: per-pair Python loops (gathers, phase
        # einsums, assembly) unroll into an O(npairs)-sized HLO --
        # ~6 min of compile for a 37-distinct-beam array (703 pairs).
        # Padding every pair's baseline list to the longest one turns
        # the whole routing into a handful of batched ops.
        # Padding wastes (npairs * m_max) / nbl slots when pair sizes
        # are skewed (one dominant beam + outliers); the per-pair loop
        # is work-optimal but unrolls an O(npairs) HLO (minutes of
        # compile at hundreds of pairs). pad_routing batches when the
        # waste is bounded or the pair count is large.
        if pad_routing:
            sel_pad = np.zeros((npairs, m_max), dtype=np.int64)
            sel_valid = np.zeros((npairs, m_max), dtype=bool)
            src_pos = np.empty(nbl, dtype=np.int64)
            for p, s in enumerate(pair_plan.bls_idxs):
                s = np.asarray(s, dtype=np.int64)
                sel_pad[p, : s.size] = s
                sel_valid[p, : s.size] = True
                src_pos[s] = p * m_max + np.arange(s.size)
            flip_pad = flipped_global[sel_pad] & sel_valid

    def source_block_weights(az, za, mask, flux_f, fv, gfi, beamtab=None):
        """Evaluate beams + coherency for one source block: (C, B).

        jax.named_scope tags flow into the HLO op metadata, so the
        profiler (examples/trace_report.py) can attribute fused ops to
        pipeline stages.
        """
        if batched_beams is not None and len(pair_i) > 0:
            with jax.named_scope("beam_eval"):
                evals_all = batched_beams.evaluate_all(
                    az, za, fv, gfi, beamtab
                )
            with jax.named_scope("coherency"):
                rows = coh_mod.apparent_coherency_rows_batched(
                    evals_all, pair_i, pair_j, flux_f, polarized,
                    polarized_sky,
                ).astype(complex_dtype)
            return rows * mask[None, :]
        with jax.named_scope("beam_eval"):
            evals = [pb.evaluate(az, za, fv, gfi) for pb in prepared]
        with jax.named_scope("coherency"):
            if use_basis:
                rows = [
                    eval_pair_rows(evals, k, l, flux_f)
                    for (k, l) in kl_pairs
                ]
            else:
                rows = [
                    eval_pair_rows(evals, bi, bj, flux_f)
                    for (bi, bj) in pair_plan.pairs
                ]
            rows = jnp.concatenate(rows, axis=0)  # (C, B)
        return rows * mask[None, :]

    def nufft_coords(topo, fv):
        """Transform-space source coordinates for one block: (d, B)."""
        if plan.lattice_matrix is not None:
            lat = jnp.asarray(lattice_dev) @ topo  # (3, B)
            return lat[:2] * (TWO_PI * fv)
        xr = jnp.asarray(rotation_dev) @ topo
        scale = TWO_PI * fv / speed_of_light
        d = 2 if plan.is_coplanar else 3
        return xr[:d] * scale

    def per_freq(topo_t, az_t, za_t, mask_t, coh_a, freqs_a, gshift, fi,
                 beamtab=None, aidx=None, aval=None):
        fv = freqs_a[fi]
        # Global frequency index for beam tables (clamped off the pad).
        gfi = jnp.minimum(gshift + fi, nfreqs - 1)

        flux_f = jnp.take(coh_a, fi, axis=1)
        if not banded or band_compact:
            # Reshape the (local) source axis into (nblocks, block).
            # Compacted banding: the per-time gather already reduced
            # the axis to (K_band * block); run it as ONE mega-block
            # (exactly one spread + overlap-add post-pass per freq).
            if band_compact:
                nb_eff, blk_eff = 1, K_band * plan.block
            else:
                nb_eff, blk_eff = plan.nblocks, plan.block
            if use_ds or ds_coords:
                topo_blocks = topo_t.reshape(3, nb_eff, blk_eff, 2)
            else:
                topo_blocks = topo_t.reshape(3, nb_eff, blk_eff)
            az_blocks = az_t.reshape(nb_eff, blk_eff)
            za_blocks = za_t.reshape(nb_eff, blk_eff)
            mask_blocks = mask_t.reshape(nb_eff, blk_eff)
            if not polarized_sky:  # (nsrc, nfreq) flux
                flux_blocks = flux_f.reshape(nb_eff, blk_eff)
            else:  # (nsrc, nfreq, 2, 2) coherency
                flux_blocks = flux_f.reshape(nb_eff, blk_eff, 2, 2)

        C = npairs * nfeeds**2

        # With several distinct beam pairs, each pair's channels are only
        # needed at that pair's baselines: restrict the direct sums /
        # gathers per pair instead of computing (C x nbl) everywhere.
        multi = (not use_basis) and npairs > 1
        nf2 = nfeeds**2

        if use_ds or ds_coords:
            gfi_pad = jnp.minimum(gshift + fi, nf_pad - 1)
            f_h = jnp.asarray(cfg.freqs_ds_host[:, 0])[gfi_pad]
            f_l = jnp.asarray(cfg.freqs_ds_host[:, 1])[gfi_pad]

        def scan_body(carry, blk):
            topo_b, az_b, za_b, mask_b, flux_b = blk
            rows = source_block_weights(
                az_b, za_b, mask_b, flux_b, fv, gfi, beamtab
            )
            if use_ds:
                # Compensated exact path (tpu/ds_lowering.py). The
                # engine's block-size budget scales with C to bound the
                # (C, B, nbl) two-float temporaries.
                return ds_direct_accumulate(
                    carry, topo_b, rows, cfg.tg_ds_host, f_h, f_l, nbl,
                    real_dtype,
                ), None
            if ds_coords:
                return ds_coords_spread(
                    carry, topo_b, rows, plan, cfg.lat_ds_host, f_h, f_l,
                    cfg.k2pi_c_ds,
                ), None
            x = nufft_coords(topo_b, fv)
            if plan.mode == "direct":
                tg = plan.targets.astype(real_dtype)  # (d, nbl) signed
                if multi and pad_routing:
                    # Batched over pairs via the padded routing: one
                    # phase einsum + one batched matmul, not npairs.
                    tgp = tg[:, sel_pad]  # (d, P, m_max) host constant
                    phase = jnp.einsum("dpm,dn->npm", jnp.asarray(tgp), x)
                    e = (jnp.cos(phase) + 1j * jnp.sin(phase)).astype(
                        complex_dtype
                    )
                    rows3 = rows.reshape(npairs, nf2, -1)
                    return carry + jnp.einsum("pfn,npm->pfm", rows3, e), None
                if multi:
                    # Skewed pair sizes: the work-optimal per-pair loop.
                    outs = []
                    for p in range(npairs):
                        sel = pair_plan.bls_idxs[p]
                        phase = jnp.einsum(
                            "db,dn->nb", jnp.asarray(tg[:, sel]), x
                        )
                        e = (jnp.cos(phase) + 1j * jnp.sin(phase)).astype(
                            complex_dtype
                        )
                        outs.append(
                            carry[p] + rows[p * nf2 : (p + 1) * nf2] @ e
                        )
                    return tuple(outs), None
                phase = jnp.einsum("db,dn->nb", jnp.asarray(tg), x)
                e = (jnp.cos(phase) + 1j * jnp.sin(phase)).astype(complex_dtype)
                return carry + rows @ e, None
            return carry + plan.executor.spread(x, rows), None

        if use_ds:
            init = tuple(
                jnp.zeros((C, nbl), real_dtype) for _ in range(4)
            )
        elif plan.mode == "direct":
            if multi and pad_routing:
                init = jnp.zeros(
                    (npairs, nf2, sel_pad.shape[1]), dtype=complex_dtype
                )
            elif multi:
                init = tuple(
                    jnp.zeros(
                        (nf2, len(pair_plan.bls_idxs[p])),
                        dtype=complex_dtype,
                    )
                    for p in range(npairs)
                )
            else:
                init = jnp.zeros((C, nbl), dtype=complex_dtype)
        else:
            CK = C * getattr(plan.executor, "channel_multiplier", 1)
            init = jnp.zeros(
                (CK,) + tuple(plan.executor.plan.nf), dtype=complex_dtype
            )
        if mesh is not None:
            # Under shard_map the scan carry varies over the mesh axes
            # (its updates depend on sharded inputs); mark the zero init
            # accordingly for the varying-manual-axes checker.
            init = jax.tree.map(
                lambda a: jax.lax.pcast(
                    a, tuple(mesh.axis_names), to="varying"
                ),
                init,
            )

        if banded and not band_compact:
            # Horizon-band scan: only the per-time ACTIVE blocks run
            # (contiguous dynamic slices of the RA-ordered source
            # axis); padded table rows point at block 0 with weight 0.
            def banded_body(carry, xsk):
                bi, av = xsk
                s0 = bi * plan.block
                topo_b = jax.lax.dynamic_slice_in_dim(
                    topo_t, s0, plan.block, axis=1
                )
                az_b = jax.lax.dynamic_slice_in_dim(
                    az_t, s0, plan.block, axis=0
                )
                za_b = jax.lax.dynamic_slice_in_dim(
                    za_t, s0, plan.block, axis=0
                )
                mask_b = jax.lax.dynamic_slice_in_dim(
                    mask_t, s0, plan.block, axis=0
                ) * av.astype(real_dtype)
                flux_b = jax.lax.dynamic_slice_in_dim(
                    flux_f, s0, plan.block, axis=0
                )
                return scan_body(carry, (topo_b, az_b, za_b, mask_b, flux_b))

            acc, _ = jax.lax.scan(banded_body, init, (aidx, aval))
        else:
            acc, _ = jax.lax.scan(
                scan_body,
                init,
                (
                    jnp.moveaxis(topo_blocks, 1, 0),
                    az_blocks,
                    za_blocks,
                    mask_blocks,
                    flux_blocks,
                ),
            )

        # Source-sharded SPMD: the fine grid (or direct partial sums)
        # is the natural all-reduce point (SURVEY section 5: "the
        # FFT-grid accumulation is the natural all-reduce"). Applied for
        # any mesh (a size-1 axis reduce is free) so the output is
        # provably replicated over the source axis.
        if mesh is not None:
            acc = jax.lax.psum(acc, cfg.source_axis)

        if use_ds:
            # Return the raw (2 reim, 2 hilo, C, nbl) DS planes; flip
            # conjugation, the feed transpose, pair routing, and the
            # eigenbeam coefficient contraction all happen on the HOST
            # in float64 after the hi+lo combine (doing them on device
            # would collapse the planes back to f32).
            vr_h, vr_l, vi_h, vi_l = acc
            return jnp.stack(
                [jnp.stack([vr_h, vr_l]), jnp.stack([vi_h, vi_l])]
            )

        if multi and not pad_routing:
            # Work-optimal per-pair routing (skewed pair sizes, small
            # npairs): per-pair gathers/interpolation, concatenated in
            # routing order and un-permuted with one static take.
            if plan.mode == "direct":
                pair_outs = list(acc)
            else:
                G = plan.executor.transform(acc)
                cm = getattr(plan.executor, "channel_multiplier", 1)
                pair_outs = []
                for p in range(npairs):
                    sel = pair_plan.bls_idxs[p]
                    Gp = G[p * nf2 * cm : (p + 1) * nf2 * cm]
                    if plan.mode == "type1":
                        pair_outs.append(plan.executor.gather(Gp, sel))
                    else:
                        pair_outs.append(plan.executor.interpolate(Gp, sel))
            vps = []
            for p in range(npairs):
                sel = pair_plan.bls_idxs[p]
                flip_p = flipped_global[sel]
                vp = jnp.where(
                    flip_p[None, :], jnp.conj(pair_outs[p]), pair_outs[p]
                )
                vps.append(
                    jnp.transpose(
                        vp.reshape(nfeeds, nfeeds, len(sel)), (2, 1, 0)
                    )
                )
            vis_f = jnp.concatenate(vps, axis=0)
            return vis_f if sel_is_identity else vis_f[inv_perm]

        if multi:
            m_pad = sel_pad.shape[1]
            if plan.mode == "direct":
                out = acc  # (P, nf2, m_max), batched in scan_body
            elif plan.mode == "type1":
                # Batched gather over the padded routing (channels are
                # pair-major; the type-1 executor has no channel
                # multiplier).
                out = plan.executor.gather_padded(
                    plan.executor.transform(acc), sel_pad
                )
            else:
                # type-3: the tiled interpolation is host-planned per
                # target subset, so keep the per-pair loop (npairs is
                # small off-lattice) and pad-stack for assembly. Grid
                # channels are input-channel-major with the lowrank-z
                # z-mode multiplier (c*K + k layout).
                G = plan.executor.transform(acc)
                cm = getattr(plan.executor, "channel_multiplier", 1)
                pair_outs = []
                for p in range(npairs):
                    sel = pair_plan.bls_idxs[p]
                    Gp = G[p * nf2 * cm : (p + 1) * nf2 * cm]
                    vp = plan.executor.interpolate(Gp, sel)
                    pair_outs.append(
                        jnp.pad(vp, ((0, 0), (0, m_pad - vp.shape[1])))
                    )
                out = jnp.stack(pair_outs)  # (P, nf2, m_max)

            # Flip conjugation + the reference's feed transpose (ref
            # cpu_simulate.py:298-300), batched; one static take lands
            # every baseline at its slot (padding rows are never taken).
            out = jnp.where(
                jnp.asarray(flip_pad)[:, None, :], jnp.conj(out), out
            )
            out = out.reshape(npairs, nfeeds, nfeeds, m_pad)
            out = jnp.transpose(out, (0, 3, 2, 1))
            return out.reshape(npairs * m_pad, nfeeds, nfeeds)[src_pos]

        if plan.mode == "direct":
            out_all = acc  # (C, nbl)
        elif plan.mode == "type1":
            G = plan.executor.transform(acc)
            out_all = plan.executor.gather(G)  # (C, nbl)
        else:
            G = plan.executor.transform(acc)
            out_all = plan.executor.interpolate(G)  # (C, nbl)

        # Assemble (nbl, nfeeds, nfeeds) with flip conjugation and the
        # reference's feed transpose (ref cpu_simulate.py:298-300).
        out_all = jnp.where(flip_dev[None, :], jnp.conj(out_all), out_all)
        per_pair = out_all.reshape(npairs, nfeeds, nfeeds, nbl)

        if use_basis:
            coefs_dev = jnp.asarray(coefs_host)
            c1 = jnp.conj(coefs_dev[ant1_dev, :, gfi])  # (nbl, K)
            c2 = coefs_dev[ant2_dev, :, gfi]
            # vis[b] = sum_p w_kl[b] V_p^T + (k!=l) w_lk[b] V_p as two
            # einsums over the pair axis (one per transpose orientation)
            # instead of an npairs-long accumulation loop.
            w_kl = c1[:, pair_i] * c2[:, pair_j]  # (nbl, P)
            vis_f = jnp.einsum("bp,pfgb->bgf", w_kl, per_pair)
            if basis_kl_sym:
                # k<=l half-list: the (l, k) channel is reused as the
                # feed transpose of (k, l) (exact for real tables and a
                # symmetric sky coherency; reference semantics, ref
                # cpu_simulate.py:461-468). The auto-rank ordered list
                # carries every (k, l) explicitly instead.
                offdiag = (pair_i != pair_j).astype(coefs_host.dtype)
                w_lk = (c1[:, pair_j] * c2[:, pair_i]) * jnp.asarray(
                    offdiag
                )
                vis_f = vis_f + jnp.einsum("bp,pfgb->bfg", w_lk, per_pair)
            bft = cfg.basis_flip_transpose
            if bft is not None and bft.any():
                # Auto-rank transparency: reproduce the per-antenna path's
                # flipped-baseline convention (conj without feed swap, ref
                # cpu_simulate.py:298-300) == a feed transpose of the plain
                # basis result on those baselines (see the engine's
                # auto-rank branch).
                vis_f = jnp.where(
                    jnp.asarray(bft)[:, None, None],
                    jnp.swapaxes(vis_f, 1, 2),
                    vis_f,
                )
            return vis_f.astype(complex_dtype)

        if npairs == 1 and sel_is_identity:
            return jnp.transpose(per_pair[0], (2, 1, 0))
        vps = [
            jnp.transpose(
                per_pair[p][:, :, pair_plan.bls_idxs[p]], (2, 1, 0)
            )
            for p in range(npairs)
        ]
        vis_f = vps[0] if npairs == 1 else jnp.concatenate(vps, axis=0)
        return vis_f if sel_is_identity else vis_f[inv_perm]

    def program(mats_a, abvel_a, eq_a, coh_ship_a, valid_a, freqs_a,
                beamtab_a, act_idx_a=None, act_val_a=None):
        # Stacked beam tables travel as an INPUT, not a closure
        # constant: a multi-MB constant dominates the serialized HLO
        # and with it the compile time.
        beamtab = beamtab_a if batched_beams is not None else None
        coh_a = _unship_complex(coh_ship_a, coh_was_complex)
        if mesh is not None and n_fdev > 1:
            gshift = jax.lax.axis_index(cfg.freq_axis) * nfreqs_local
        else:
            gshift = jnp.int32(0)

        def per_time(carry, tinp):
            if banded:
                mat, vel, aidx, aval = tinp
            else:
                (mat, vel), aidx, aval = tinp, None, None
            eq_t, valid_t, coh_t, aval_t = eq_a, valid_a, coh_a, None
            if band_compact:
                # Gather the K active blocks BEFORE the coordinate
                # chain: the equatorial vectors are time-invariant, so
                # slicing them (one contiguous-dynamic-slice scan) lets
                # aberration, normalization,
                # rotation, az/za, beam eval, coherency, bin-sort and
                # spread ALL pay (K_band * block) instead of nsrc.
                # Padded table rows re-copy block 0 with weight 0 --
                # exact, like the banded scan.
                blkn = plan.block

                def _cstep(_, bi):
                    s0 = bi * blkn
                    return None, (
                        jax.lax.dynamic_slice_in_dim(eq_a, s0, blkn, axis=1),
                        jax.lax.dynamic_slice_in_dim(
                            valid_a, s0, blkn, axis=0
                        ),
                        jax.lax.dynamic_slice_in_dim(coh_a, s0, blkn, axis=0),
                    )

                _, (e_s, v_s, c_s) = jax.lax.scan(_cstep, None, aidx)
                eq_t = jnp.moveaxis(e_s, 0, 1).reshape(
                    (3, K_band * blkn) + e_s.shape[3:]
                )
                valid_t = v_s.reshape(K_band * blkn)
                coh_t = c_s.reshape((K_band * blkn,) + c_s.shape[2:])
                aval_t = jnp.repeat(
                    aval.astype(real_dtype), blkn,
                    total_repeat_length=K_band * blkn,
                )
            if use_ds or ds_coords:
                topo, topo_hi = ds_coordinate_chain(eq_t, vel, mat, ds_coords)
            else:
                eqa = eq_t + vel[:, None]
                eqa = eqa / jnp.linalg.norm(eqa, axis=0, keepdims=True)
                topo = mat @ eqa  # (3, nsrc_local)
                topo_hi = topo
            mask_up = (topo_hi[2] > 0).astype(real_dtype) * valid_t
            if aval_t is not None:
                mask_up = mask_up * aval_t
            az, za = enu_to_az_za(topo_hi[0], topo_hi[1], orientation="uvbeam")

            if freq_vmap:
                # Batch all frequencies into one program (larger matmuls;
                # a scan of tiny per-freq bodies is launch-bound).
                vis_t = jax.vmap(
                    lambda fi: per_freq(
                        topo, az, za, mask_up, coh_t, freqs_a, gshift,
                        fi, beamtab, aidx, aval,
                    )
                )(jnp.arange(nfreqs_local))
            else:
                def freq_body(_, fi):
                    return None, per_freq(
                        topo, az, za, mask_up, coh_t, freqs_a, gshift,
                        fi, beamtab, aidx, aval,
                    )

                _, vis_t = jax.lax.scan(
                    freq_body, None, jnp.arange(nfreqs_local)
                )
            return carry, vis_t  # (nfreq, nbl, nfeeds, nfeeds)

        # Times are independent (the scan carry is None); a scan keeps
        # the working set to one time's. Vmapping small time extents has
        # not been measured on the GPU.
        _, vis = jax.lax.scan(
            per_time,
            None,
            (mats_a, abvel_a, act_idx_a, act_val_a)
            if banded
            else (mats_a, abvel_a),
        )
        if use_ds:
            # per_freq returned (2 reim, 2 hilo, nbl, f, g) real planes;
            # lift them to the front for the host float64 combine.
            return jnp.moveaxis(vis, (2, 3), (0, 1))
        # (nt_local, nfreq, nbl, nfeeds, nfeeds); returned as one stacked
        # (2, ...) real array: one transfer for both planes.
        return jnp.stack([jnp.real(vis), jnp.imag(vis)])

    return program
