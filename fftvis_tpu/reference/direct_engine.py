"""Exact direct-summation oracle engine (NumPy, float64).

The reference validates against matvis, an independent direct-DFT simulator
(ref tests/test_cpu_simulate.py:137-144). matvis is not available here, so
this module IS the in-repo oracle: a deliberately simple, loop-clear NumPy
implementation of the measurement equation

    V_(ai,aj)(nu, t) = sum_{s above horizon}
        transpose( A_i'^H(s) C(s) A_j'(s) ) * exp(+2 pi i nu (r_j - r_i).x_s / c)

with the same conventions the reference realizes through finufft + its
coherency kernels: baseline vector r_j - r_i (ref cpu_simulate.py:650),
isign=+1 (finufft default), the vector-component flip for polarized sky
models (ref cpu_simulate.py:145-156), and the final (f1, f2) transpose
(ref cpu_simulate.py:300).

It shares ONLY the coordinate and beam modules with the JAX engine; the
transform math is written independently so pipeline bugs cannot cancel.
"""

from __future__ import annotations

import numpy as np

from ..beams.interface import BeamInterface, prepare_beam_unpolarized
from ..coords.rotation import SourceRotation, enu_to_az_za
from ..core import coherency as coh_mod
from ..core import utils as core_utils
from ..core.beams import plan_beam_pairs
from ..core.simulate import SimulationEngine
from ..core.utils import speed_of_light


class DirectSimulationEngine(SimulationEngine):
    """Exact (O(nsrc * nbl)) oracle engine."""

    def simulate(
        self,
        ants: dict,
        freqs: np.ndarray,
        fluxes: np.ndarray,
        beam_list: list,
        ra: np.ndarray,
        dec: np.ndarray,
        times,
        telescope_loc,
        baselines: list | None = None,
        beam_idx: np.ndarray | None = None,
        precision: int = 2,
        polarized: bool = False,
        eps: float | None = None,
        upsample_factor=2,
        beam_spline_opts: dict | None = None,
        flat_array_tol: float = 1e-6,
        interpolation_function: str = "az_za_map_coordinates",
        nprocesses=1,
        nthreads=None,
        coord_method: str = "CoordinateRotationERFA",
        coord_method_params: dict | None = None,
        force_use_ray: bool = False,
        force_use_type3: bool = False,
        trace_mem: bool = False,
        enable_memory_monitor: bool = False,
        nchunks: int = 1,
        source_buffer: float = 1.0,
        beam_coefs: np.ndarray | None = None,
    ) -> np.ndarray:
        del eps, upsample_factor, force_use_type3  # exact path
        freqs = np.atleast_1d(np.asarray(freqs, dtype=float))
        nfreqs = freqs.size

        beam_idx = core_utils.validate_beam_idx(
            beam_idx, beam_coefs, len(beam_list), len(ants)
        )
        if baselines is None:
            reds = core_utils.get_pos_reds(ants, include_autos=True)
            baselines = [red[0] for red in reds]
        nbl = len(baselines)
        nfeeds = 2 if polarized else 1

        coherency, polarized_sky = coh_mod.prepare_source_catalog(
            np.asarray(fluxes), polarized_beam=polarized
        )

        rot = SourceRotation(
            ra, dec, times, telescope_loc, coord_method=coord_method
        )
        topo_all = rot.topo_all_times()  # (nt, 3, nsrc) float64
        ntimes = topo_all.shape[0]

        antnums = list(ants.keys())
        pos = {a: np.asarray(ants[a], dtype=float) for a in antnums}
        blvec = np.array([pos[aj] - pos[ai] for ai, aj in baselines]).T  # (3, nbl)

        use_basis = beam_coefs is not None
        if use_basis:
            ant1 = np.array([antnums.index(b[0]) for b in baselines])
            ant2 = np.array([antnums.index(b[1]) for b in baselines])

        # Normalize beams: interfaces, power conversion for unpolarized.
        prepared_beams = []
        for b in beam_list:
            bi = b if isinstance(b, BeamInterface) else BeamInterface(b)
            if not polarized and bi.beam_type != "power":
                bi = prepare_beam_unpolarized(bi)
            prepared_beams.append(bi)

        pair_plan = None
        if not use_basis:
            pair_plan = plan_beam_pairs(antnums, baselines, beam_idx)

        vis = np.zeros((nfreqs, ntimes, nfeeds, nfeeds, nbl), dtype=np.complex128)

        for ti in range(ntimes):
            topo = topo_all[ti]
            up = topo[2] > 0
            if not np.any(up):
                continue
            tsel = topo[:, up]
            az, za = enu_to_az_za(tsel[0], tsel[1], orientation="uvbeam")
            coh_t = coherency[up]  # (nsrc_up, nfreq[, 2, 2])

            for fi, freq in enumerate(freqs):
                evals = [
                    _eval_beam_host(
                        bi, az, za, freq, polarized, beam_spline_opts,
                        interpolation_function,
                    )
                    for bi in prepared_beams
                ]
                # Phase matrix: (nsrc_up, nbl)
                phase = (2j * np.pi * freq / speed_of_light) * (tsel.T @ blvec)
                fringe = np.exp(phase)

                if use_basis:
                    vis[fi, ti] += _basis_vis(
                        evals, coh_t, fi, beam_coefs, ant1, ant2, fringe,
                        polarized_sky,
                    )
                    continue

                for p, (bi_idx, bj_idx) in enumerate(pair_plan.pairs):
                    rows = _coherency_rows_np(
                        evals[bi_idx], evals[bj_idx],
                        coh_t[:, fi] if coh_t.ndim >= 2 else coh_t,
                        polarized, polarized_sky,
                    )  # (nfeeds^2, nsrc_up)
                    sel = pair_plan.bls_idxs[p]
                    flip = pair_plan.flipped[p]
                    fr = fringe[:, sel]
                    fr = np.where(flip[None, :], np.conj(fr), fr)
                    v = rows @ fr  # (nfeeds^2, nbl_p)
                    v = np.where(flip[None, :], np.conj(v), v)
                    # (f1, f2, nbl_p) -> transpose feed axes (ref :300).
                    v = v.reshape(nfeeds, nfeeds, -1)
                    vis[fi, ti, :, :, sel] += np.moveaxis(v, -1, 0).swapaxes(1, 2)

        if polarized:
            return vis  # (nfreq, ntime, 2, 2, nbl)
        return vis[:, :, 0, 0, :]  # (nfreq, ntime, nbl)


def _eval_beam_host(bi, az, za, freq, polarized, spline_opts, interp_fn):
    """Evaluate one beam on host; (2,2,nsrc) complex or (nsrc,) real."""
    resp = bi.compute_response(
        az, za, np.atleast_1d(freq),
        spline_opts=spline_opts, interpolation_function=interp_fn,
    )
    if polarized:
        return resp[:, :, 0, :]
    return resp[0, 0, 0, :].real


def _coherency_rows_np(e_i, e_j, flux, polarized, polarized_sky):
    """NumPy mirror of coherency.apparent_coherency_rows (independent impl)."""
    if polarized and polarized_sky:
        ai = e_i[::-1]  # flip vector-component axis
        aj = e_j[::-1]
        coh = np.moveaxis(flux, 0, -1)  # (2, 2, nsrc)
        out = np.einsum("afs,abs,bgs->fgs", ai.conj(), coh, aj)
        return out.reshape(4, -1)
    if polarized:
        out = np.einsum("afs,ags,s->fgs", e_i.conj(), e_j, flux)
        return out.reshape(4, -1)
    return (np.sqrt(e_i * e_j) * flux)[None, :].astype(np.complex128)


def _basis_vis(evals, coh_t, fi, beam_coefs, ant1, ant2, fringe, polarized_sky):
    """Eigenbeam path: sum over basis pairs, contracted with coefficients
    (independent mirror of ref cpu_simulate.py:303-470)."""
    K = len(evals)
    nbl = fringe.shape[1]
    nfeeds = 2
    out = np.zeros((nfeeds, nfeeds, nbl), dtype=np.complex128)
    c1 = beam_coefs[ant1, :, fi].conj()  # (nbl, K)
    c2 = beam_coefs[ant2, :, fi]
    flux = coh_t[:, fi] if coh_t.ndim >= 2 else coh_t
    for k in range(K):
        for l in range(k, K):
            rows = _coherency_rows_np(evals[k], evals[l], flux, True, polarized_sky)
            v = (rows @ fringe).reshape(nfeeds, nfeeds, nbl)  # (f1, f2, b)
            vt = v.swapaxes(0, 1)  # reference's final transpose
            w_kl = c1[:, k] * c2[:, l]
            out += w_kl[None, None, :] * vt
            if l != k:
                w_lk = c1[:, l] * c2[:, k]
                out += w_lk[None, None, :] * vt.swapaxes(0, 1)
    return out
