"""Sky coherency formation.

Host side: Stokes -> coherency conversion (parity with ref
cpu/utils.py:26-81). Device side: the apparent-coherency products that the
reference implements as four per-source Numba JIT kernels
(ref cpu/beams.py:129-246) collapse here into batched complex einsums -- a
single contraction over the source axis, preserving the
reference's exact algebra including its axis-0 (vector-component) flip for
polarized sky models (ref cpu_simulate.py:138-156) and row ordering.
"""

from __future__ import annotations

import numpy as np


def classify_sky(sky_model: np.ndarray, polarized_beam: bool) -> bool:
    """Validate a sky model's layout; return whether it is IQUV-polarized.

    Split from :func:`build_coherency` so the engine can key its input cache
    on the RAW flux array and defer the coherency build to cache misses.
    Error messages match the reference (its tests assert on them).
    """
    if sky_model.ndim == 2:
        return False
    if polarized_beam and sky_model.ndim == 3 and sky_model.shape[-1] == 4:
        return True
    if polarized_beam:
        raise ValueError(
            f"polarized_beam=True requires sky_model to be either:\n"
            f"  2D unpolarized, or\n"
            f"  3D with last axis of length 4; "
            f"got ndim={sky_model.ndim}, shape={sky_model.shape}"
        )
    raise ValueError(
        f"polarized_beam=False requires sky_model to be 2D; "
        f"got ndim={sky_model.ndim}, shape={sky_model.shape}"
    )


def build_coherency(sky_model: np.ndarray, polarized_sky: bool) -> np.ndarray:
    """Source coherency: (nsrc, nfreq) Stokes-I or (nsrc, nfreq, 2, 2) IQUV."""
    if not polarized_sky:
        return 0.5 * sky_model
    I, Q, U, V = (sky_model[..., i] for i in range(4))
    return 0.5 * np.stack(
        [
            np.stack([I + Q, U + 1j * V], axis=-1),
            np.stack([U - 1j * V, I - Q], axis=-1),
        ],
        axis=-2,
    )  # (nsrc, nfreq, 2, 2)


def prepare_source_catalog(sky_model: np.ndarray, polarized_beam: bool):
    """Build the source coherency from a Stokes sky model (host).

    Returns ``(coherency, polarized_sky_model)`` where coherency is
    (nsrc, nfreq) for Stokes-I input or (nsrc, nfreq, 2, 2) for IQUV input
    (parity with ref cpu/utils.py:26-81).
    """
    sky_model = np.asarray(sky_model)
    polarized_sky = classify_sky(sky_model, polarized_beam)
    return build_coherency(sky_model, polarized_sky), polarized_sky


def apparent_coherency_rows(e_i, e_j, flux, polarized: bool, polarized_sky: bool):
    """Beam-weighted source coherency for one beam pair, as NUFFT rows.

    Parameters
    ----------
    e_i, e_j
        Jones responses (2 vec, 2 feed, nsrc) complex for polarized beams, or
        (nsrc,) real power responses otherwise.
    flux
        (nsrc,) real flux for an unpolarized sky, or (nsrc, 2, 2) complex
        coherency for a polarized sky (already sliced at one frequency).
    polarized, polarized_sky
        Simulation / sky-model polarization flags.

    Returns
    -------
    (nfeeds**2, nsrc) complex rows ordered (f1, f2) = (00, 01, 10, 11),
    exactly the layout the reference feeds its NUFFT
    (ref cpu_simulate.py:189-202).
    """
    import jax.numpy as jnp

    if polarized and polarized_sky:
        # Reference flips the vector-component axis of both Jones matrices
        # before A_i^H C A_j (ref cpu_simulate.py:145-156).
        ai = jnp.conj(jnp.flip(e_i, axis=0))
        aj = jnp.flip(e_j, axis=0)
        coh = jnp.moveaxis(flux, 0, -1)  # (2, 2, nsrc)
        # Explicit sum over the size-2 vector axes: a dot_general with a
        # 2-long contraction would need layout-transpose copies of every
        # (..., 2, 2, nsrc) operand; the elementwise form fuses.
        out = sum(
            ai[a, :, None, :] * coh[a, b][None, None, :] * aj[b, None, :, :]
            for a in range(2)
            for b in range(2)
        )  # (f, g, nsrc)
    elif polarized:
        eic = jnp.conj(e_i)
        out = (
            eic[0, :, None, :] * e_j[0, None, :, :]
            + eic[1, :, None, :] * e_j[1, None, :, :]
        ) * flux.astype(e_i.dtype)[None, None, :]
    else:
        # Cubic interpolation of a tabulated power beam can overshoot to
        # small negatives near nulls; sqrt(negative) would NaN the whole
        # source reduction. Clamp at zero (the physical floor).
        amp = jnp.sqrt(jnp.maximum(e_i * e_j, 0.0)) * flux
        cdtype = jnp.complex64 if amp.dtype == jnp.float32 else jnp.complex128
        return amp[None, :].astype(cdtype)

    nsrc = out.shape[-1]
    return out.reshape(4, nsrc)


def apparent_coherency_rows_batched(
    evals, idx_i, idx_j, flux, polarized: bool, polarized_sky: bool
):
    """All beam-pair coherency rows in one contraction.

    Batched form of :func:`apparent_coherency_rows`: ``evals`` stacks every
    beam's response ((K, 2, 2, nsrc) complex polarized, (K, nsrc) real
    otherwise) and ``idx_i``/``idx_j`` are static (npairs,) beam indices.
    One einsum replaces npairs small ones -- the per-pair op count is what
    dominates the eigenbeam path (K(K+1)/2 pairs, ref cpu_simulate.py:1030)
    on dispatch-bound accelerators.

    Returns (npairs * nfeeds**2, nsrc) rows in the same (pair-major,
    (f1, f2) = 00,01,10,11) order the per-pair concatenation produces.
    """
    import jax.numpy as jnp

    # K -> P pair expansion. A fancy-index take can lower to a gather
    # fusion that MATERIALIZES the expanded (P, ..., nsrc) arrays; a
    # statically unrolled slice-stack lets XLA fuse the copies into the
    # consumers instead. P is
    # small by construction (K(K+1)/2 or K^2 basis pairs); keep the
    # gather form as a guard for degenerate large-P calls.
    if 0 < len(idx_i) <= 128:
        e_i = jnp.stack([evals[int(i)] for i in idx_i], axis=0)
        e_j = jnp.stack([evals[int(j)] for j in idx_j], axis=0)
    else:
        # Empty pair lists keep the gather form's (0, ..., nsrc) result
        # (jnp.stack rejects empty sequences); large-P calls keep the
        # gather too.
        e_i = evals[np.asarray(idx_i, dtype=int)]
        e_j = evals[np.asarray(idx_j, dtype=int)]
    if polarized and polarized_sky:
        ai = jnp.conj(jnp.flip(e_i, axis=1))
        aj = jnp.flip(e_j, axis=1)
        coh = jnp.moveaxis(flux, 0, -1)  # (2, 2, nsrc)
        # Explicit size-2 contractions (see apparent_coherency_rows): pure
        # elementwise broadcasting, no dot_general layout copies.
        out = sum(
            ai[:, a, :, None, :]
            * coh[a, b][None, None, None, :]
            * aj[:, b, None, :, :]
            for a in range(2)
            for b in range(2)
        )  # (P, f, g, nsrc)
    elif polarized:
        eic = jnp.conj(e_i)
        out = (
            eic[:, 0, :, None, :] * e_j[:, 0, None, :, :]
            + eic[:, 1, :, None, :] * e_j[:, 1, None, :, :]
        ) * flux.astype(e_i.dtype)[None, None, None, :]
    else:
        # See apparent_coherency_rows: clamp cubic-interp overshoot.
        amp = jnp.sqrt(jnp.maximum(e_i * e_j, 0.0)) * flux[None, :]
        cdtype = jnp.complex64 if amp.dtype == jnp.float32 else jnp.complex128
        return amp.astype(cdtype)

    npairs, nsrc = out.shape[0], out.shape[-1]
    return out.reshape(npairs * 4, nsrc)
