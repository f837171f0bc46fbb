"""JAX beam evaluator: the public BeamEvaluator implementation.

API parity with the reference's CPUBeamEvaluator (ref cpu/beams.py:9-127),
including the matvis-style ``interp`` bridge inherited from the ABC. The
engine itself does not route through this class (beams compile to jitted
closures; see beams/interface.py), but ``create_beam_evaluator`` returns one
for host-side workflows and tests.
"""

from __future__ import annotations

import numpy as np

from ..beams.interface import BeamInterface
from ..core.beams import BeamEvaluator, plan_beam_pairs


class TPUBeamEvaluator(BeamEvaluator):
    """Evaluate beams via the JAX interpolation kernels (host-facing)."""

    def evaluate_beam(
        self,
        beam,
        az: np.ndarray,
        za: np.ndarray,
        polarized: bool,
        freq: float,
        check: bool = False,
        spline_opts: dict | None = None,
        interpolation_function: str = "az_za_map_coordinates",
    ) -> np.ndarray:
        self.polarized = polarized
        self.freq = freq
        self.spline_opts = spline_opts or {}

        bi = beam if isinstance(beam, BeamInterface) else BeamInterface(beam)
        resp = bi.compute_response(
            np.asarray(az),
            np.asarray(za),
            np.atleast_1d(freq),
            spline_opts=spline_opts,
            interpolation_function=interpolation_function,
        )
        if polarized:
            out = resp[:, :, 0, :]
        else:
            out = resp[0, 0, 0, :].real

        if check:
            total = np.sum(out)
            if np.isinf(total) or np.isnan(total):
                raise ValueError("Beam interpolation resulted in an invalid value")
        return out

    @staticmethod
    def prepare_beam_evaluation(antnums, baselines, beam_idx):
        """Beam-pair routing (API parity; ref cpu/beams.py:91-127)."""
        plan = plan_beam_pairs(antnums, baselines, beam_idx)
        pair_to_idxs = {p: list(map(int, s)) for p, s in zip(plan.pairs, plan.bls_idxs)}
        pair_to_flip = {p: list(map(bool, f)) for p, f in zip(plan.pairs, plan.flipped)}
        return list(plan.pairs), pair_to_idxs, pair_to_flip

    def get_apparent_flux_polarized(self, beam: np.ndarray, flux: np.ndarray):
        """A^H diag(flux) A, in place on ``beam`` (ref cpu/beams.py:129-145)."""
        out = np.einsum("afs,s,ags->fgs", beam.conj(), flux, beam)
        beam[...] = out
        return beam
