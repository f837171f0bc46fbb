"""Beam evaluator abstraction and beam-pair routing.

Parity targets: BeamEvaluator ABC (ref core/beams.py:10-139) and the
beam-pair -> baseline routing with conjugate-flip bookkeeping
(ref cpu/beams.py:91-127). Routing is pure host planning; its output
(per-pair static index arrays) is baked into the jitted program.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class BeamPairPlan:
    """Static routing of baselines onto unique beam pairs.

    Attributes
    ----------
    pairs
        Unique (beam_i, beam_j) index pairs with i-group <= j-group.
    bls_idxs
        For each pair, the indices of the baselines it covers.
    flipped
        For each pair, a boolean array marking baselines stored as the
        reversed (j, i) orientation: their uvw is negated and the resulting
        visibility conjugated (ref cpu_simulate.py:259-298).
    """

    pairs: tuple
    bls_idxs: tuple
    flipped: tuple

    @property
    def npairs(self) -> int:
        return len(self.pairs)


def plan_beam_pairs(antnums, baselines, beam_idx) -> BeamPairPlan:
    """Group baselines by unique (beam_i, beam_j) pair with flip bookkeeping.

    Matches the reference's routing semantics (ref cpu/beams.py:91-127):
    with a single shared beam everything maps to pair (0, 0) unflipped.
    """
    nbl = len(baselines)
    if beam_idx is None:
        return BeamPairPlan(
            pairs=((0, 0),),
            bls_idxs=(np.arange(nbl),),
            flipped=(np.zeros(nbl, dtype=bool),),
        )

    beam_idx = np.asarray(beam_idx)
    ant_to_beam = {a: int(b) for a, b in zip(antnums, beam_idx)}
    unique = np.unique(beam_idx)
    pair_list = [
        (int(unique[i]), int(unique[j]))
        for i in range(len(unique))
        for j in range(i, len(unique))
    ]
    pair_set = set(pair_list)

    idxs: dict = {p: [] for p in pair_list}
    flips: dict = {p: [] for p in pair_list}
    for k, (ai, aj) in enumerate(baselines):
        bi, bj = ant_to_beam[ai], ant_to_beam[aj]
        if (bi, bj) in pair_set:
            key, flip = (bi, bj), False
        elif (bj, bi) in pair_set:
            key, flip = (bj, bi), True
        else:  # pragma: no cover - unique pairs cover all combinations
            raise ValueError("Beam pair not in beam pair list")
        idxs[key].append(k)
        flips[key].append(flip)

    pairs, bidx, flipped = [], [], []
    for p in pair_list:
        if idxs[p]:
            pairs.append(p)
            bidx.append(np.asarray(idxs[p], dtype=np.int64))
            flipped.append(np.asarray(flips[p], dtype=bool))
    return BeamPairPlan(pairs=tuple(pairs), bls_idxs=tuple(bidx), flipped=tuple(flipped))


class BeamEvaluator(ABC):
    """Abstract beam evaluator (API parity with ref core/beams.py:10).

    The JAX engine does not route beam evaluation through this class in the
    hot path (beams become jitted closures; see
    :func:`fftvis_tpu.beams.interface.prepare_beams`); it exists for the
    public ``create_beam_evaluator`` API and host-side uses.
    """

    def __init__(self, **kwargs):
        self.beam_list = []
        self.beam_idx = None
        self.polarized = False
        self.freq = 0.0
        self.nsrc = 0
        self.spline_opts = {}
        self.precision = 2

    @abstractmethod
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
        """Evaluate one beam at the given az/za/freq (host-facing API)."""

    @abstractmethod
    def get_apparent_flux_polarized(self, beam, flux) -> np.ndarray:
        """Apparent flux A^H diag(flux) A (host-facing API)."""

    def interp(self, tx: np.ndarray, ty: np.ndarray, out: np.ndarray) -> np.ndarray:
        """matvis-style BeamInterpolator bridge (ref core/beams.py:106-139)."""
        from ..coords.rotation import enu_to_az_za

        az, za = enu_to_az_za(np.asarray(tx), np.asarray(ty), orientation="uvbeam")
        self.nsrc = len(az)
        for i, bm in enumerate(self.beam_list):
            vals = self.evaluate_beam(
                bm,
                az,
                za,
                self.polarized,
                self.freq,
                spline_opts=self.spline_opts,
            )
            if self.polarized and vals.ndim == 3:
                out[i] = vals.transpose((1, 0, 2))
            else:
                out[i] = vals
        return out
