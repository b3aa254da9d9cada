"""Sequencing error models: per-haplotype HMM penalty construction.

Capability-equivalent to the reference's error layer
(src/core/models/error/): a repeat-aware SNV error model producing
strand-specific context masks + penalty caps, and a repeat-aware indel error
model producing per-position gap open/extend penalties.  Parameter tables are
keyed by library preparation and sequencer exactly as the reference's
error_model_factory.cpp; the default profile is PCR-free.HiSeq-2500
(src/config/option_parser.cpp:571-573).

All outputs are numpy arrays ready to be packed into device buffers for the
pair-HMM kernel.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# native penalty tracks (csrc/octopus_native.cpp: snv_priors,
# indel_penalties), built at first use
from ..._build import NATIVE as _native

# ---------------------------------------------------------------------------
# Built-in parameter tables (values mirror the reference's
# error_model_factory.cpp builtin_snv_models / builtin_indel_models).
# ---------------------------------------------------------------------------

SNV_PENALTY_CAPS = {
    # library -> (homopolymer, dinucleotide, trinucleotide) caps by run length
    "PCR-FREE": (
        [125,125,60,55,50,30,20,15,12,12,10,10,10,10,8,7,6,6,6,6,6,6,5,5,5,5,5,5,5,5,5,5,5,4,4,4,3,3,3,3,2,2,2,2,2,1,1,1,1,1,1],
        [125,125,60,60,52,52,38,38,22,22,17,17,15,15,13,13,10,10,10,10,8,8,7,6,6,6,6,6,6,5,5,5,5,4,4,4,3,3,3,3,2,2,2,2,2,1,1,1,1,1,1],
        [125,125,125,55,55,55,40,40,40,25,25,25,19,19,19,11,11,11,9,9,9,7,7,6,6,6,6,6,6,5,5,5,5,4,4,4,3,3,3,3,2,2,2,2,2,1,1,1,1,1,1],
    ),
    "PCR": (
        [125,125,60,55,38,23,16,14,11,10,9,8,7,7,6,6,6,6,6,6,6,6,5,5,5,5,5,5,5,5,5,5,5,4,4,4,3,3,3,3,2,2,2,2,2,1,1,1,1,1,1],
        [125,125,60,60,52,52,38,38,22,22,17,17,15,15,13,13,10,10,10,10,8,8,7,6,6,6,6,6,6,5,5,5,5,4,4,4,3,3,3,3,2,2,2,2,2,1,1,1,1,1,1],
        [125,125,125,55,55,55,40,40,40,25,25,25,19,19,19,11,11,11,9,9,9,7,7,6,6,6,6,6,6,5,5,5,5,4,4,4,3,3,3,3,2,2,2,2,2,1,1,1,1,1,1],
    ),
}
SNV_PENALTY_CAPS["10X"] = SNV_PENALTY_CAPS["PCR"]
SNV_PENALTY_CAPS["MDA"] = SNV_PENALTY_CAPS["PCR"]

INDEL_OPEN_PENALTIES = {
    # (library, sequencer) -> (AT homopolymer, CG homopolymer, dinucleotide, trinucleotide)
    ("PCR-FREE", "HISEQ-2500"): (
        [45,45,43,43,41,38,35,32,29,25,21,20,19,18,17,17,16,16,15,14,14,13,12,12,11,10,9,9,8,7,7,7,6,6,6,6,6,6,6,6,6,6,6,6,6,6,6,6,6,5],
        [45,45,45,41,39,34,30,24,21,18,15,13,12,10,8,7,7,6,6,6,6,6,6,5,5,5,5,5,5,5,5,5,5,5,5,5,5,5,5,5,3],
        [45,45,42,40,35,29,26,24,22,21,20,19,18,18,17,17,16,16,15,15,15,14,13,13,12,12,11,11,10,10,9,9,9,7,7,7,6,6,5,4,4,4,4,4,4,4,4,4,3],
        [45,45,40,36,30,28,26,25,23,22,22,22,21,21,20,20,20,18,17,16,14,14,14,14,12,11,11,11,10,10,10,7,7,7,4,4,4,4,4,4,4,3],
    ),
    ("PCR", "HISEQ-2500"): (
        [45,45,43,41,40,36,34,30,24,20,16,13,12,11,10,10,9,9,8,8,7,7,7,6,6,6,6,5,5,5,4,4,4,4,4,4,4,4,4,4,3],
        [45,45,42,40,37,33,27,21,17,15,12,10,9,7,6,6,5,5,4,4,4,4,4,4,4,3],
        [45,45,38,37,32,26,21,18,16,14,14,13,13,12,12,11,11,11,10,10,10,9,9,9,8,8,7,7,7,7,6,6,6,5,5,4,4,4,4,4,4,4,3],
        [45,45,37,32,26,22,20,19,18,17,17,16,15,15,14,13,13,12,12,12,12,10,10,10,9,9,7,7,7,7,6,6,6,6,4,3],
    ),
}

INDEL_EXTEND_PENALTIES = {
    # defaults from BasicRepeatBasedIndelErrorModel::Parameters
    "homopolymer": [3, 3, 3, 3, 3, 3, 4, 5, 6, 6, 8, 8, 7, 6, 5, 4, 3],
    "dinucleotide": [3, 3, 5, 4, 3, 2],
    "trinucleotide": [3, 3, 5, 4, 3, 2],
}

DEFAULT_MODEL_LABEL = "PCR-FREE.HISEQ-2500"


# ---------------------------------------------------------------------------
# SNV error model
# ---------------------------------------------------------------------------

@dataclass
class SnvErrorResult:
    forward_mask: np.ndarray    # uint8 codes, previous base (wrapped)
    forward_priors: np.ndarray  # int16 penalty caps
    reverse_mask: np.ndarray    # uint8 codes, next base (wrapped)
    reverse_priors: np.ndarray  # int16 penalty caps


class RepeatBasedSnvErrorModel:
    """Strand-specific SNV penalty caps in tandem-repeat context.

    Mirrors BasicRepeatBasedSNVErrorModel
    (src/core/models/error/repeat_based_snv_error_model.cpp): penalty caps
    apply just *after* repeat tracts in read direction; the context mask is
    the neighbouring haplotype base; substituted haplotype positions are
    exempted from caps.
    """

    def __init__(self, library: str = "PCR-FREE"):
        caps = SNV_PENALTY_CAPS[library.upper()]
        self._caps_arr = [np.asarray(c, dtype=np.int16) for c in caps]
        self.max_quality = caps[0][0]

    def evaluate(self, codes: np.ndarray, substitution_mask: np.ndarray | None = None) -> SnvErrorResult:
        sub = (np.ascontiguousarray(substitution_mask, np.uint8).tobytes()
               if substitution_mask is not None and substitution_mask.any()
               else b"")
        fwd_b, rev_b = _native.snv_priors(
            np.ascontiguousarray(codes, np.uint8).tobytes(), sub,
            self.max_quality, *(c.tobytes() for c in self._caps_arr))
        return SnvErrorResult(
            np.roll(codes, 1), np.frombuffer(fwd_b, np.int16).copy(),
            np.roll(codes, -1), np.frombuffer(rev_b, np.int16).copy())


# ---------------------------------------------------------------------------
# Indel error model
# ---------------------------------------------------------------------------

@dataclass
class IndelErrorResult:
    gap_open: np.ndarray    # int16, per position
    gap_extend: np.ndarray  # int16, per position


class RepeatBasedIndelErrorModel:
    """Per-position gap penalties from tandem-repeat context.

    Mirrors BasicRepeatBasedIndelErrorModel + RepeatBasedIndelErrorModel
    (src/core/models/error/): open penalties keyed by motif class and
    periodicity (length // period), min-filled over repeat spans; extend
    penalties filled in order of increasing repeat length.
    """

    def __init__(self, model: str = DEFAULT_MODEL_LABEL):
        library, _, sequencer = model.upper().partition(".")
        key = (library, sequencer or "HISEQ-2500")
        if key not in INDEL_OPEN_PENALTIES:
            key = ("PCR-FREE", "HISEQ-2500")
        at_open, cg_open, di_open, tri_open = INDEL_OPEN_PENALTIES[key]
        self._at_open = list(at_open)
        self._cg_open = list(cg_open)
        self._di_open = list(di_open)
        self._tri_open = list(tri_open)
        self._homo_ext = INDEL_EXTEND_PENALTIES["homopolymer"]
        self._di_ext = INDEL_EXTEND_PENALTIES["dinucleotide"]
        self._tri_ext = INDEL_EXTEND_PENALTIES["trinucleotide"]
        self.default_open = self._di_open[0]
        self.default_extend = self._di_ext[0]

    def set_penalties(self, codes: np.ndarray) -> IndelErrorResult:
        t = lambda xs: np.asarray(xs, np.int16).tobytes()
        open_b, ext_b = _native.indel_penalties(
            np.ascontiguousarray(codes, np.uint8).tobytes(),
            int(self.default_open), int(self.default_extend),
            t(self._at_open), t(self._cg_open), t(self._di_open),
            t(self._tri_open), t(self._homo_ext), t(self._di_ext),
            t(self._tri_ext))
        return IndelErrorResult(np.frombuffer(open_b, np.int16).copy(),
                                np.frombuffer(ext_b, np.int16).copy())


def make_error_models(model: str = DEFAULT_MODEL_LABEL):
    """(snv_model, indel_model) for a 'LIBRARY.SEQUENCER' label.

    PacBio profiles disable the SNV model in the reference; we mirror that by
    returning None for the SNV model."""
    library = model.upper().partition(".")[0]
    sequencer = model.upper().partition(".")[2]
    snv = None if sequencer.startswith("PACBIO") else RepeatBasedSnvErrorModel(
        library if library in SNV_PENALTY_CAPS else "PCR-FREE"
    )
    indel = RepeatBasedIndelErrorModel(model)
    return snv, indel


__all__ = [
    "RepeatBasedSnvErrorModel",
    "RepeatBasedIndelErrorModel",
    "SnvErrorResult",
    "IndelErrorResult",
    "make_error_models",
    "DEFAULT_MODEL_LABEL",
]
