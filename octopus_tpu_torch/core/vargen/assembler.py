"""Local de-Bruijn reassembly candidate generation: its options.

Capability-equivalent to the reference's LocalReassembler + Assembler +
GlobalAligner (src/core/tools/vargen/local_reassembler.cpp,
utils/assembler.{hpp,cpp}, utils/global_aligner.cpp): reads are binned
(600 bp bins, 200 bp overlap by CLI default), low-quality bases masked
(quality < 10 -> N), per-bin de-Bruijn graphs built at k in {10, 15, 20};
the reference sequence threads a marked path through the graph; alt bubbles
(paths leaving and rejoining the reference path) are extracted best-first by
support score, aligned back to the reference segment with affine-gap
Needleman-Wunsch, and decomposed into variants <= 5000 bp.

Graphs are per-bin and small, so this is host code by design (SURVEY.md
section 2.14 item 7): the whole reassembler runs in the host extension's
generate_candidates, in the window's one call with the CIGAR scanner
(generator.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# native alignment (csrc/octopus_native.cpp), built at first use
from ..._build import NATIVE as _native


@dataclass
class AssemblerOptions:
    kmer_sizes: tuple[int, ...] = (10, 15, 20)
    bin_size: int = 600
    bin_overlap: int = 200
    mask_threshold: int = 10
    min_kmer_observations: int = 1
    max_bubbles: int = 30
    min_bubble_score: float = 2.0
    max_variant_size: int = 5000
    max_path_extension: int = 700
    # fallback kmer sizes (local_reassembler.cpp:38-49): when every default
    # kmer size fails on a bin (ambiguous reference), grow k from the
    # largest default in `fallback_interval_size` steps, up to
    # `num_fallbacks` attempts (--max-fallback-kmers / --fallback-kmer-gap)
    num_fallbacks: int = 10
    fallback_interval_size: int = 10
    # --assemble-all: assemble every bin, not only signal-bearing ones
    # (option_collation.cpp:1383)
    assemble_all: bool = False
    # total heap-push budget for the best-first bubble search: dense graphs
    # (many weight-tied error branches) can otherwise enumerate simple paths
    # combinatorially. The reference bounds this with Yen k-shortest-paths +
    # graph cleanup (assembler.cpp); we bound total explored states.
    max_search_steps: int = 100_000

    def native_args(self, max_size: int) -> tuple:
        """The assembler's tuple of generate_candidates; `max_size` is the
        largest reference span the generator keeps of its variants."""
        return (np.asarray(self.kmer_sizes, np.int32), int(self.bin_size),
                int(self.bin_overlap), int(self.mask_threshold),
                int(self.min_kmer_observations), int(self.max_bubbles),
                float(self.min_bubble_score), int(self.max_variant_size),
                int(self.max_path_extension), int(self.num_fallbacks),
                int(self.fallback_interval_size), int(bool(self.assemble_all)),
                int(self.max_search_steps), int(max_size))


def global_align(a: np.ndarray, b: np.ndarray, match: int = 2,
                 mismatch: int = -3, gap_open: int = -8,
                 gap_extend: int = -1) -> list[tuple[int, str]]:
    """Needleman-Wunsch with affine gaps, in the host extension; returns
    [(length, op)] with ops M/I/D where I consumes `b` (the alt) and D
    consumes `a` (the ref)."""
    raw = _native.global_align(
        np.ascontiguousarray(a, np.uint8).tobytes(),
        np.ascontiguousarray(b, np.uint8).tobytes(),
        int(match), int(mismatch), int(gap_open), int(gap_extend))
    pairs = np.frombuffer(raw, np.int32).reshape(-1, 2)
    return [(int(l), "MID"[op]) for l, op in pairs]


__all__ = ["AssemblerOptions", "global_align"]
