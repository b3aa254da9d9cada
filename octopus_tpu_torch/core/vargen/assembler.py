"""Local de-Bruijn reassembly candidate generation.

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
section 2.14 item 7): the graph, its bubbles and the alignment of bubble
vs reference run in the host extension.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# native graph build, bubble search and alignment (csrc/octopus_native.cpp),
# built at first use
from ..._build import NATIVE as _native

from ...basics.reads import ReadBatch
from ...basics.sequence import decode_sequence, encode_sequence
from ..types.variants import Variant, left_align


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


def assemble_bubbles(ref_bytes: bytes, masked_reads: list[bytes], k: int,
                     opt: "AssemblerOptions"):
    """Graph build + prune + bubble search for one bin at one kmer size, in
    the host extension (extract_bubbles).

    Returns the (start_i, end_i, alt_bytes, score) bubble list, or None when
    the reference is ambiguous at this k (duplicate (k-1)-mers).
    """
    return _native.extract_bubbles(
        ref_bytes, masked_reads, k, opt.min_kmer_observations,
        opt.max_bubbles, float(opt.min_bubble_score),
        opt.max_path_extension, opt.max_search_steps)


# ---------------------------------------------------------------------------
# Affine-gap global alignment (GlobalAligner equivalent)
# ---------------------------------------------------------------------------

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


def variants_from_alignment(ref_begin: int, ref: np.ndarray, alt: np.ndarray,
                            ops: list[tuple[int, str]],
                            max_size: int) -> list[Variant]:
    out = []
    ri = bi = 0
    for length, op in ops:
        if op == "M":
            for k in range(length):
                if ref[ri + k] != alt[bi + k]:
                    out.append(Variant.make(ref_begin + ri + k,
                                            ref[ri + k:ri + k + 1],
                                            alt[bi + k:bi + k + 1]))
            ri += length
            bi += length
        elif op == "D":
            if length <= max_size:
                out.append(Variant.make(ref_begin + ri, ref[ri:ri + length],
                                        np.zeros(0, np.uint8)))
            ri += length
        else:  # I
            if length <= max_size:
                out.append(Variant.make(ref_begin + ri, np.zeros(0, np.uint8),
                                        alt[bi:bi + length]))
            bi += length
    return out


class LocalReassembler:
    """Per-bin de-Bruijn candidate generation over a read batch."""

    def __init__(self, reference, contig: str,
                 options: AssemblerOptions | None = None):
        self.reference = reference
        self.contig = contig
        self.options = options or AssemblerOptions()

    def generate(self, batch: ReadBatch, region_begin: int,
                 region_end: int) -> list[Variant]:
        opt = self.options
        out: dict[Variant, None] = {}
        step = opt.bin_size - opt.bin_overlap
        interesting = self._interesting_reads(batch)
        # clustered trigger (TriggerType::clustered): reads whose aligned
        # bases mismatch the reference >= 2 times — how assembly-only events
        # (e.g. deletions aligned as full-M reads) present
        dense = self._mismatch_dense_reads(batch, region_begin, region_end)
        # sanity guard: genuine clustered variants make a LOCAL subset of
        # reads mismatch-dense; when the majority of a whole region's
        # M-cigar reads disagree with the reference everywhere (wrong
        # reference build, contamination, unalignable sequence), assembling
        # every bin just manufactures noise bubbles and burns minutes —
        # suppress the clustered trigger and keep the indel/clip triggers
        # (round-4 probe: a wrong-reference run spent 4 min on a 2 kb
        # window producing 59 junk candidates).  The absolute-count floor
        # keeps genuine assembly-only structural events (a hom deletion
        # makes most reads of its SMALL locality dense) out of the guard.
        if (len(batch) and float(dense.mean()) > 0.5
                and int(dense.sum()) >= 256):
            import logging
            logging.getLogger("octopus_tpu_torch").warning(
                "assembler: %d/%d reads in %s:%d-%d are mismatch-dense "
                "against the reference — suppressing the clustered assembly "
                "trigger (wrong reference or unalignable region?)",
                int(dense.sum()), len(batch), self.contig, region_begin,
                region_end)
        else:
            interesting |= dense
        pos = region_begin
        while pos < region_end:
            bin_end = min(pos + opt.bin_size, region_end)
            sel = (batch.begins < bin_end) & (batch.ends > pos)
            n_over = int(sel.sum())
            n_int = int((sel & interesting).sum())
            # assemble only signal-bearing bins, as the reference's
            # AssemblerActiveRegionGenerator does (default triggers: reads
            # with indels or good soft clips at >= min_expected_mutation_
            # frequency of local coverage; assembler_active_region_
            # generator.hpp Options)
            if opt.assemble_all and n_over >= 2:
                over = batch.take(sel)
                for v in self._assemble_bin(over, pos, bin_end):
                    out.setdefault(v)
            elif n_over >= 2 and n_int >= max(2.0, 0.05 * n_over):
                over = batch.take(sel)
                for v in self._assemble_bin(over, pos, bin_end):
                    out.setdefault(v)
            pos += step
        return sorted(out, key=lambda v: (v.begin, v.end, v.alt))

    @staticmethod
    def _interesting_reads(batch: ReadBatch) -> np.ndarray:
        """Reads that can contribute assembly-only candidates: CIGARs with
        indel ops or soft clips of >= 2 bases (TriggerType::indel)."""
        from ...basics import cigar as cg
        ops = batch.cigar_ops
        is_indel = (ops[:, 1] == cg.I) | (ops[:, 1] == cg.D)
        is_clip = (ops[:, 1] == cg.S) & (ops[:, 0] >= 2)
        flag_op = is_indel | is_clip
        # reduce ragged op flags to per-read any()
        read_of = np.searchsorted(batch.cigar_offsets,
                                  np.arange(len(ops)), side="right") - 1
        out = np.zeros(len(batch), bool)
        np.logical_or.at(out, read_of, flag_op)
        return out

    def _mismatch_dense_reads(self, batch: ReadBatch, region_begin: int,
                              region_end: int, min_mismatches: int = 2) -> np.ndarray:
        n = len(batch)
        out = np.zeros(n, bool)
        if n == 0:
            return out
        lo = max(int(batch.begins.min()), 0)
        hi = min(int(batch.ends.max()), self.reference.contig_size(self.contig))
        if hi <= lo:
            return out
        ref = self.reference.fetch_codes(self.contig, lo, hi)
        lens = batch.lengths()
        n_ops = np.diff(batch.cigar_offsets)
        # common case: single-op all-M reads, compared in one flat gather
        from ...basics import cigar as cg
        simple = ((n_ops == 1)
                  & (batch.cigar_ops[batch.cigar_offsets[:-1], 1] == cg.M))
        idx = np.flatnonzero(simple)
        if len(idx):
            starts = batch.seq_offsets[idx]
            L = int(lens[idx].max())
            col = np.arange(L)
            valid = col[None, :] < lens[idx][:, None]
            seq = batch.seq[starts[:, None] + np.minimum(col, lens[idx][:, None] - 1)]
            rpos = (batch.begins[idx][:, None] - lo) + col
            rpos_c = np.clip(rpos, 0, len(ref) - 1)
            mism = (seq != ref[rpos_c]) & valid & (rpos >= 0) & (rpos < len(ref))
            out[idx] = mism.sum(axis=1) >= min_mismatches
        # reads with complex cigars were caught by the indel/clip trigger
        return out

    def _assemble_bin(self, batch: ReadBatch, begin: int, end: int) -> list[Variant]:
        opt = self.options
        pad = max(opt.kmer_sizes)
        ref_begin = max(begin - pad, 0)
        ref_end = min(end + pad, self.reference.contig_size(self.contig))
        ref_codes = self.reference.fetch_codes(self.contig, ref_begin, ref_end)
        ref_bytes = ref_codes.tobytes()
        masked_reads = []
        for i in range(len(batch)):
            seq = batch.sequence(i).copy()
            seq[batch.qualities(i) < opt.mask_threshold] = 4
            masked_reads.append(seq.tobytes())
        per_k: dict[int, list[Variant]] = {}
        # default sizes first; if every default k is ambiguous on this bin,
        # grow k through the fallback ladder until one succeeds
        # (local_reassembler.cpp:38-49 generate_fallback_kmer_sizes)
        fallbacks = [max(opt.kmer_sizes) + (i + 1) * opt.fallback_interval_size
                     for i in range(opt.num_fallbacks)]
        fetch = lambda b, e: self.reference.fetch_codes(self.contig, b, e)
        for tier, k in enumerate([*opt.kmer_sizes, *fallbacks]):
            if tier >= len(opt.kmer_sizes) and per_k:
                break
            if len(ref_bytes) < k + 1:
                continue
            bubbles = assemble_bubbles(ref_bytes, masked_reads, k, opt)
            if bubbles is None:
                continue
            got: list[Variant] = []
            for start_i, end_i, alt_bytes, score in bubbles:
                # reference segment covered by the bubble: ref node span is
                # positions [start_i, end_i + k - 1)
                seg_begin = start_i
                seg_end = end_i + k - 1
                ref_seg = ref_codes[seg_begin:seg_end]
                alt_seg = np.frombuffer(alt_bytes, np.uint8)
                if np.array_equal(ref_seg, alt_seg):
                    continue
                ops = global_align(ref_seg, alt_seg)
                vs = variants_from_alignment(ref_begin + seg_begin, ref_seg,
                                             alt_seg, ops, opt.max_variant_size)
                for v in vs:
                    if v.is_indel():
                        v = left_align(v, fetch)
                    got.append(v)
            per_k[k] = got
        if not per_k:
            return []
        if len(per_k) == 1:
            return next(iter(per_k.values()))
        # cross-k confirmation: at small k, (k-1)-mers shared between
        # distant loci can glue long phantom bubbles out of real reads'
        # divergent paths (round-4 10 Mb heavy tail: a k=10-only 548 bp
        # phantom decomposed into 9 junk deletions + SNVs and exploded the
        # haplotype beam). A real event survives at every k that can hold
        # its junction context, so keep the LARGEST k's variants plus any
        # variant confirmed by >= 2 kmer sizes.
        key = lambda v: (v.begin, v.end, bytes(v.ref), bytes(v.alt))
        counts: dict = {}
        for vs in per_k.values():
            for kv in {key(v) for v in vs}:
                counts[kv] = counts.get(kv, 0) + 1
        out: list[Variant] = list(per_k[max(per_k)])
        seen = {key(v) for v in out}
        for k, vs in per_k.items():
            for v in vs:
                if counts[key(v)] >= 2 and key(v) not in seen:
                    seen.add(key(v))
                    out.append(v)
        return out


__all__ = [
    "LocalReassembler",
    "AssemblerOptions",
    "assemble_bubbles",
    "global_align",
    "variants_from_alignment",
]
