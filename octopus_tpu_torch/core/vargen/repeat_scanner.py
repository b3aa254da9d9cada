"""Tandem-repeat-aware candidate proposals.

Capability-equivalent to the reference's RepeatScanner
(src/core/tools/vargen/repeat_scanner.{hpp,cpp}): inside reference short
tandem repeats, indel observations are normalised to the repeat's left
boundary (mappers place them inconsistently across the tract) and proposed
as motif-periodic candidates when enough reads show length-change evidence
(min_snvs=1 / min_vaf defaults from option_collation.cpp:1300-1306).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...basics import cigar as cg
from ...basics.reads import ReadBatch
from ...utils.tandem import extract_exact_tandem_repeats_arrays
from ..types.variants import Variant, left_align


@dataclass
class RepeatScannerOptions:
    max_period: int = 6
    min_tract_length: int = 8
    min_observations: int = 2
    min_vaf: float = 0.1


class RepeatScanner:
    def __init__(self, reference, contig: str,
                 options: RepeatScannerOptions | None = None):
        self.reference = reference
        self.contig = contig
        self.options = options or RepeatScannerOptions()

    def generate(self, batch: ReadBatch, begin: int, end: int) -> list[Variant]:
        opt = self.options
        ref_codes = self.reference.fetch_codes(self.contig, begin, end)
        reps = extract_exact_tandem_repeats_arrays(ref_codes, 1,
                                                   opt.max_period)
        reps = reps[reps[:, 1] >= opt.min_tract_length]
        if not len(reps):
            return []
        fetch = lambda b, e: self.reference.fetch_codes(self.contig, b, e)
        out: dict[Variant, int] = {}
        depth_of: dict[tuple[int, int], int] = {}
        # only reads whose CIGAR carries an indel can propose here; filter
        # once up front (typically a few % of reads) before the per-repeat
        # python walks
        has_id = (batch.cigar_ops[:, 1] == cg.I) | (batch.cigar_ops[:, 1] == cg.D)
        if len(batch.cigar_offsets) > 1:
            per_read = np.add.reduceat(
                np.concatenate([has_id.astype(np.int64), [0]]),
                np.minimum(batch.cigar_offsets[:-1], len(has_id)))
            # reads with empty cigars alias the next read's slot; mask them
            empty = np.diff(batch.cigar_offsets) == 0
            per_read = np.where(empty, 0, per_read[:len(batch)])
            indel_reads = batch.take(np.flatnonzero(per_read > 0))
        else:
            indel_reads = batch
        # reads over each tract: those that begin before its end less those
        # that end at or before its start (a read ends where or after it begins)
        tract_begins = begin + reps[:, 0].astype(np.int64)
        depths = (np.searchsorted(np.sort(batch.begins), tract_begins + reps[:, 1], "left")
                  - np.searchsorted(np.sort(batch.ends), tract_begins, "right")).tolist()
        for (r_pos, r_length, r_period), depth in zip(reps, depths):
            tract = (begin + int(r_pos), begin + int(r_pos) + int(r_length))
            depth_of[tract] = depth
            for i in np.flatnonzero((indel_reads.begins < tract[1])
                                    & (indel_reads.ends > tract[0])).tolist():
                pos = int(indel_reads.begins[i])
                q = 0
                seq = indel_reads.sequence(i)
                for length, op in indel_reads.cigar(i):
                    length = int(length)
                    if op in (cg.M, cg.EQ, cg.X):
                        pos += length
                        q += length
                    elif op == cg.I:
                        if tract[0] <= pos < tract[1] and length % int(r_period) == 0:
                            v = Variant.make(tract[0], np.zeros(0, np.uint8),
                                             seq[q:q + length])
                            v = left_align(v, fetch)
                            out[v] = out.get(v, 0) + 1
                        q += length
                    elif op == cg.D:
                        if tract[0] <= pos < tract[1] and length % int(r_period) == 0 \
                                and pos + length <= tract[1]:
                            ref_seg = self.reference.fetch_codes(
                                self.contig, tract[0], tract[0] + length)
                            v = Variant.make(tract[0], ref_seg, np.zeros(0, np.uint8))
                            v = left_align(v, fetch)
                            out[v] = out.get(v, 0) + 1
                        pos += length
                    elif op == cg.S:
                        q += length
                    elif op in (cg.NSKIP, cg.P):
                        pos += length
        result = []
        for v, support in out.items():
            tract = next((t for t in depth_of
                          if t[0] <= v.begin < t[1] or v.begin <= t[0] < v.end
                          or abs(v.begin - t[0]) <= 2), None)
            depth = depth_of.get(tract, support)
            if support >= self.options.min_observations and \
                    support / max(depth, 1) >= self.options.min_vaf:
                result.append(v)
        return sorted(result, key=lambda v: (v.begin, v.end, v.alt))


__all__ = ["RepeatScanner", "RepeatScannerOptions"]
