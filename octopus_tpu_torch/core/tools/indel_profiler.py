"""Indel error profiling (--data-profile).

Capability-equivalent to the reference's IndelProfiler
(src/core/tools/indel_profiler.{hpp,cpp}, driven by octopus.cpp:1710-1730):
scans reads over reference tandem-repeat context and tallies indel error
observations per (period, periodicity), excluding called variant sites, to a
CSV usable for fitting custom indel error models (the reference's
scripts/profiler.py workflow)."""

from __future__ import annotations

import csv
from collections import defaultdict
from dataclasses import dataclass

import numpy as np

from ...basics import cigar as cg
from ...basics.reads import ReadBatch
from ...utils.tandem import extract_exact_tandem_repeats


@dataclass
class IndelProfile:
    counts: dict    # (period, periodicity) -> [spanning_reads, indel_obs]

    def write_csv(self, path: str) -> None:
        with open(path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["period", "periodicity", "spanning_reads",
                        "indel_observations", "error_rate"])
            for (period, periodicity), (n, k) in sorted(self.counts.items()):
                rate = k / n if n else 0.0
                w.writerow([period, periodicity, n, k, f"{rate:.6g}"])


def profile_indels(reference, contig: str, batch: ReadBatch,
                   begin: int, end: int,
                   called_indel_positions: set[int] | None = None,
                   max_period: int = 5) -> IndelProfile:
    called = called_indel_positions or set()
    ref_codes = reference.fetch_codes(contig, begin, end)
    repeats = extract_exact_tandem_repeats(ref_codes, 1, max_period)
    counts: dict = defaultdict(lambda: [0, 0])
    for r in repeats:
        tract_begin = begin + r.pos
        tract_end = tract_begin + r.length
        if any(tract_begin - 2 <= p <= tract_end + 2 for p in called):
            continue
        periodicity = r.length // r.period
        key = (r.period, min(periodicity, 50))
        over = batch.overlapping(tract_begin, tract_end)
        spanning = 0
        errors = 0
        for i in range(len(over)):
            if over.begins[i] > tract_begin - 2 or over.ends[i] < tract_end + 2:
                continue
            spanning += 1
            pos = int(over.begins[i])
            has_indel = False
            for length, op in over.cigar(i):
                length = int(length)
                if op in (cg.M, cg.EQ, cg.X, cg.NSKIP, cg.P):
                    pos += length
                elif op == cg.D:
                    if tract_begin <= pos < tract_end:
                        has_indel = True
                    pos += length
                elif op == cg.I:
                    if tract_begin <= pos < tract_end:
                        has_indel = True
            errors += has_indel
        counts[key][0] += spanning
        counts[key][1] += errors
    return IndelProfile(dict(counts))


__all__ = ["profile_indels", "IndelProfile"]
