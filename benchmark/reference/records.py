"""The records' reference: the simulated truth, and a plain reader of the
VCF files the program wrote.

A perfect caller writes, for every truth site, one PASS record with its
allele and its genotype, and no other PASS record. The comparison counts
how far the written records fall short of that: germline recall and
genotype concordance (in the first sample, the normal where there is one),
precision over every PASS record, and somatic recall where the
configuration has a clone. A SNV matches a record at its own position with
its base among the alternatives; an indel, one whose alternative changes
the length by as much, anchored within 5 bp (a left shift in a repeat).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from ..simulate import ACGT, Site

TOLERANCE = 5


@dataclass
class Record:
    pos: int                    # 0-based
    ref: str
    alts: list
    filters: list
    info: str
    genotypes: list             # one allele list a sample, None for "."


def read_vcf(path: str) -> list:
    """The records of a VCF file (plain text)."""
    out = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 8:
                continue
            fmt = f[8].split(":") if len(f) > 8 else []
            genotypes = []
            for col in f[9:]:
                values = dict(zip(fmt, col.split(":")))
                gt = values.get("GT")
                alleles = ([None if a == "." else int(a)
                            for a in re.split(r"[/|]", gt)] if gt else None)
                genotypes.append(alleles)
            out.append(Record(int(f[1]) - 1, f[3], f[4].split(","),
                              f[6].split(";"), f[7], genotypes))
    return out


def _is_variant(alt: str) -> bool:
    return alt not in (".", "*") and not alt.startswith("<")


def _matching_allele(site: Site, rec: Record, reference: np.ndarray) -> int:
    """Index (1-based) of rec's alternative that is site's allele, or 0."""
    for k, alt in enumerate(rec.alts, start=1):
        if not _is_variant(alt):
            continue
        if site.kind == "snv":
            if (rec.pos == site.pos and len(rec.ref) == 1 and len(alt) == 1
                    and alt == chr(ACGT[site.alt])):
                return k
            continue
        delta = len(alt) - len(rec.ref)
        want = -site.alt if site.kind == "del" else len(site.alt)
        anchor = site.pos - 1 if site.kind == "del" else site.pos
        if delta == want and abs(rec.pos - anchor) <= TOLERANCE:
            return k
    return 0


def _is_somatic(rec: Record) -> bool:
    return "SOMATIC" in rec.info.split(";")


def compare(records: list, sites: list, regions: list,
            reference: np.ndarray) -> dict:
    """Counts of one pass over `regions` [(begin, end)]: the truth sites
    inside them against every record written for them."""
    inside = [s for s in sites
              if any(b <= s.pos < e for b, e in regions)]
    passing = [r for r in records if r.filters == ["PASS"]
               and any(_is_variant(a) for a in r.alts)]
    by_pos = sorted(passing, key=lambda r: r.pos)
    positions = np.asarray([r.pos for r in by_pos], np.int64)
    used = np.zeros(len(by_pos), bool)
    counts = dict(germline=0, found=0, genotype_ok=0, somatic=0,
                  somatic_found=0, records=len(by_pos), true_records=0)
    for s in inside:
        lo = np.searchsorted(positions, s.pos - TOLERANCE - 1, side="left")
        hi = np.searchsorted(positions, s.pos + TOLERANCE + 1, side="right")
        hit, allele = None, 0
        for j in range(lo, hi):
            allele = _matching_allele(s, by_pos[j], reference)
            if allele and (not s.somatic or _is_somatic(by_pos[j])):
                hit = j
                break
        if s.somatic:
            counts["somatic"] += 1
            counts["somatic_found"] += hit is not None
        else:
            counts["germline"] += 1
            if hit is not None:
                counts["found"] += 1
                gt = by_pos[hit].genotypes[0] if by_pos[hit].genotypes else None
                want = [allele] * 2 if s.zygosity == "hom" else [0, allele]
                counts["genotype_ok"] += bool(gt) and sorted(
                    a if a is not None else -1 for a in gt) == want
        if hit is not None:
            used[hit] = True
    counts["true_records"] = int(used.sum())
    return counts


def shares(counts: dict) -> dict:
    """The compared numbers from summed counts."""
    out = {
        "recall": counts["found"] / max(counts["germline"], 1),
        "precision": counts["true_records"] / max(counts["records"], 1),
        "genotype": counts["genotype_ok"] / max(counts["found"], 1),
    }
    if counts["somatic"]:
        out["somatic_recall"] = counts["somatic_found"] / counts["somatic"]
    return out


__all__ = ["Record", "read_vcf", "compare", "shares", "TOLERANCE"]
