"""Reference confidence calling (gVCF-style refcall blocks).

Capability-equivalent to the reference's --refcall modes (BLOCKED /
POSITIONAL; caller.cpp call_reference + vcf_record_factory refcall blocks):
non-variant positions receive a reference genotype quality from the pileup
(hom-ref vs heterozygous binomial likelihoods under the sequencing error
rate and a heterozygosity prior), and adjacent positions with quality in the
same band merge into blocks annotated with END.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ...basics import cigar as cg
from ...basics.reads import ReadBatch


@dataclass
class RefcallConfig:
    mode: str = "BLOCKED"            # BLOCKED | POSITIONAL
    block_quality_quantum: int = 10  # band width for block merging
    max_quality: int = 99
    error_rate: float = 0.01
    het_prior: float = 0.001


def pileup_mismatch_counts(batch: ReadBatch, begin: int, end: int,
                           ref_codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(depth, mismatches) arrays over [begin, end)."""
    n = end - begin
    depth = np.zeros(n, np.int64)
    mism = np.zeros(n, np.int64)
    for i in range(len(batch)):
        pos = int(batch.begins[i])
        q = 0
        seq = batch.sequence(i)
        for length, op in batch.cigar(i):
            length = int(length)
            if op in (cg.M, cg.EQ, cg.X):
                lo = max(pos, begin)
                hi = min(pos + length, end)
                if hi > lo:
                    off = lo - begin
                    roff = lo - pos + q
                    depth[off:off + hi - lo] += 1
                    seg = seq[roff:roff + hi - lo]
                    refseg = ref_codes[lo - begin:hi - begin]
                    mism[off:off + hi - lo] += (seg != refseg) & (seg != 4)
                pos += length
                q += length
            elif op == cg.I:
                q += length
            elif op == cg.D:
                lo = max(pos, begin)
                hi = min(pos + length, end)
                if hi > lo:
                    mism[lo - begin:hi - begin] += 1
                pos += length
            elif op == cg.S:
                q += length
            elif op in (cg.NSKIP, cg.P):
                pos += length
    return depth, mism


def reference_qualities(depth: np.ndarray, mism: np.ndarray,
                        cfg: RefcallConfig) -> np.ndarray:
    """Per-position phred quality of the hom-ref call."""
    d = depth.astype(np.float64)
    m = mism.astype(np.float64)
    e = cfg.error_rate
    ln_homref = m * math.log(e) + (d - m) * math.log(1 - e)
    ln_het = d * math.log(0.5)
    ln_prior_het = math.log(cfg.het_prior)
    ln_prior_hom = math.log(1 - cfg.het_prior)
    a = ln_prior_hom + ln_homref
    b = ln_prior_het + ln_het
    hi = np.maximum(a, b)
    p_het = np.exp(b - hi) / (np.exp(a - hi) + np.exp(b - hi))
    with np.errstate(divide="ignore"):
        q = -10 * np.log10(np.clip(p_het, 1e-30, None))
    q[depth == 0] = 0
    return np.clip(q, 0, cfg.max_quality)


@dataclass
class RefBlock:
    begin: int
    end: int
    quality: int
    min_depth: int


def make_refcall_blocks(batch: ReadBatch, begin: int, end: int,
                        ref_codes: np.ndarray,
                        called_mask: np.ndarray,
                        cfg: RefcallConfig | None = None) -> list[RefBlock]:
    """Blocks over positions not covered by variant calls."""
    cfg = cfg or RefcallConfig()
    depth, mism = pileup_mismatch_counts(batch, begin, end, ref_codes)
    quals = reference_qualities(depth, mism, cfg)
    band = (quals // cfg.block_quality_quantum).astype(np.int64)
    if cfg.mode == "POSITIONAL":
        band = np.arange(end - begin)       # one block per position
    out: list[RefBlock] = []
    i = 0
    n = end - begin
    while i < n:
        if called_mask[i] or depth[i] == 0:
            i += 1
            continue
        j = i
        qmin = quals[i]
        dmin = depth[i]
        while (j + 1 < n and not called_mask[j + 1] and depth[j + 1] > 0
               and band[j + 1] == band[i]):
            j += 1
            qmin = min(qmin, quals[j])
            dmin = min(dmin, depth[j])
        out.append(RefBlock(begin + i, begin + j + 1, int(round(qmin)), int(dmin)))
        i = j + 1
    return out


__all__ = ["RefcallConfig", "RefBlock", "make_refcall_blocks",
           "reference_qualities", "pileup_mismatch_counts"]
