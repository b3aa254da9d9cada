"""Call-set-refinement annotation measures.

Capability-equivalent to the reference's CSR measure framework
(src/core/csr/measures/, 56 measures; measure.hpp:24-97), computed from the
pileup over the call site plus call-level info.  Key names match the
reference's VCF fields: AC AD ADP AF AFB AMQ ARF BMC BMF BMQ BQ CC CRF DAD
DAF DC DENOVO DP DPC ER ERS FRF GC GQ GQD ITV MC MF MHL MP MPD MQ MQ0 MQD
MRC MRL NC PLN PP PPD PPP QD QUAL REB REFCALL RSB RTB SB SD SF SHC SMQ
SOMATIC STRL STRP VL.

The reference computes the support and bias families through the
ReadAssignments facet (re-running the HMM for per-haplotype support); so
does this module when a FacetBundle is supplied (the callers' normal path):
AD/ADP/AF/AFB, SB, RTB/REB/RSB, ARF, BMC/BMF/BMQ, MHL and DC all evaluate
over HMM-assigned reads per the reference's definitions
(strand_bias.cpp:34-213 with the Monte-Carlo resampling replaced by a
deterministic grid integral of the same probability, read_tail_bias.cpp,
read_end_bias.cpp, read_side_bias.cpp, base_mismatch_*.cpp).  Without a
bundle the pileup-based fallbacks below apply and the miss is counted
(FACET_MISSES).
"""

from __future__ import annotations

import functools
import logging
import math
from dataclasses import dataclass, field

import numpy as np
from scipy import special as _sp


def _beta_cdf(x, a, b) -> float:
    """Beta CDF via the regularised incomplete beta ufunc (the frozen
    scipy.stats call costs ~100x more in construction overhead)."""
    if x <= 0.0:
        return 0.0
    if x >= 1.0:
        return 1.0
    return float(_sp.betainc(a, b, x))


def _beta_sf(x, a, b) -> float:
    if x <= 0.0:
        return 1.0
    if x >= 1.0:
        return 0.0
    return float(_sp.betainc(b, a, 1.0 - x))

_log = logging.getLogger("octopus_tpu_torch")

# Facet-miss accounting (auditability of forest feature provenance): when a
# facet bundle is absent or its measures raise, the pileup-based fallbacks
# are used and this counter records it; the first few misses are warned.
FACET_MISSES = 0
_FACET_MISS_WARN_LIMIT = 5

from ...basics.reads import (
    FLAG_DUPLICATE,
    FLAG_SUPPLEMENTARY,
    ReadBatch,
)
from ...basics import cigar as cg
from ..likelihood.likelihood_array import ShortHaplotypeError

# what a facet's measures may raise on odd data: a haplotype too short to
# band-align a read (the reference skips such regions), or arithmetic and
# lookups on empty support sets. A scorer, kernel or torch.cuda error is
# none of these and passes through.
_FACET_DATA_ERRORS = (ShortHaplotypeError, ArithmeticError, LookupError)

# native whole-batch site stats (csrc/octopus_native.cpp:site_read_stats),
# built at first use
from ..._build import NATIVE as _native

#: every measure key this module can emit (the reference's 56-measure set)
ALL_MEASURES = (
    "AC", "AD", "ADP", "AF", "AFB", "AMQ", "ARF", "BMC", "BMF", "BMQ", "BQ",
    "CC", "CRF", "DAD", "DAF", "DC", "DENOVO", "DP", "DPC", "ER", "ERS",
    "FRF", "GC", "GQ", "GQD", "ITV", "MC", "MF", "MHL", "MP", "MPD", "MQ",
    "MQ0", "MQD", "MRC", "MRL", "NC", "PLN", "PP", "PPD", "PPP", "QD",
    "QUAL", "REB", "REFCALL", "RSB", "RTB", "SB", "SD", "SF", "SHC", "SMQ",
    "SOMATIC", "STRL", "STRP", "VL",
)

def _is_transversion(ref: int, alt: int) -> bool:
    purine = {0, 2}   # A, G
    return (ref in purine) != (alt in purine)


@dataclass
class SiteContext:
    """Per-call pileup support statistics (one pass over overlapping reads)."""

    depth: int = 0
    alt_depth: int = 0
    assigned_depth: int = 0
    ambiguous: int = 0
    rms_mapping_quality: float = 0.0
    mq0_count: int = 0
    alt_base_qualities: list = field(default_factory=list)
    alt_mapping_qualities: list = field(default_factory=list)
    all_mapping_qualities: list = field(default_factory=list)
    alt_forward: int = 0
    alt_reverse: int = 0
    fwd_depth: int = 0
    rev_depth: int = 0
    clipped: int = 0
    supplementary: int = 0
    duplicates: int = 0
    dup_alt: int = 0
    mismatch_counts: list = field(default_factory=list)    # per read vs ref
    alt_mismatch_counts: list = field(default_factory=list)
    read_lengths: list = field(default_factory=list)
    alt_offsets: list = field(default_factory=list)        # allele pos in read
    misaligned: int = 0


def _equiv_shift_max(ref_codes, ref_begin: int, begin: int, end: int,
                     alt_codes: np.ndarray, is_ins: bool, is_del: bool,
                     max_shift: int = 50) -> int:
    """How far right an indel can shift with an identical haplotype.

    A left-aligned indel inside a tandem repeat is observed at shifted
    anchors in read CIGARs (aligners place it as mapped); support counting
    must accept any equivalent placement (the reference sidesteps this by
    assigning reads to haplotypes, read_assigner.cpp).
    """
    if ref_codes is None or not (is_ins or is_del):
        return 0
    if is_del:
        moving = list(ref_codes[begin - ref_begin:end - ref_begin])
        site_end = end
    else:
        moving = list(alt_codes)
        site_end = begin
    if not moving:
        return 0
    shift = 0
    while shift < max_shift:
        nxt = site_end - ref_begin + shift
        if nxt < 0 or nxt >= len(ref_codes):
            break
        if moving[0] != ref_codes[nxt]:
            break
        moving.append(moving.pop(0))
        shift += 1
    return shift


def _rotations_equal(a: np.ndarray, b: np.ndarray) -> bool:
    if len(a) != len(b):
        return False
    if np.array_equal(a, b):
        return True
    doubled = np.concatenate([b, b])
    n = len(a)
    return any(np.array_equal(a, doubled[s:s + n]) for s in range(1, n))


def _read_supports(batch: ReadBatch, i: int, begin: int, end: int,
                   alt_codes: np.ndarray, is_ins: bool, is_del: bool,
                   shift_max: int = 0):
    """Does read i support the alt? Returns (bool, base_quality, read_offset).

    Indels are matched anywhere in [begin, begin + shift_max] (the repeat
    equivalence range): insertions also accept rotations of the inserted
    sequence, which is what a right-shifted placement looks like.
    """
    seq = batch.sequence(i)
    quals = batch.qualities(i)
    pos = int(batch.begins[i])
    q = 0
    for length, op in batch.cigar(i):
        length = int(length)
        if op in (cg.M, cg.EQ, cg.X):
            if is_ins:
                pass
            elif not is_del and pos <= begin and begin + len(alt_codes) <= pos + length:
                off = q + (begin - pos)
                if np.array_equal(seq[off:off + len(alt_codes)], alt_codes):
                    return True, int(quals[off:off + len(alt_codes)].min()), off
                return False, None, None
            pos += length
            q += length
        elif op == cg.I:
            if (is_ins and begin <= pos <= begin + shift_max
                    and length == len(alt_codes)):
                if _rotations_equal(seq[q:q + length], alt_codes):
                    return True, int(quals[q:q + length].min()), q
            q += length
        elif op == cg.D:
            if (is_del and begin <= pos <= begin + shift_max
                    and length == end - begin):
                return True, None, q
            pos += length
        elif op == cg.S:
            q += length
        elif op in (cg.NSKIP, cg.P):
            pos += length
    return False, None, None


def site_context(batch: ReadBatch, begin: int, end: int, alt_codes: np.ndarray,
                 is_insertion: bool, is_deletion: bool,
                 ref_codes=None, ref_begin: int = 0) -> SiteContext:
    over = batch.overlapping(begin, max(end, begin + 1))
    ctx = SiteContext()
    n = len(over)
    if n == 0:
        return ctx
    is_rev = over.is_reverse()
    mq = over.mapq.astype(np.float64)
    ctx.depth = n
    ctx.assigned_depth = n
    ctx.rms_mapping_quality = float(np.sqrt(np.mean(mq ** 2)))
    ctx.mq0_count = int((over.mapq == 0).sum())
    ctx.fwd_depth = int((~is_rev).sum())
    ctx.rev_depth = int(is_rev.sum())
    ctx.all_mapping_qualities = mq.tolist()
    flags = over.flags
    ctx.supplementary = int(((flags & FLAG_SUPPLEMENTARY) != 0).sum())
    ctx.duplicates = int(((flags & FLAG_DUPLICATE) != 0).sum())
    lens = over.lengths()
    ctx.read_lengths = lens.tolist()
    shift_max = _equiv_shift_max(ref_codes, ref_begin, begin, end, alt_codes,
                                 is_insertion, is_deletion)
    sup_a, bq_a, off_a, mism_a, clip_a = _native_site_stats(
        over, begin, end, alt_codes, is_insertion, is_deletion, shift_max,
        ref_codes, ref_begin)
    ctx.mismatch_counts = mism_a.tolist()
    ctx.misaligned = int((mism_a >= 6).sum())
    ctx.clipped = int(clip_a.sum())
    alt_sel = sup_a.astype(bool)
    ctx.alt_depth = int(alt_sel.sum())
    ctx.alt_mapping_qualities = mq[alt_sel].tolist()
    ctx.alt_mismatch_counts = mism_a[alt_sel].tolist()
    ctx.alt_base_qualities = bq_a[alt_sel & (bq_a >= 0)].tolist()
    off_sel = alt_sel & (off_a >= 0) & (lens > 0)
    ctx.alt_offsets = list(zip(off_a[off_sel].tolist(),
                               lens[off_sel].tolist()))
    ctx.alt_reverse = int((alt_sel & is_rev).sum())
    ctx.alt_forward = int((alt_sel & ~is_rev).sum())
    ctx.dup_alt = int((alt_sel & ((flags & FLAG_DUPLICATE) != 0)).sum())
    return ctx


def _native_site_stats(over: ReadBatch, begin, end, alt_codes, is_ins,
                       is_del, shift_max, ref_codes, ref_begin):
    """Whole-batch per-read support/mismatch stats via the C++ extension
    (csrc/octopus_native.cpp:site_read_stats: each read's support by
    _read_supports' rule, its aligned-base mismatches and clipping)."""
    n = len(over)
    ref_bytes = (np.ascontiguousarray(ref_codes, dtype=np.uint8).tobytes()
                 if ref_codes is not None else b"")
    raw = _native.site_read_stats(
        np.ascontiguousarray(over.begins, np.int64).tobytes(),
        np.ascontiguousarray(over.seq, np.uint8).tobytes(),
        np.ascontiguousarray(over.quals, np.uint8).tobytes(),
        np.ascontiguousarray(over.seq_offsets, np.int64).tobytes(),
        np.ascontiguousarray(over.cigar_ops, np.int32).tobytes(),
        np.ascontiguousarray(over.cigar_offsets, np.int64).tobytes(),
        ref_bytes, int(ref_begin),
        np.ascontiguousarray(alt_codes, np.uint8).tobytes(),
        int(begin), int(end), int(bool(is_ins)), int(bool(is_del)),
        int(shift_max))
    sup_a = np.frombuffer(raw[0], dtype=np.int8, count=n)
    bq_a = np.frombuffer(raw[1], dtype=np.int16, count=n)
    off_a = np.frombuffer(raw[2], dtype=np.int32, count=n)
    mism_a = np.frombuffer(raw[3], dtype=np.int32, count=n)
    clip_a = np.frombuffer(raw[4], dtype=np.int8, count=n)
    return sup_a, bq_a, off_a, mism_a, clip_a


def _tail_bias(offsets: list, tail_frac: float = 0.03) -> float:
    """Fraction of alt observations falling in the 3' read tail."""
    if not offsets:
        return 0.0
    in_tail = sum(1 for off, L in offsets if off >= L * (1.0 - tail_frac) - 1)
    return in_tail / len(offsets)


def _end_bias(offsets: list, end_frac: float = 0.1) -> float:
    if not offsets:
        return 0.0
    near = sum(1 for off, L in offsets
               if off < L * end_frac or off >= L * (1.0 - end_frac) - 1)
    return near / len(offsets)


_SB_GRID = np.linspace(0.0, 1.0, 513)


@functools.lru_cache(maxsize=65536)
def _strand_bias_prob(f1: int, r1: int, f2: int, r2: int,
                      min_diff: float = 0.25) -> float:
    """P(|p1 - p2| > min_diff) for p_i ~ Beta(f_i + 1, r_i + 1).

    Deterministic grid integration replacing the reference's Monte-Carlo
    resampling (strand_bias.cpp sample_beta with +1 direction priors):
    integral of pdf1(x) * [cdf2(x - d) + 1 - cdf2(x + d)] dx.
    Function-form scipy calls (frozen-distribution construction costs more
    than the integration itself) + memoised on the small-count tuples.
    """
    x = _SB_GRID
    a1, b1 = f1 + 1, r1 + 1
    with np.errstate(divide="ignore", invalid="ignore"):
        pdf1 = np.exp((a1 - 1) * np.log(x) + (b1 - 1) * np.log1p(-x)
                      - _sp.betaln(a1, b1))
    pdf1 = np.nan_to_num(pdf1, nan=0.0, posinf=0.0)
    if a1 == 1:
        pdf1[0] = b1          # x=0 boundary value of Beta(1, b1)
    if b1 == 1:
        pdf1[-1] = a1
    a2, b2 = f2 + 1, r2 + 1
    lo = np.clip(x - min_diff, 0.0, 1.0)
    hi = np.clip(x + min_diff, 0.0, 1.0)
    tail = _sp.betainc(a2, b2, lo) + (1.0 - _sp.betainc(a2, b2, hi))
    return float(min(max(np.trapezoid(pdf1 * tail, x), 0.0), 1.0))


@functools.lru_cache(maxsize=65536)
def _strand_diseq(fwd: int, rev: int, tail_mass: float = 0.01) -> float:
    """SD per the reference (strand_disequilibrium.cpp do_evaluate +
    maths.hpp:980 beta_tail_probability, tail_mass_ default 0.01): the
    posterior probability that the strand fraction is EXTREME —
    P(p < tail_mass) + P(p > 1 - tail_mass) under Beta(fwd+0.5, rev+0.5)
    over the reads overlapping the call.  ~0 for balanced pileups; fires
    only when nearly every read sits on one strand.  (Round-4 fix: the
    previous 1 - two-sided-binomial-p statistic fired on ~10% of good
    calls by chance — the cancer bench's 8% missed somatics were all
    'SD > 0.9' threshold kills of correctly-called sites.)"""
    return float(_beta_cdf(tail_mass, fwd + 0.5, rev + 0.5)
                 + _beta_sf(1.0 - tail_mass, fwd + 0.5, rev + 0.5))


def _min_tail(entry: dict, key: str, val, worst=min) -> None:
    """Accumulate the tail value across a sample's carried alleles."""
    entry[key] = val if key not in entry else worst(entry[key], val)


def _side_bias(offsets: list) -> float:
    """Binomial-style left/right imbalance of the allele position in reads."""
    if not offsets:
        return 0.5
    left = sum(1 for off, L in offsets if off < L / 2)
    return left / len(offsets)


# ---------------------------------------------------------------------------
# assignment-based measures (primary path; the pileup versions above are the
# recorded fallback when no facet bundle is available)
# ---------------------------------------------------------------------------

def _read_section(batch: ReadBatch, i: int, begin: int, end: int):
    """Aligned read bases + qualities over reference region [begin, end)
    (the reference's copy_sequence/copy_base_qualities over a mapped
    region)."""
    seq = batch.sequence(i)
    quals = batch.qualities(i)
    pos = int(batch.begins[i])
    q = 0
    bases, bqs = [], []
    for length, op in batch.cigar(i):
        length = int(length)
        if op in (cg.M, cg.EQ, cg.X):
            lo = max(begin - pos, 0)
            hi = min(end - pos, length)
            if hi > lo:
                bases.append(seq[q + lo:q + hi])
                bqs.append(quals[q + lo:q + hi])
            pos += length
            q += length
        elif op == cg.I:
            q += length
        elif op == cg.D:
            pos += length
        elif op == cg.S:
            q += length
        elif op in (cg.NSKIP, cg.P):
            pos += length
        if pos >= end:
            break
    if not bases:
        return np.zeros(0, np.uint8), np.zeros(0, np.uint8)
    return np.concatenate(bases), np.concatenate(bqs)


def _assign_tail_bias(sup, vb: int, ve: int, tail_frac: float = 0.03) -> float:
    """RTB over one allele's assigned support (read_tail_bias.cpp:60-110):
    beta_cdf(head+1, tail+1, min(3*tail_frac, 0.5)) where tail is the last
    tail_bases of each containing read in sequencing direction."""
    rb, re = sup.begins, sup.ends
    contains = (rb <= vb) & (ve <= re)
    tail_bases = np.maximum((sup.seq_lengths * tail_frac).astype(np.int64), 1)
    in_tail = np.where(sup.is_forward, vb >= re - tail_bases,
                        ve <= rb + tail_bases)
    tail = int((contains & in_tail).sum())
    head = int(contains.sum()) - tail
    return _beta_cdf(min(3 * tail_frac, 0.5), head + 1, tail + 1)


def _assign_end_bias(sup, vb: int, ve: int, end_frac: float = 0.03) -> float:
    """REB (read_end_bias.cpp:52-121): like RTB but 'end' means EITHER read
    end; beta_cdf(middle+1, end+1, min(3*end_frac, 0.5))."""
    rb, re = sup.begins, sup.ends
    contains = (rb <= vb) & (ve <= re)
    end_bases = np.maximum((sup.seq_lengths * end_frac).astype(np.int64), 1)
    in_end = (ve <= rb + end_bases) | (vb >= re - end_bases)
    end_n = int((contains & in_end).sum())
    middle = int(contains.sum()) - end_n
    return _beta_cdf(min(3 * end_frac, 0.5), middle + 1, end_n + 1)


def _assign_side_bias(sup, vb: int, ve: int, tolerance: float = 0.5) -> float:
    """RSB (read_side_bias.cpp:37-85): strand-aware left/right placement;
    P(lhs fraction outside [0.5 - tol/2, 0.5 + tol/2]) under
    Beta(lhs+1, rhs+1)."""
    size = ve - vb
    rb, re = sup.begins, sup.ends
    over = (rb < ve) & (vb < re)
    read_size = re - rb
    rhs = (vb < re) & (ve > rb + read_size // 2)   # overlaps right half
    fwd = sup.is_forward.astype(bool)
    big = size >= read_size // 2
    # per-read (head, tail) contribution: big -> (1, 1); else rhs XOR
    # strand decides which side gets the single count
    base_h = np.where(rhs, np.where(fwd, 0, 1), np.where(fwd, 1, 0))
    h = np.where(big, 1, base_h)
    t = np.where(big, 1, 1 - base_h)
    sel_f = over & fwd
    sel_r = over & ~fwd
    fwd_head = int(h[sel_f].sum())
    fwd_tail = int(t[sel_f].sum())
    rev_head = int(h[sel_r].sum())
    rev_tail = int(t[sel_r].sum())
    lhs = fwd_head + rev_tail
    rhs_n = fwd_tail + rev_head
    p_l = _beta_sf(0.5 + tolerance / 2, lhs + 1, rhs_n + 1)
    p_r = _beta_cdf(0.5 - tolerance / 2, lhs + 1, rhs_n + 1)
    return p_l + p_r


def _assign_mismatches(sup, allele_codes: np.ndarray, vb: int, ve: int):
    """BMC/BMQ inputs (base_mismatch_count.cpp:35-77): per supporting read
    overlapping the allele, mismatches between its aligned bases over the
    allele region and the ALLELE's own sequence."""
    count = 0
    mismatch_quals: list = []
    for batch, i in sup.reads:
        rb, re = int(batch.begins[i]), int(batch.ends[i])
        if not (rb < ve and vb < re):
            continue
        section, squals = _read_section(batch, i, vb, ve)
        n = min(len(section), len(allele_codes))
        if n == 0:
            continue
        if int(batch.begins[i]) <= vb:
            a, b, qs = section[:n], allele_codes[:n], squals[:n]
        else:                       # read starts inside the allele: align tails
            a, b, qs = section[-n:], allele_codes[-n:], squals[-n:]
        mism = a != b
        count += int(mism.sum())
        if mism.any():
            mismatch_quals.extend(int(q) for q in qs[mism])
    return count, mismatch_quals


def compute_measures(call, batch: ReadBatch, expected_af: float | None = None,
                     ref_codes=None, ref_begin: int = 0,
                     pipe_report=None, normal_batch: ReadBatch | None = None,
                     phase_length: int | None = None,
                     reads_by_sample: list | None = None,
                     facets=None) -> dict:
    """The full measure dict for one SiteCall against the sample's reads.

    With `reads_by_sample` (parallel to call.genotypes), the allele-support
    measures (AF/AFB/AD/ADP/BQ) are evaluated per CARRIER sample against that
    sample's own genotype and reads and aggregated with min-tail, as the
    reference does (allele_frequency_bias.cpp do_aggregator min_tail):
    pooled-read AF against sample 0's genotype mislabels every multi-sample
    call whose carriers differ from sample 0.
    """
    v = call.alts[0]
    ctx = site_context(batch, v.begin, v.end, v.alt_codes,
                       v.is_insertion(), v.is_deletion(),
                       ref_codes, ref_begin)
    out: dict = {}
    gt = call.genotypes[0] if call.genotypes else []
    depth = ctx.depth
    out["QUAL"] = call.quality
    out["GQ"] = call.genotype_qualities[0] if call.genotype_qualities else 0.0
    out["DP"] = depth
    out["ADP"] = ctx.assigned_depth
    out["AD"] = ctx.alt_depth
    out["AF"] = ctx.alt_depth / ctx.assigned_depth if ctx.assigned_depth else 0.0
    out["AC"] = sum(1 for a in gt if a > 0)
    out["MQ"] = ctx.rms_mapping_quality
    out["MQ0"] = ctx.mq0_count
    out["AMQ"] = (float(np.sqrt(np.mean(np.square(ctx.alt_mapping_qualities))))
                  if ctx.alt_mapping_qualities else 0.0)
    out["SMQ"] = (float(np.median(ctx.alt_mapping_qualities))
                  if ctx.alt_mapping_qualities else 0.0)
    out["MQD"] = abs(out["AMQ"] - out["MQ"])
    # BQ is not evaluable for indels (no bases span the allele): the
    # reference returns a missing value there (median_base_quality.cpp
    # is_indel guard), and missing values never fail a threshold clause.
    if v.is_indel() or not ctx.alt_base_qualities:
        out["BQ"] = None
    else:
        out["BQ"] = float(np.median(ctx.alt_base_qualities))
    # MP: per-sample FORMAT MP (sample 0) else joint INFO MP else missing
    # (model_posterior.cpp:27-45) — no QUAL fallback: MP is a genuinely
    # separate signal (model misfit), computed by the callers
    mps = getattr(call, "model_posteriors", None)
    out["MP"] = (float(mps[0]) if mps else call.info.get("MP"))
    out["MPD"] = (out["MP"] / depth if depth and out["MP"] is not None
                  else None)
    out["QD"] = call.quality / depth if depth else 0.0
    out["GQD"] = out["GQ"] / depth if depth else 0.0
    if expected_af is None:
        n_alt = sum(1 for a in gt if a > 0)
        expected_af = n_alt / len(gt) if gt else 0.5
    out["AFB"] = abs(out["AF"] - expected_af)
    # SB follows the reference's StrandBias (strand_bias.cpp): evaluable only
    # for heterozygous calls; value = P(|p_alt - p_other| > 0.25) where each
    # p ~ Beta(forward+1, reverse+1) from per-allele supporting reads. A
    # Fisher tail is far too trigger-happy (fires on ~alpha of true hets).
    if gt and len(set(gt)) > 1 and any(a > 0 for a in gt):
        out["SB"] = _strand_bias_prob(
            ctx.alt_forward, ctx.alt_reverse,
            max(ctx.fwd_depth - ctx.alt_forward, 0),
            max(ctx.rev_depth - ctx.alt_reverse, 0))
    else:
        out["SB"] = None
    # strand disequilibrium of the whole pileup (binomial two-sided)
    out["SD"] = (_strand_diseq(ctx.fwd_depth, depth - ctx.fwd_depth)
                 if depth else 0.0)
    # multi-sample or multi-allelic: allele-support measures per CARRIER
    # sample against the allele(s) that sample ACTUALLY CARRIES, min-tail
    # aggregated (allele_frequency_bias.cpp do_aggregator; cardinality
    # alt_alleles in measure.hpp).  Evaluating only alts[0] for every
    # sample zeroes AD/AF for any carrier of a different ALT and wrongly
    # threshold-fails well-supported multi-allelic records.
    if (reads_by_sample is not None and call.genotypes
            and (len(call.genotypes) > 1 or len(call.alts) > 1)):
        per = []
        for s, sgt in enumerate(call.genotypes):
            if s >= len(reads_by_sample) or not sgt or not any(a > 0 for a in sgt):
                continue
            entry: dict = {}
            for a in sorted({x for x in sgt if x > 0}):
                va = call.alts[a - 1] if a - 1 < len(call.alts) else v
                sctx = site_context(reads_by_sample[s], va.begin, va.end,
                                    va.alt_codes, va.is_insertion(),
                                    va.is_deletion(), ref_codes, ref_begin)
                af = (sctx.alt_depth / sctx.assigned_depth
                      if sctx.assigned_depth else 0.0)
                exp = sum(1 for x in sgt if x == a) / len(sgt)
                _min_tail(entry, "AF", af)
                _min_tail(entry, "AFB", abs(af - exp))
                _min_tail(entry, "AD", sctx.alt_depth)
                _min_tail(entry, "ADP", sctx.assigned_depth)
                if not va.is_indel() and sctx.alt_base_qualities:
                    _min_tail(entry, "BQ",
                              float(np.median(sctx.alt_base_qualities)))
                if len(set(sgt)) > 1:  # het carrier (strand_bias.cpp is_evaluable)
                    _min_tail(entry, "SB", _strand_bias_prob(
                        sctx.alt_forward, sctx.alt_reverse,
                        max(sctx.fwd_depth - sctx.alt_forward, 0),
                        max(sctx.rev_depth - sctx.alt_reverse, 0)),
                        worst=max)
            per.append(entry)
        if per:
            for k in ("AF", "AFB", "AD", "ADP"):
                vals = [e[k] for e in per if k in e]
                if vals:
                    out[k] = min(vals)
            bqs = [e["BQ"] for e in per if "BQ" in e]
            out["BQ"] = min(bqs) if bqs else None
            sbs = [e["SB"] for e in per if "SB" in e]
            out["SB"] = max(sbs) if sbs else None
    out["FRF"] = (1.0 - pipe_report.n_downsampled / pipe_report.n_raw
                  if pipe_report and pipe_report.n_raw else 0.0)
    out["CRF"] = ctx.clipped / depth if depth else 0.0
    out["SF"] = ctx.supplementary / depth if depth else 0.0
    out["DAD"] = ctx.dup_alt
    out["DAF"] = ctx.dup_alt / max(ctx.alt_depth, 1)
    out["DPC"] = 1.0 - out["DAF"]
    out["ARF"] = ctx.ambiguous / depth if depth else 0.0
    # base mismatch stats of alt-supporting reads (BMC/BMF/BMQ families)
    out["BMC"] = int(np.sum(ctx.alt_mismatch_counts)) if ctx.alt_mismatch_counts else 0
    total_alt_bases = sum(L for _, L in ctx.alt_offsets) or 1
    out["BMF"] = out["BMC"] / total_alt_bases
    out["BMQ"] = out["BQ"]
    out["MC"] = int(np.sum(ctx.mismatch_counts)) if ctx.mismatch_counts else 0
    total_bases = int(np.sum(ctx.read_lengths)) or 1
    out["MF"] = out["MC"] / total_bases
    rates = ([m / max(L, 1) for m, L in zip(ctx.mismatch_counts, ctx.read_lengths)]
             if ctx.mismatch_counts else [])
    out["ER"] = float(np.mean(rates)) if rates else 0.0
    out["ERS"] = float(np.std(rates)) if rates else 0.0
    out["MRC"] = ctx.misaligned
    out["MRL"] = int(max(ctx.read_lengths)) if ctx.read_lengths else 0
    out["VL"] = max(len(v.alt_codes), v.end - v.begin)
    out["ITV"] = int(v.is_snv() and _is_transversion(int(v.ref_codes[0]),
                                                     int(v.alt_codes[0])))
    # read-position biases of the allele
    out["RTB"] = _tail_bias(ctx.alt_offsets)
    out["REB"] = _end_bias(ctx.alt_offsets)
    out["RSB"] = _side_bias(ctx.alt_offsets)
    # reference context measures
    if ref_codes is not None and len(ref_codes):
        lo = max(v.begin - ref_begin - 50, 0)
        hi = min(v.begin - ref_begin + 51, len(ref_codes))
        window = ref_codes[lo:hi]
        out["GC"] = float(np.isin(window, (1, 2)).mean()) if len(window) else 0.0
        strl, strp = _str_context(ref_codes, ref_begin, v.begin)
        out["STRL"] = strl
        out["STRP"] = strp
    out["DENOVO"] = int(bool(call.info.get("DENOVO")))
    out["SOMATIC"] = int(bool(call.info.get("SOMATIC")))
    out["REFCALL"] = int(not call.alts or not len(v.alt_codes))
    # PP: the de novo / somatic classification posterior (INFO PP,
    # posterior_probability.cpp:25-33); missing for plain germline calls
    out["PP"] = call.info.get("PP")
    out["PPD"] = (out["PP"] / depth if depth and out["PP"] is not None
                  else None)
    out["PPP"] = call.info.get("PPP")
    # SHC: called ploidy minus constitutional ploidy, somatic calls only
    # (somatic_haplotype_count.cpp:25-39); the somatic sample's GT carries
    # the somatic haplotype as an extra slot
    if call.info.get("SOMATIC") and call.genotypes:
        lens = [len(g) for g in call.genotypes]
        out["SHC"] = max(lens) - min(lens) if len(lens) > 1 else 1
    else:
        out["SHC"] = call.info.get("SHC")
    out["MHL"] = call.info.get("MHL")
    # CC = posterior / quality, missing unless both exist
    # (classification_confidence.cpp:25-43)
    if out["PP"] is not None and out["QUAL"] is not None:
        out["CC"] = (out["PP"] / out["QUAL"] if out["QUAL"] > 0 else 0.0)
    else:
        out["CC"] = None
    out["PLN"] = phase_length if phase_length is not None else call.info.get("PLN", 0)
    # contamination measures
    if normal_batch is not None and len(normal_batch):
        nctx = site_context(normal_batch, v.begin, v.end, v.alt_codes,
                            v.is_insertion(), v.is_deletion())
        out["NC"] = nctx.alt_depth
    else:
        out["NC"] = 0
    out["DC"] = call.info.get("DC")
    if facets is not None:
        global FACET_MISSES
        try:
            _apply_facet_measures(out, call, v, facets)
        except _FACET_DATA_ERRORS as exc:
            # a facet failure must never silently degrade the forest
            # features: count it and warn (pileup fallbacks remain in out).
            # Only data errors are caught: an error of the pair-HMM scorer,
            # a kernel launch or torch.cuda ends the run.
            FACET_MISSES += 1
            if FACET_MISSES <= _FACET_MISS_WARN_LIMIT:
                _log.warning(
                    "facet measures failed at %s:%s (%s); pileup fallback "
                    "used (miss #%d)", getattr(call, "begin", "?"),
                    getattr(call, "end", "?"), exc, FACET_MISSES)
    return {k: val for k, val in out.items() if val is not None}


def _apply_facet_measures(out: dict, call, v, facets) -> None:
    """Override the pileup-based support measures with HMM read-to-haplotype
    assignment facets (read_assignments.hpp:25-34): AD/ADP/AF come from
    assigned reads (allele_depth.cpp, assigned_depth.cpp,
    allele_frequency.cpp), MHL from assigned-read likelihoods
    (mean_likelihood.cpp), DC from duplicate-group allele concordance
    (duplicate_concordance.cpp). Carrier samples aggregate min-tail over
    the allele(s) each carries, as the pileup path does."""
    gts = call.genotypes or []
    support_of = {}                       # alt index -> per-sample support

    def support_for(a: int):
        if a not in support_of:
            va = call.alts[a - 1] if a - 1 < len(call.alts) else v
            support_of[a] = facets.allele_support_context(va)
        return support_of[a]

    entries = []
    for s, sgt in enumerate(gts):
        carried = sorted({a for a in (sgt or []) if a > 0}) or [1]
        entry: dict = {}
        any_support = False
        for a in carried:
            support = support_for(a)
            if s >= len(support):
                continue
            any_support = True
            alt, dep = support[s]
            exp = (sum(1 for x in sgt if x == a) / len(sgt)) if sgt else 0.5
            af = alt / dep if dep else 0.0
            _min_tail(entry, "AD", alt)
            _min_tail(entry, "ADP", dep)
            _min_tail(entry, "AF", af)
            _min_tail(entry, "AFB", abs(af - exp))
        if any_support and (not sgt or any(a > 0 for a in sgt)):
            entries.append(entry)
    if entries:
        for k in ("AD", "ADP", "AF", "AFB"):
            vals = [e[k] for e in entries if k in e]
            if vals:
                out[k] = min(vals)
    mhls = [m for m in facets.mean_likelihoods(v.begin, v.end)
            if m is not None]
    if mhls:
        out["MHL"] = max(mhls)
    dc = facets.duplicate_concordance(v)
    if dc is not None:
        out["DC"] = dc
    _apply_assignment_bias_measures(out, call, v, facets)


def _apply_assignment_bias_measures(out: dict, call, v, facets) -> None:
    """SB/RTB/REB/RSB/ARF and the BMC family over HMM-ASSIGNED reads — the
    reference's primary semantics (strand_bias.cpp:34-213,
    read_tail_bias.cpp, read_end_bias.cpp, read_side_bias.cpp,
    ambiguous_read_fraction.cpp, base_mismatch_{count,fraction,quality}.cpp
    all require the ReadAssignments facet).  Values override the pileup
    fallbacks already in `out`; per-sample values aggregate max (biases
    grow with badness — the min-tail analogue for the filter direction)."""
    gts = call.genotypes or []
    support_of = {}                       # alt index -> per-sample support

    def support_for(a: int):
        if a not in support_of:
            va = call.alts[a - 1] if a - 1 < len(call.alts) else v
            support_of[a] = facets.allele_assignment_support(va)
        return support_of[a]

    n_samples = len(gts) or len(facets.samples)
    sbs, rtbs, rebs, rsbs, arfs, bmcs, bmfs = [], [], [], [], [], [], []
    bmq_quals: list = []
    for s in range(n_samples):
        sgt = gts[s] if s < len(gts) else []
        carrier = bool(sgt) and any(a > 0 for a in sgt)
        carried = sorted({a for a in (sgt or []) if a > 0}) or [1]
        # called alleles for this sample (get_called): ref appears when any
        # genotype slot is ref, plus each ALT the sample carries; the ref
        # support set is identical across this site's alts, so take it from
        # the first carried allele's support
        first = support_for(carried[0])
        entry0 = first[s] if s < len(first) else None
        if entry0 is None:
            continue
        called = []                       # (allele codes, support set, variant)
        if not sgt or any(a == 0 for a in sgt):
            called.append((v.ref_codes, entry0["ref"], v))
        if carrier or not sgt:
            for a in carried:
                va = call.alts[a - 1] if a - 1 < len(call.alts) else v
                sup_s = support_for(a)
                if s < len(sup_s) and sup_s[s] is not None:
                    called.append((va.alt_codes, sup_s[s]["alt"], va))
        # SB: evaluable only for het carriers (strand_bias.cpp:84-87);
        # pairwise max P(|p_i - p_j| > 0.25) over called alleles, counts
        # from assigned reads overlapping the call (+1 direction priors)
        vb, ve = v.begin, max(v.end, v.begin + 1)
        if carrier and sgt and len(set(sgt)) > 1:
            counts = []
            for _, sup, _va in called:
                over = (sup.begins < ve) & (sup.ends > vb)
                fwd = int((over & sup.is_forward).sum())
                counts.append((fwd, int(over.sum()) - fwd))
            best = 0.0
            for i in range(len(counts) - 1):
                for j in range(i + 1, len(counts)):
                    best = max(best, _strand_bias_prob(
                        counts[i][0], counts[i][1],
                        counts[j][0], counts[j][1]))
            sbs.append(best)
        # position biases: max over called alleles, each over ITS region
        if called:
            rtbs.append(max(_assign_tail_bias(
                sup, va.begin, max(va.end, va.begin + 1))
                for _, sup, va in called))
            rebs.append(max(_assign_end_bias(
                sup, va.begin, max(va.end, va.begin + 1))
                for _, sup, va in called))
            rsbs.append(max(_assign_side_bias(
                sup, va.begin, max(va.end, va.begin + 1))
                for _, sup, va in called))
        # ARF: ambiguously-assigned fraction of overlapping reads
        if entry0["n_overlapping"]:
            arfs.append(entry0["n_ambiguous"] / entry0["n_overlapping"])
        # BMC/BMF/BMQ over assigned support vs the allele's own sequence
        bmc = 0
        for codes, sup, va in called:
            c, quals = _assign_mismatches(
                sup, codes, va.begin, max(va.end, va.begin + 1))
            bmc += c
            bmq_quals.extend(quals)
        bmcs.append(bmc)
        bases = entry0["n_overlapping"] * max(len(v.alt_codes), ve - vb)
        bmfs.append(bmc / bases if bases else 0.0)
    if sbs:
        out["SB"] = max(sbs)
    if rtbs:
        out["RTB"] = max(rtbs)
        out["REB"] = max(rebs)
        out["RSB"] = max(rsbs)
    if arfs:
        out["ARF"] = max(arfs)
    if bmcs:
        out["BMC"] = max(bmcs)
        out["BMF"] = max(bmfs)
        out["BMQ"] = float(np.median(bmq_quals)) if bmq_quals else None


def _str_context(ref_codes, ref_begin: int, pos: int,
                 max_period: int = 6, window: int = 50):
    """(tract length, period) of the tandem repeat at the site, 0/0 if none."""
    from ...utils.tandem import extract_exact_tandem_repeats_arrays
    lo = max(pos - ref_begin - window, 0)
    hi = min(pos - ref_begin + window, len(ref_codes))
    seg = ref_codes[lo:hi]
    if not len(seg):
        return 0, 0
    best_len, best_period = 0, 0
    reps = extract_exact_tandem_repeats_arrays(np.asarray(seg, np.uint8), 1,
                                               max_period)
    for rpos, rlen, rper in reps:
        tract_begin = ref_begin + lo + int(rpos)
        tract_end = tract_begin + int(rlen)
        if tract_begin - 1 <= pos <= tract_end + 1 and rlen > best_len:
            best_len, best_period = int(rlen), int(rper)
    return best_len, best_period


__all__ = ["compute_measures", "site_context", "SiteContext", "ALL_MEASURES"]
