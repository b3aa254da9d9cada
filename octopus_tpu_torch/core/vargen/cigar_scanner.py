"""Candidate variant generation by CIGAR/pileup scanning.

Capability-equivalent to the reference's CigarScanner
(src/core/tools/vargen/cigar_scanner.{hpp,cpp}): walks each read's alignment
collecting SNV (mismatch in M ranges / X ops), insertion and deletion
candidates with per-sample observation statistics, filters reads that are
likely misaligned (Poisson tail on the number of high-quality differences),
and applies the reference's inclusion heuristics (is_good_germline /
is_good_somatic, cigar_scanner.cpp:500-700) over depth, strand and
base-quality stats.

Batch design: reads arrive as ReadBatch SoA; one call of the host
extension walks every read of a batch (scan_cigar_reads); coverage uses
difference arrays.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass, field

import numpy as np

from ...basics.reads import ReadBatch
from ..types.variants import Variant

# native whole-batch scan (csrc/octopus_native.cpp:scan_cigar_reads), built
# at first use
from ..._build import NATIVE as _native


@dataclass
class ScannerOptions:
    max_variant_size: int = 2000
    # misalignment filter (MisalignmentParameters defaults +
    # option_collation.cpp:1284-1295)
    use_misalignment_filter: bool = True
    snv_threshold: int = 20              # min-pileup-base-quality
    snv_penalty: float = 1.0
    indel_penalty: float = 1.0
    clip_penalty: float = 1.0
    max_expected_mutation_rate: float = 0.0211   # het + 2*stdev
    min_ln_prob_correctly_aligned: float = math.log(0.0001)
    max_unpenalised_clip_size: int = 3
    # inclusion predicate
    inclusion: str = "germline"          # germline | somatic | cell | pacbio | threshold
    # --allow-strand-biased-candidates (option_parser.cpp:439-441): skip
    # the strand-bias rejection clauses of the inclusion predicates
    allow_strand_bias: bool = False
    min_observations: int = 2            # for 'threshold'
    copy_number: int = 2
    min_vaf: float = 0.01                # for 'somatic'
    min_probability: float = 0.5
    min_bq: int = 20
    normal_sample: int | None = None


@dataclass
class _Candidate:
    begin: int
    end: int
    ref: bytes
    alt: bytes
    sample: int
    forward: bool
    sum_alt_quals: int
    at_edge: bool
    mapq: int
    misaligned: bool


class CigarScanner:
    """Accumulates reads (per sample), then generates candidate variants."""

    def __init__(self, reference, contig: str, options: ScannerOptions | None = None):
        self.reference = reference
        self.contig = contig
        self.options = options or ScannerOptions()
        self._candidates: list[_Candidate] = []
        self._cov: dict[int, dict[int, int]] = {}
        self._cov_events: list[tuple[int, int, int, int, bool]] = []  # sample, b, e, +-, fwd
        self._n_samples = 0

    def clear(self) -> None:
        self._candidates.clear()
        self._cov_events.clear()

    # -- scanning ----------------------------------------------------------

    def add_reads(self, sample: int, batch: ReadBatch) -> None:
        """One native call scans the whole batch: each read's mismatches,
        insertions and deletions, and its misalignment penalty."""
        self._n_samples = max(self._n_samples, sample + 1)
        if len(batch) == 0:
            return
        opt = self.options
        chunk_begin = int(batch.begins.min())
        ref_chunk = self.reference.fetch_codes(self.contig, chunk_begin,
                                               int(batch.ends.max()))
        is_fwd = ~batch.is_reverse()
        raw = _native.scan_cigar_reads(
            np.ascontiguousarray(ref_chunk, np.uint8).tobytes(),
            chunk_begin,
            np.ascontiguousarray(batch.begins, np.int64).tobytes(),
            np.ascontiguousarray(batch.ends, np.int64).tobytes(),
            np.ascontiguousarray(batch.mapq, np.uint8).tobytes(),
            np.ascontiguousarray(batch.seq, np.uint8).tobytes(),
            np.ascontiguousarray(batch.quals, np.uint8).tobytes(),
            np.ascontiguousarray(batch.seq_offsets, np.int64).tobytes(),
            np.ascontiguousarray(batch.cigar_ops, np.int32).tobytes(),
            np.ascontiguousarray(batch.cigar_offsets, np.int64).tobytes(),
            int(opt.snv_threshold), float(opt.snv_penalty),
            float(opt.indel_penalty), float(opt.clip_penalty),
            int(opt.max_unpenalised_clip_size), int(opt.max_variant_size),
            int(bool(opt.use_misalignment_filter)),
            float(opt.max_expected_mutation_rate),
            float(opt.min_ln_prob_correctly_aligned))
        rec = np.frombuffer(raw, dtype=np.dtype([
            ("read", np.int32), ("offset", np.int32), ("alt_len", np.int32),
            ("sum_q", np.int32), ("begin", np.int64), ("end", np.int64),
            ("at_edge", np.uint8), ("misaligned", np.uint8),
            ("pad", np.uint8, 6)]))
        seq = batch.seq
        soff = batch.seq_offsets
        mapq = batch.mapq
        begins_arr = batch.begins
        append = self._candidates.append
        for c in rec:
            r = int(c["read"])
            b, e = int(c["begin"]), int(c["end"])
            alt_len = int(c["alt_len"])
            o = int(soff[r]) + int(c["offset"])
            alt = seq[o:o + alt_len].tobytes()
            ref = ref_chunk[b - chunk_begin:e - chunk_begin].tobytes()
            append(_Candidate(b, e, ref, alt, sample, bool(is_fwd[r]),
                              int(c["sum_q"]), bool(c["at_edge"]),
                              int(mapq[r]), bool(c["misaligned"])))
        for r in range(len(batch)):
            self._cov_events.append((sample, int(begins_arr[r]),
                                     int(batch.ends[r]), 1, bool(is_fwd[r])))

    # -- generation --------------------------------------------------------

    def generate(self, region_begin: int, region_end: int) -> list[Variant]:
        """Candidate variants overlapping [region_begin, region_end)."""
        if not self._candidates:
            return []
        # coverage arrays per sample over the scanned span
        lo = min(c[1] for c in self._cov_events)
        hi = max(c[2] for c in self._cov_events)
        n = hi - lo + 1
        cov = np.zeros((self._n_samples, n), np.int64)
        fwd_cov = np.zeros((self._n_samples, n), np.int64)
        total_cov = np.zeros(n, np.int64)
        for sample, b, e, d, forward in self._cov_events:
            cov[sample, b - lo] += d
            cov[sample, e - lo] -= d
            total_cov[b - lo] += d
            total_cov[e - lo] -= d
            if forward:
                fwd_cov[sample, b - lo] += d
                fwd_cov[sample, e - lo] -= d
        cov = np.cumsum(cov, axis=1)
        fwd_cov = np.cumsum(fwd_cov, axis=1)
        total_cov = np.cumsum(total_cov)

        def min_depth(arr, b, e):
            b = max(b - lo, 0)
            e = max(e - lo, b + 1)
            return int(arr[b:e].min()) if e <= len(arr) else int(arr[b:].min())

        groups: dict[tuple, list[_Candidate]] = {}
        for c in self._candidates:
            if c.misaligned:
                continue
            if c.begin >= region_end or c.end <= region_begin:
                if not (c.begin == c.end == region_begin):
                    continue
            groups.setdefault((c.begin, c.end, c.ref, c.alt), []).append(c)

        out: list[Variant] = []
        for (b, e, ref, alt), obs in sorted(groups.items()):
            v = Variant(b, e, ref, alt)
            if self._include(v, obs, cov, fwd_cov, total_cov, lo, min_depth):
                out.append(v)
        return out

    # -- inclusion heuristics ---------------------------------------------

    def _include(self, v, obs, cov, fwd_cov, total_cov, lo, min_depth) -> bool:
        opt = self.options
        by_sample: dict[int, list[_Candidate]] = {}
        for c in obs:
            by_sample.setdefault(c.sample, []).append(c)
        if opt.inclusion == "threshold":
            return len(obs) >= opt.min_observations
        sample_stats = []
        for s, cands in by_sample.items():
            depth = max(min_depth(cov[s], v.begin, v.end), len(cands))
            fdepth = min_depth(fwd_cov[s], v.begin, v.end)
            quals = [c.sum_alt_quals for c in cands]
            fsupport = sum(1 for c in cands if c.forward)
            esupport = sum(1 for c in cands if c.at_edge)
            sample_stats.append((s, depth, fdepth, quals, fsupport, esupport))
        if opt.inclusion == "germline":
            if any(_is_good_germline(v, d, fd, fs, list(q), opt.copy_number,
                                     opt.allow_strand_bias)
                   for _, d, fd, q, fs, _ in sample_stats):
                return True
            if len(sample_stats) > 1:
                tot_d = min_depth(total_cov, v.begin, v.end)
                tot_fd = sum(st[2] for st in sample_stats)
                tot_q = [q for st in sample_stats for q in st[3]]
                tot_fs = sum(st[4] for st in sample_stats)
                return _is_good_germline(v, tot_d, tot_fd, tot_fs, tot_q,
                                         opt.copy_number, opt.allow_strand_bias)
            return False
        if opt.inclusion == "somatic":
            for s, d, fd, q, fs, es in sample_stats:
                if opt.normal_sample is not None and s == opt.normal_sample:
                    if _is_good_germline(v, d, fd, fs, list(q), opt.copy_number,
                                         opt.allow_strand_bias):
                        return True
                elif _is_good_somatic(v, d, fd, fs, es, list(q),
                                      opt.min_vaf, opt.min_probability,
                                      opt.min_bq, opt.allow_strand_bias):
                    return True
            return False
        if opt.inclusion == "cell":
            return any(_is_good_somatic(v, d, fd, fs, es, list(q), 0.2, 0.5, 15,
                                        opt.allow_strand_bias)
                       for _, d, fd, q, fs, es in sample_stats)
        if opt.inclusion == "pacbio":
            # PacBioInclusionPredicate (cigar_scanner.cpp:734-799): VAF
            # thresholds tiered by variant class/size, any sample or pooled
            if any(_is_good_pacbio(v, d, list(q))
                   for _, d, _, q, _, _ in sample_stats):
                return True
            if len(sample_stats) > 1:
                tot_d = min_depth(total_cov, v.begin, v.end)
                tot_q = [q for st in sample_stats for q in st[3]]
                return _is_good_pacbio(v, tot_d, tot_q)
            return False
        raise ValueError(f"unknown inclusion predicate {opt.inclusion}")


# ---------------------------------------------------------------------------
# Reference inclusion heuristics (cigar_scanner.cpp:500-700)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=200_000)
def _fisher_two_sided_p(a: int, b: int, c: int, d: int) -> float:
    """Exact two-sided Fisher p via log-space hypergeometric pmf.

    Identical tail rule to scipy.stats.fisher_exact (sum pmfs <= observed
    pmf x (1+1e-7)) but ~50x faster and memoised — the cigar scanner calls
    this per candidate site (cigar_scanner.cpp strand-bias heuristics)."""
    from scipy.special import gammaln
    n = a + b + c + d
    if n == 0:
        return 1.0
    r1, r2, c1 = a + b, c + d, a + c
    lo, hi = max(0, c1 - r2), min(c1, r1)
    x = np.arange(lo, hi + 1)
    lp = (gammaln(r1 + 1) - gammaln(x + 1) - gammaln(r1 - x + 1)
          + gammaln(r2 + 1) - gammaln(c1 - x + 1) - gammaln(r2 - c1 + x + 1)
          - (gammaln(n + 1) - gammaln(c1 + 1) - gammaln(n - c1 + 1)))
    p_obs = lp[a - lo]
    return float(min(np.exp(lp[lp <= p_obs + 1e-7]).sum(), 1.0))


def _strand_bias(fwd_sup, fwd_depth, rev_sup, rev_depth) -> float:
    return 1.0 - _fisher_two_sided_p(int(fwd_sup),
                                     int(max(fwd_depth - fwd_sup, 0)),
                                     int(rev_sup),
                                     int(max(rev_depth - rev_sup, 0)))


def _only_one_strand(fwd_sup, rev_sup) -> bool:
    return (fwd_sup + rev_sup) > 0 and (fwd_sup == 0 or rev_sup == 0)


def _is_runthrough_artifact(fwd_sup, rev_sup, quals) -> bool:
    n = fwd_sup + rev_sup
    if n < 10 or not _only_one_strand(fwd_sup, rev_sup):
        return False
    return bool(np.median(quals) < 15) if quals else False


def _is_tandem_repeat_seq(codes: np.ndarray, max_period: int = 4) -> bool:
    n = len(codes)
    for p in range(1, max_period + 1):
        if n >= 2 * p and np.array_equal(codes[p:], codes[:-p]):
            return True
    return False


def _is_good_pacbio(v: Variant, depth, quals) -> bool:
    """is_good_pacbio (cigar_scanner.cpp:734-770): support/VAF tiers by
    variant class and size — noisy long reads need VAF evidence, not base
    qualities."""
    support = len(quals)
    vaf = support / max(depth, 1)
    if v.is_insertion():
        alt_size = len(v.alt_codes)
        if alt_size > 500:
            return True
        if alt_size > 200:
            return vaf > 0.02
        if alt_size > 20:
            return vaf > 0.05
        if support < 2:
            return False
        if alt_size <= 2:
            return vaf > 0.2
        if alt_size < 4:
            return vaf > 0.1
        return vaf > 0.05
    if v.is_deletion() or (v.end - v.begin) > 1:     # deletion or mnv
        size = v.end - v.begin
        if size > 50:
            return vaf > 0.1
        if support < 2:
            return False
        if size <= 2:
            return vaf > 0.2
        if size < 4:
            return vaf > 0.1
        return vaf > 0.05
    return support > 1 and vaf > 0.1                 # snv


def _is_good_germline(v: Variant, depth, fwd_depth, fwd_support, quals,
                      copy_number=2, allow_strand_bias=False) -> bool:
    support = len(quals)
    if depth < 4:
        return support > 1 or sum(quals) >= 30 or v.is_deletion()
    rev_support = support - fwd_support
    rev_depth = depth - fwd_depth
    if not allow_strand_bias:
        bias = _strand_bias(fwd_support, fwd_depth, rev_support, rev_depth)
        if (support > 20 and bias > 0.99
                and _only_one_strand(fwd_support, rev_support)):
            return False
    if v.is_snv():
        if _is_runthrough_artifact(fwd_support, rev_support, quals):
            return False
        good = [q for q in quals if q >= 20]
        if depth <= 10:
            return len(good) > 1
        return len(good) > 2 and len(good) / depth > 1.0 / (5 * copy_number)
    if v.is_insertion():
        alt_size = len(v.alt)
        if support == 1 and alt_size > 10:
            return False
        if depth < 10:
            return support > 1 or (alt_size > 3 and _is_tandem_repeat_seq(v.alt_codes))
        if depth <= 30:
            return support > 1
        if depth <= 60:
            if support == 1:
                return False
            if support / depth > 0.3:
                return True
            good = sorted((q for q in quals if q >= 25), reverse=True)
            if len(good) <= 1:
                return False
            if len(good) > 2:
                return True
            return good[0] / alt_size > 20
        if support == 1:
            return False
        if support / depth > 0.35:
            return True
        good = sorted((q for q in quals if q >= 20), reverse=True)
        if len(good) <= 1:
            return False
        if len(good) > 3:
            return True
        return good[0] / alt_size > 20
    # deletion or mnv
    region_size = v.end - v.begin
    if region_size < 10:
        return support > 1 and support / depth > 1.0 / (10 * copy_number)
    return support / (depth - math.sqrt(depth)) > 1.0 / (5 * copy_number)


def _beta_sf(a, b, x) -> float:
    from scipy import stats as sps   # lazy: scipy.stats costs ~1.8s to import
    return float(sps.beta.sf(x, max(a, 1), max(b, 1)))


def _is_good_somatic(v: Variant, depth, fwd_depth, fwd_support, edge_support,
                     quals, min_vaf, min_probability, min_bq,
                     allow_strand_bias=False) -> bool:
    if depth == 0:
        return False
    support = len(quals)
    rev_support = support - fwd_support
    rev_depth = depth - fwd_depth
    raw_vaf = support / depth
    if not allow_strand_bias and support > 10:
        bias = _strand_bias(fwd_support, fwd_depth, rev_support, rev_depth)
        if bias > 0.99:
            if _only_one_strand(fwd_support, rev_support):
                return False
            if bias > 0.99999999 and raw_vaf < 0.9:
                return False
    if v.is_snv():
        if _is_runthrough_artifact(fwd_support, rev_support, quals):
            return False
        good = [q for q in quals if q >= min_bq]
        if len(good) <= edge_support:
            return False
        good_support = len(good) - edge_support
        p = _beta_sf(good_support, depth - good_support, min_vaf)
        return good_support > 1 and p >= min_probability and edge_support < support
    if v.is_insertion():
        alt_size = len(v.alt)
        if support == 1 and alt_size > 8:
            return False
        good = [q for q in quals if q >= min_bq]
        if len(good) > 1 and alt_size > 10:
            return True
        p = _beta_sf(len(good), depth - len(good), min_vaf)
        return len(good) > 1 and p >= min_probability
    p = _beta_sf(support, depth - support, min_vaf)
    return support > 1 and p >= min_probability


__all__ = ["CigarScanner", "ScannerOptions"]
