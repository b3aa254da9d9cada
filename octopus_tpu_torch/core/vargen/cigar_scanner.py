"""Candidate variant generation by CIGAR/pileup scanning: its options and
the inclusion predicates that stay in Python.

Capability-equivalent to the reference's CigarScanner
(src/core/tools/vargen/cigar_scanner.{hpp,cpp}): walks each read's alignment
collecting SNV (mismatch in M ranges / X ops), insertion and deletion
candidates with per-sample observation statistics, filters reads that are
likely misaligned (Poisson tail on the number of high-quality differences),
and applies the reference's inclusion heuristics (is_good_germline /
is_good_somatic, cigar_scanner.cpp:500-700) over depth, strand and
base-quality stats.

Batch design: the scan runs in the host extension's generate_candidates,
one call a window over every sample's reads (generator.py). It groups the
observations by (begin, end, alt), takes each sample's depths from
difference arrays over the reads' spans, and applies the germline,
threshold and PacBio predicates itself. The somatic and cell predicates
take scipy's beta tail: for them the call returns every group with its
per-sample statistics, and `included_by_caller` decides here.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np

from ..types.variants import Variant

# generate_candidates' inclusion codes; 3: the groups come back to Python
_INCLUSION = {"germline": 0, "threshold": 1, "pacbio": 2, "somatic": 3, "cell": 3}


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

    def native_args(self, use: bool) -> tuple:
        """The scanner's tuple of generate_candidates; `use` false skips
        the scan."""
        if self.inclusion not in _INCLUSION:
            raise ValueError(f"unknown inclusion predicate {self.inclusion}")
        return (int(use), int(self.snv_threshold), float(self.snv_penalty),
                float(self.indel_penalty), float(self.clip_penalty),
                int(self.max_unpenalised_clip_size), int(self.max_variant_size),
                int(bool(self.use_misalignment_filter)),
                float(self.max_expected_mutation_rate),
                float(self.min_ln_prob_correctly_aligned),
                _INCLUSION[self.inclusion], int(self.copy_number),
                int(bool(self.allow_strand_bias)), int(self.min_observations))


def included_by_caller(groups: bytes, seqs: bytes, rows: bytes, quals: bytes,
                       opt: ScannerOptions) -> list[Variant]:
    """The scanner's groups that the somatic or cell predicate includes.

    generate_candidates' groups, int64 (begin, end, ref_len, alt_len, row0,
    row1) with their ref and alt bytes in `seqs`; each row, int64 (sample,
    depth, fwd_depth, fwd_support, edge_support, q0, q1), a sample's
    observations of the group, and quals[q0:q1] (int32) their sums of alt
    base qualities. A group is included where any sample's predicate holds
    (under `somatic`, the normal sample's is the germline one)."""
    out = []
    rows = np.frombuffer(rows, np.int64).reshape(-1, 7).tolist()
    quals = np.frombuffer(quals, np.int32).tolist()
    off = 0
    for b, e, n_ref, n_alt, r0, r1 in (
            np.frombuffer(groups, np.int64).reshape(-1, 6).tolist()):
        v = Variant(b, e, seqs[off:off + n_ref], seqs[off + n_ref:off + n_ref + n_alt])
        off += n_ref + n_alt
        for s, d, fd, fs, es, q0, q1 in rows[r0:r1]:
            q = quals[q0:q1]
            if opt.inclusion == "cell":
                good = _is_good_somatic(v, d, fd, fs, es, q, 0.2, 0.5, 15,
                                        opt.allow_strand_bias)
            elif opt.normal_sample is not None and s == opt.normal_sample:
                good = _is_good_germline(v, d, fd, fs, q, opt.copy_number,
                                         opt.allow_strand_bias)
            else:
                good = _is_good_somatic(v, d, fd, fs, es, q, opt.min_vaf,
                                        opt.min_probability, opt.min_bq,
                                        opt.allow_strand_bias)
            if good:
                out.append(v)
                break
    return out


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


def _is_good_germline(v: Variant, depth, fwd_depth, fwd_support, quals,
                      copy_number=2, allow_strand_bias=False) -> bool:
    support = len(quals)
    if depth < 4:
        return support > 1 or sum(quals) >= 30 or v.is_deletion()
    rev_support = support - fwd_support
    rev_depth = depth - fwd_depth
    # the strand-bias test decides only here
    if (not allow_strand_bias and support > 20
            and _only_one_strand(fwd_support, rev_support)
            and _strand_bias(fwd_support, fwd_depth, rev_support, rev_depth) > 0.99):
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
        return (good_support > 1 and edge_support < support
                and _beta_sf(good_support, depth - good_support, min_vaf)
                >= min_probability)
    if v.is_insertion():
        alt_size = len(v.alt)
        if support == 1 and alt_size > 8:
            return False
        good = [q for q in quals if q >= min_bq]
        if len(good) > 1 and alt_size > 10:
            return True
        return (len(good) > 1
                and _beta_sf(len(good), depth - len(good), min_vaf) >= min_probability)
    return support > 1 and _beta_sf(support, depth - support, min_vaf) >= min_probability


__all__ = ["ScannerOptions", "included_by_caller"]
