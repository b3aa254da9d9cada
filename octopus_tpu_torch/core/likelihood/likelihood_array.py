"""The read x haplotype log-likelihood matrix, computed in device batches.

Capability-equivalent to the reference's HaplotypeLikelihoodArray
(src/core/models/haplotype_likelihood_array.cpp:51-150): instead of looping
(haplotype, read) pairs through a SIMD kernel on threads, all pairs of an
active region are packed into read-length buckets and each bucket is scored
in one `pairhmm_scores` launch on `LikelihoodConfig.device`.

Per window:
1. per-haplotype penalty tracks from the error models (host numpy);
2. the (haplotype, read, anchor) jobs (`_gather_jobs`): the k-mer anchors
   of every read on every haplotype, each read's original offset, the
   band's range rule, in one call of the host extension
   (`gather_anchor_jobs`);
3. the reference's naive shortcuts (exact match / single mismatch with gap
   checks, pair_hmm.hpp:278-319) evaluated for ALL candidate positions at
   once with suffix-equality cumulative products — the large majority of
   pairs never reach the HMM;
4. remaining (read, haplotype, anchor) jobs bucketed by read length and
   scored on the device (small job sets on the host DP); max over anchors
   per pair;
5. flank-state discounting for the (few) reads overlapping haplotype
   flanks, in one call of the host extension (`flank_banded_scores`);
6. mapping-quality mixture and final clamping
   (haplotype_likelihood_model.cpp:285-303).

Timers phases: steps 1-2 are populate_jobs, 3 populate_shortcut, 4's
seven tracks populate_stage and its scorers hmm_host_dp or hmm_device, 5
on a card's job set populate_flank; the bucket loop, the max over anchors,
the cache writes and 6 stay in the caller's phase.

Output: per sample, an (n_haplotypes, n_reads) float64 matrix with entries
matching the reference bit-for-bit in score space.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
import threading
import zlib

import numpy as np

from ..._build import NATIVE as _native, require_native
from ...basics.phred import LN10_DIV_10
from ...basics.reads import ReadBatch
from ...device import resolve_device
from ...utils import timers
from .error_models import (
    RepeatBasedIndelErrorModel,
    RepeatBasedSnvErrorModel,
    make_error_models,
)
from .pairhmm_batch import PAD_CODE, pairhmm_scores, scorer_name

# the reference's k-mer mapper (src/utils/kmer_mapper.hpp:19-60): a read's
# K-mers vote for its begins on a haplotype, and up to MAX_MAPPING_POSITIONS
# best begins become its anchors
K = 6
MAX_MAPPING_POSITIONS = 10

# process-wide memo of per-haplotype penalty tracks, keyed by sequence
# content; FIFO-capped. Read-only values, safe to share across
# threads/windows.
_PENALTY_CACHE: dict = {}
_CACHE_MAX = 8192


@dataclass
class RoutingCounts:
    """Where HMM job sets went, by (source, scorer): source "populate" (the
    beam and the likelihood populate) or "assignment" (CSR read
    assignment); scorer "host_dp" (the native host DP) or the
    pairhmm_batch.scorer_name of the kernel or plain twin that ran.
    shortcut_pairs counts the jobs (read, haplotype, anchor) that the naive
    shortcuts resolved before any scorer, from either source.
    tied_reads_credited counts the tied reads of read assignment that CSR's
    allele depth credited to an allele (core/csr/facets.py
    allele_support_context), a read once for each allele it was credited to.
    native_gathers counts the calls of the host extension's
    gather_anchor_jobs, one a populate's sample or a pad group of
    assignment blocks. candidates counts the candidate variants that
    candidate generation (core/vargen/) returned to the caller, summed over
    windows. hapgen_packets counts the packets the stateful haplotype
    generator returned (core/hapgen/haplotype_generator.py), and
    prune_rounds the pruning rounds that scored paths (core/hapgen/beam.py
    _prune_paths, from the beam and the generator alike). card_reductions
    sums the shapes of the genotype reductions run on the device
    (core/models/genotype_likelihoods.py): "ghr", "gh", "hr" and "gr", the
    sums of G*H*R, G*H, H*R and G*R over G genotypes, H haplotypes and R
    reads."""

    job_sets: Counter = field(default_factory=Counter)
    pairs: Counter = field(default_factory=Counter)
    shortcut_pairs: int = 0
    tied_reads_credited: int = 0
    native_gathers: int = 0
    candidates: int = 0
    hapgen_packets: int = 0
    prune_rounds: int = 0
    card_reductions: Counter = field(default_factory=Counter)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False,
                                  compare=False)

    def record(self, source: str, scorer: str, pairs: int) -> None:
        with self._lock:
            self.job_sets[(source, scorer)] += 1
            self.pairs[(source, scorer)] += pairs

    def record_shortcuts(self, pairs: int) -> None:
        with self._lock:
            self.shortcut_pairs += pairs

    def record_tied_credits(self, reads: int) -> None:
        with self._lock:
            self.tied_reads_credited += reads

    def record_native_gather(self) -> None:
        with self._lock:
            self.native_gathers += 1

    def record_candidates(self, n: int) -> None:
        with self._lock:
            self.candidates += n

    def record_packet(self) -> None:
        with self._lock:
            self.hapgen_packets += 1

    def record_prune_round(self) -> None:
        with self._lock:
            self.prune_rounds += 1

    def record_card_reduction(self, G: int, H: int, R: int) -> None:
        with self._lock:
            self.card_reductions.update(ghr=G * H * R, gh=G * H, hr=H * R,
                                        gr=G * R)

    def _total(self, counter: Counter, host: bool) -> int:
        return sum(v for (_, scorer), v in counter.items()
                   if (scorer == "host_dp") == host)

    @property
    def host_job_sets(self) -> int:
        return self._total(self.job_sets, True)

    @property
    def host_pairs(self) -> int:
        return self._total(self.pairs, True)

    @property
    def device_job_sets(self) -> int:
        return self._total(self.job_sets, False)

    @property
    def device_pairs(self) -> int:
        return self._total(self.pairs, False)

    def reset(self) -> None:
        with self._lock:
            self.job_sets.clear()
            self.pairs.clear()
            self.shortcut_pairs = 0
            self.tied_reads_credited = 0
            self.native_gathers = 0
            self.candidates = 0
            self.hapgen_packets = 0
            self.prune_rounds = 0
            self.card_reductions.clear()


ROUTING = RoutingCounts()


BAND_BUCKETS = (8, 16, 32)


def select_band(variants, max_indel_error: int) -> int:
    """Pair-HMM band (pad) for one calling context.

    The smallest bucket strictly wider than the longest candidate indel
    (band b tolerates net in-read drift of b-1), capped by
    --max-indel-errors rounded up to a bucket. The reference picks ONE
    config-wide band (simd_pair_hmm_wrapper.hpp:43-95, default 16); we
    select per context so SNV-only regions run the narrow fast kernel while
    long-indel regions escalate to 16/32 — same scores wherever the narrow
    band suffices, reference scores where it doesn't."""
    cap = next((b for b in BAND_BUCKETS if b >= max_indel_error),
               BAND_BUCKETS[-1])
    longest = 0
    for v in variants:
        longest = max(longest, abs(len(v.ref) - len(v.alt)))
    need = next((b for b in BAND_BUCKETS if b > longest), BAND_BUCKETS[-1])
    return min(need, cap)


@dataclass
class LikelihoodConfig:
    """Mirrors HaplotypeLikelihoodModel::Config (haplotype_likelihood_model.hpp:36-44)."""

    use_mapping_quality: bool = True
    # None = auto from the read data (calculate_mapping_quality_cap /
    # _trigger, option_collation.cpp:1635-1659): cap 240 for long reads
    # (median length > 1000), 120 for >200, else max observed MQ;
    # trigger = max observed MQ (floored at the BWA cap 60).  Without the
    # trigger, long noisy reads saturate the mismap floor and genotype
    # discrimination collapses.
    mapping_quality_cap: int | None = None
    mapping_quality_cap_trigger: int | None = None
    # --use-same-read-profile-for-all-samples: derive ONE pooled cap/trigger
    # per populate() from all samples' reads instead of per sample
    # (option_collation.cpp:1624-1659: the shared ReadSetProfile path)
    shared_read_profile: bool = False
    use_flank_state: bool = True
    # --max-indel-errors: band-size ceiling (reference default 16,
    # option_parser.cpp:579-581); actual band per context via select_band
    max_indel_error: int = 16
    error_model: str = "PCR-FREE.HISEQ-2500"
    length_bucket: int = 32           # read-length bucket granularity
    nuc_prior: int = 2
    # job sets of at most this many pairs run the native host DP instead of
    # paying a device round trip; 0 sends every set to the device scorer
    host_hmm_max: int = 384
    # for direct HaplotypeLikelihoodArray users: a caller overwrites it with
    # BaseCallerConfig.device
    device: str = "cuda"


class ShortHaplotypeError(ValueError):
    """A haplotype is too short to band-align some overlapping read
    (reference: HaplotypeLikelihoodModel::ShortHaplotypeError,
    haplotype_likelihood_model.cpp:244-252; callers skip the region,
    caller.cpp:1182-1188)."""


@dataclass
class FlankState:
    lhs_flank: int
    rhs_flank: int


@dataclass
class HaplotypePenalties:
    codes: np.ndarray
    gap_open: np.ndarray
    gap_extend: np.ndarray
    snv_mask_fwd: np.ndarray | None
    snv_prior_fwd: np.ndarray | None
    snv_mask_rev: np.ndarray | None
    snv_prior_rev: np.ndarray | None


def _gather_jobs(seq, seq_offsets, original, haplotypes, read_base,
                 hap_base, need, pad, fault):
    """The (haplotype, read, anchor) jobs of groups of reads against groups
    of haplotypes: reads read_base[g]:read_base[g + 1] against haplotypes
    hap_base[g]:hap_base[g + 1].

    seq, seq_offsets: the reads' flat base codes; original: each read's
    offset on its group's haplotypes; need: None, or an (n_haplotypes,
    n_reads) bool mask of the pairs still to score (a haplotype with none
    is skipped). A read's anchors are the k-mer mapper's best begins (at
    most MAX_MAPPING_POSITIONS, ascending) and its original offset; a job
    is kept where pad <= begin and begin + length <= haplotype length, and
    a needed read left without one is shifted into range. Jobs come
    haplotype by haplotype: the kept anchors by read, then the kept
    original offsets, then the shifted reads. Returns int64 (job_hap,
    job_read, job_pos), global indices; raises ShortHaplotypeError(
    fault(h, r)) at the first read that no position fits."""
    hap_offsets = np.zeros(len(haplotypes) + 1, np.int64)
    np.cumsum([len(h) for h in haplotypes], out=hap_offsets[1:])
    c = np.ascontiguousarray
    hap, read, pos, bad = _native.gather_anchor_jobs(
        c(seq, np.uint8), c(seq_offsets, np.int64), c(original, np.int64),
        c(np.concatenate(haplotypes) if haplotypes else np.zeros(0),
          np.uint8),
        hap_offsets, c(read_base, np.int64), c(hap_base, np.int64),
        b"" if need is None else c(need, np.uint8), int(pad), K,
        MAX_MAPPING_POSITIONS)
    ROUTING.record_native_gather()
    if bad is not None:
        raise ShortHaplotypeError(fault(*bad))
    return (np.frombuffer(hap, np.int64), np.frombuffer(read, np.int64),
            np.frombuffer(pos, np.int64))


class HaplotypeLikelihoodArray:
    """Computes and stores per-sample (H, R) log-likelihood matrices.

    `source` labels this array's HMM job sets in ROUTING: "populate" for
    the beam and the likelihood populate, "assignment" for CSR read
    assignment."""

    def __init__(self, config: LikelihoodConfig | None = None,
                 source: str = "populate"):
        self.config = config or LikelihoodConfig()
        self.source = source
        self.device = resolve_device(self.config.device)
        require_native()
        self._snv_model, self._indel_model = make_error_models(self.config.error_model)
        self.likelihoods: list[np.ndarray] = []   # per sample (H, R)
        self._n_haplotypes = 0

    # -- public API --------------------------------------------------------

    def populate(
        self,
        reads_by_sample: list[ReadBatch],
        haplotypes: list[np.ndarray],
        haplotype_begin: int,
        flank_state: FlankState | None = None,
        substitution_masks: list[np.ndarray] | None = None,
        cache: dict | None = None,
        pad: int | None = None,
    ) -> "HaplotypeLikelihoodArray":
        """Score every read of every sample against every haplotype.

        haplotypes: list of base-code arrays, all laid over the same genomic
        region starting at haplotype_begin.

        cache: optional raw-score memo shared across populate calls of one
        window (beam prune rounds re-score surviving paths every round, and
        the final populate re-scores the kept set). Keys are content hashes
        of (haplotype sequence + offset, flank extents, read); values the
        pre-mixture max ln-likelihood.
        """
        cfg = self.config
        if pad is None:
            pad = cfg.max_indel_error
        self._n_haplotypes = len(haplotypes)
        with timers.phase("populate_jobs"):
            penalties = [
                self._haplotype_penalties(h, None if substitution_masks is None else substitution_masks[i])
                for i, h in enumerate(haplotypes)
            ]
            if flank_state is not None and flank_state.lhs_flank <= 0 \
                    and flank_state.rhs_flank <= 0:
                flank_state = None
            hap_keys = None
            if cache is not None:
                # flank discounting changes raw scores, so the flank extents are
                # part of the cache key; beam prune rounds and the final populate
                # of one window share the same flank state and still hit
                fk = (0, 0) if flank_state is None else (flank_state.lhs_flank,
                                                         flank_state.rhs_flank)
                hap_keys = [(haplotype_begin, len(h),
                             zlib.crc32(h.tobytes()), fk, pad) for h in haplotypes]
            self._pooled_cap_trig = None
            if cfg.shared_read_profile and cfg.use_mapping_quality:
                self._pooled_cap_trig = self._derive_cap_and_trigger(
                    np.concatenate([b.mapq for b in reads_by_sample])
                    if any(len(b) for b in reads_by_sample) else np.zeros(0),
                    np.concatenate([b.lengths() for b in reads_by_sample])
                    if any(len(b) for b in reads_by_sample) else np.zeros(0))
        self.likelihoods = []
        for batch in reads_by_sample:
            self.likelihoods.append(
                self._populate_sample(batch, haplotypes, penalties,
                                      haplotype_begin, flank_state, pad,
                                      cache, hap_keys)
            )
        return self

    def sample_matrix(self, sample_idx: int) -> np.ndarray:
        return self.likelihoods[sample_idx]

    # -- internals ---------------------------------------------------------

    def _haplotype_penalties(self, codes: np.ndarray, subst_mask) -> HaplotypePenalties:
        # penalty tracks depend only on (error model, sequence, subst mask):
        # beam prune rounds and the final populate see the same haplotypes
        # over and over, and the error-model evaluation (tandem scan + table
        # lookups) is the single largest host cost without this memo
        key = (self.config.error_model, len(codes), zlib.crc32(codes.tobytes()),
               -1 if subst_mask is None else zlib.crc32(subst_mask.tobytes()))
        hit = _PENALTY_CACHE.get(key)
        if hit is not None:
            return hit
        indel = self._indel_model.set_penalties(codes)
        if self._snv_model is not None:
            snv = self._snv_model.evaluate(codes, subst_mask)
            result = HaplotypePenalties(
                codes, indel.gap_open, indel.gap_extend,
                snv.forward_mask, snv.forward_priors,
                snv.reverse_mask, snv.reverse_priors,
            )
        else:
            result = HaplotypePenalties(codes, indel.gap_open, indel.gap_extend,
                                        None, None, None, None)
        if len(_PENALTY_CACHE) >= _CACHE_MAX:
            _PENALTY_CACHE.pop(next(iter(_PENALTY_CACHE)))
        _PENALTY_CACHE[key] = result
        return result

    def _populate_sample(self, batch, haplotypes, penalties,
                         hap_begin, flank_state, pad, cache=None,
                         hap_keys=None):
        n_reads = len(batch)
        H = len(haplotypes)
        out = np.full((H, n_reads), -np.inf, dtype=np.float64)
        if n_reads == 0:
            return np.zeros((H, 0), dtype=np.float64)
        with timers.phase("populate_jobs"):
            lens = batch.lengths()
            original = np.maximum(batch.begins - hap_begin, 0)
            is_rev = batch.is_reverse()

            read_keys = None
            cached_pairs = None
            need = None
            if cache is not None:
                read_keys = [
                    (int(batch.begins[r]), int(lens[r]), int(batch.mapq[r]),
                     int(batch.flags[r]),
                     zlib.crc32(batch.sequence(r).tobytes(),
                                zlib.crc32(batch.qualities(r).tobytes())))
                    for r in range(n_reads)
                ]
                cached_pairs = set()
                # need[h, r] = read r still needs scoring against h
                need = np.ones((H, n_reads), bool)
                for h in range(H):
                    hk = hap_keys[h]
                    for r in range(n_reads):
                        hit = cache.get((hk, read_keys[r]))
                        if hit is not None:
                            out[h, r] = hit
                            cached_pairs.add((h, r))
                            need[h, r] = False

            job_hap, job_read, job_pos = _gather_jobs(
                batch.seq, batch.seq_offsets, original,
                haplotypes, np.array([0, n_reads]), np.array([0, H]), need,
                pad, lambda h, r: (f"haplotype {h} too short for read {r} "
                                   f"(len {lens[r]}, hap {len(haplotypes[h])})"))

        # evaluate all jobs grouped by read-length bucket (lengths padded up
        # to the bucket size with PAD_CODE/qual-0, which is score-exact)
        job_ln = np.full(len(job_hap), -np.inf, dtype=np.float64)
        job_lens = lens[job_read]
        bucket = self.config.length_bucket
        job_bucket = -(-job_lens // bucket) * bucket
        for L in np.unique(job_bucket):
            sel = np.flatnonzero(job_bucket == L)
            job_ln[sel] = self._eval_jobs_fixed_len(
                batch, haplotypes, penalties, int(L),
                job_hap[sel], job_read[sel], job_pos[sel], job_lens[sel],
                flank_state, pad, is_rev,
            )

        # reduce: max over candidate positions per (hap, read)
        np.maximum.at(out, (job_hap, job_read), job_ln)

        if cache is not None:
            for h, r in set(zip(job_hap.tolist(), job_read.tolist())):
                if (h, r) not in cached_pairs:
                    cache[(hap_keys[h], read_keys[r])] = out[h, r]

        # mapping-quality mixture + clamp
        if self.config.use_mapping_quality:
            mq = batch.mapq.astype(np.float64)
            cap, trig = self._mq_cap_and_trigger(batch)
            if trig is not None and trig < cap:
                mq = np.where(mq >= trig, cap, mq)
            ln_miss = -LN10_DIV_10 * mq
            ln_mapped = np.log1p(-np.exp(ln_miss))
            a = ln_mapped[None, :] + out
            hi = np.maximum(a, ln_miss[None, :])
            lo = np.minimum(a, ln_miss[None, :])
            out = hi + np.log1p(np.exp(lo - hi))
        out[out > -1e-15] = 0.0
        return out

    def _mq_cap_and_trigger(self, batch):
        """Profile-driven mapping-quality cap + trigger
        (calculate_mapping_quality_cap/_trigger,
        option_collation.cpp:1635-1659): explicit config values win;
        otherwise derive from this batch's reads (the per-window analogue
        of the reference's up-front ReadSetProfile), or from the pooled
        all-sample profile under --use-same-read-profile-for-all-samples."""
        cap = self.config.mapping_quality_cap
        trig = self.config.mapping_quality_cap_trigger
        if cap is not None and trig is not None:
            return cap, trig
        if getattr(self, "_pooled_cap_trig", None) is not None:
            pooled_cap, pooled_trig = self._pooled_cap_trig
            return (cap if cap is not None else pooled_cap,
                    trig if trig is not None else pooled_trig)
        derived_cap, derived_trig = self._derive_cap_and_trigger(
            batch.mapq if len(batch) else np.zeros(0),
            batch.lengths() if len(batch) else np.zeros(0))
        return (cap if cap is not None else derived_cap,
                trig if trig is not None else derived_trig)

    @staticmethod
    def _derive_cap_and_trigger(mapqs: np.ndarray, lengths: np.ndarray):
        max_mq = int(mapqs.max()) if len(mapqs) else 60
        trig = max(max_mq, 60)
        median_len = float(np.median(lengths)) if len(lengths) else 0
        if median_len > 1000:
            cap = 240
        elif median_len > 200:
            cap = 120
        else:
            cap = max(max_mq, 60)
        return cap, trig

    def _eval_jobs_fixed_len(self, batch, haplotypes, penalties, L,
                             job_hap, job_read, job_pos, job_lens,
                             flank_state, pad, is_rev):
        """ln-likelihood for jobs whose reads all fit in length bucket L."""
        with timers.phase("populate_shortcut"):
            tgt, quals, ln, done = self._shortcut_scores(
                batch, haplotypes, penalties, L, job_hap, job_read, job_pos,
                job_lens, flank_state, is_rev)
        rest = np.flatnonzero(~done)
        ROUTING.record_shortcuts(len(done) - len(rest))
        if len(rest):
            ln[rest] = self._device_scores(batch, haplotypes, penalties, L,
                                           job_hap[rest], job_read[rest],
                                           job_pos[rest], job_lens[rest],
                                           flank_state, pad,
                                           is_rev, tgt[rest], quals[rest])
        return ln

    def _shortcut_scores(self, batch, haplotypes, penalties, L, job_hap,
                         job_read, job_pos, job_lens, flank_state, is_rev):
        """The jobs' read matrices padded to L (tgt, quals), and the
        ln-likelihoods of the jobs the naive shortcuts resolve (ln, where
        done)."""
        n = len(job_hap)
        cfg = self.config
        # read matrices padded to the bucket length
        starts = batch.seq_offsets[job_read]
        col = np.arange(L)
        valid = col[None, :] < job_lens[:, None]
        gather = starts[:, None] + np.minimum(col, job_lens[:, None] - 1)
        tgt = np.where(valid, batch.seq[gather], PAD_CODE).astype(np.int16)
        quals = np.where(valid, batch.quals[gather], 0).astype(np.int16)

        # ---- naive shortcuts (vectorised) --------------------------------
        ln = np.full(n, np.nan)
        done = np.zeros(n, bool)
        # window at the exact offset
        w0 = np.empty((n, L), np.int16)
        hap_len = np.asarray([len(haplotypes[h]) for h in job_hap])
        for h in np.unique(job_hap):
            hsel = np.flatnonzero(job_hap == h)
            codes = haplotypes[h]
            idx = job_pos[hsel][:, None] + col
            w0[hsel] = codes[np.minimum(idx, len(codes) - 1)].astype(np.int16)
        mism = (tgt != w0) & valid
        n_mism = mism.sum(axis=1)
        done[n_mism == 0] = True
        ln[n_mism == 0] = 0.0
        one = np.flatnonzero(n_mism == 1)
        if len(one):
            i = np.argmax(mism[one], axis=1)
            rows = one
            truth_idx = job_pos[rows] + i
            q = quals[rows, i].astype(np.int64)
            go = np.empty(len(rows), np.int64)
            ge = np.empty(len(rows), np.int64)
            capped = q.copy()
            in_flank = np.zeros(len(rows), bool)
            row_hap = job_hap[rows]
            for h in np.unique(row_hap):
                ksel = np.flatnonzero(row_hap == h)
                p = penalties[h]
                ti = truth_idx[ksel]
                go[ksel] = p.gap_open[ti]
                ge[ksel] = p.gap_extend[ti]
                if p.snv_mask_fwd is not None:
                    rev = is_rev[job_read[rows[ksel]]]
                    m = np.where(rev, p.snv_mask_rev[ti], p.snv_mask_fwd[ti])
                    pr = np.where(rev, p.snv_prior_rev[ti], p.snv_prior_fwd[ti])
                    hitm = m == tgt[rows[ksel], i[ksel]]
                    capped[ksel] = np.where(
                        hitm, np.minimum(capped[ksel], pr), capped[ksel])
                if flank_state is not None and cfg.use_flank_state:
                    hl = len(haplotypes[h])
                    in_flank[ksel] = ((ti < flank_state.lhs_flank)
                                      | (ti >= hl - flank_state.rhs_flank))
            # suffix equality checks for single-base shifts
            w1 = np.empty((len(rows), L), np.int16)
            for h in np.unique(job_hap[rows]):
                hsel = np.flatnonzero(job_hap[rows] == h)
                codes = haplotypes[h]
                idx = job_pos[rows[hsel]][:, None] + 1 + np.arange(L)
                w1[hsel] = codes[np.minimum(idx, len(codes) - 1)].astype(np.int16)
            # positions beyond the real read length always compare equal
            A = (tgt[rows, 1:] == w0[rows, :-1]) | ~valid[rows, 1:]   # target[i+1+k] == truth[ti+k]
            B = (tgt[rows] == w1) | ~valid[rows]                      # target[i+k] == truth[ti+1+k]
            sufA = np.flip(np.cumprod(np.flip(A, axis=1), axis=1), axis=1)
            sufB = np.flip(np.cumprod(np.flip(B, axis=1), axis=1), axis=1)
            del_ok = np.where(i < L - 1, sufA[np.arange(len(rows)), np.minimum(i, L - 2)], True)
            ins_ok = sufB[np.arange(len(rows)), i]
            pen = np.where(capped <= go, capped,
                   np.where(del_ok | ins_ok, go,
                    np.where(capped <= go + ge, capped, -1)))
            ok = (pen >= 0) | in_flank
            pen = np.where(in_flank, 0, pen)
            done[rows[ok]] = True
            ln[rows[ok]] = -LN10_DIV_10 * pen[ok]
        return tgt, quals, ln, done

    def _device_scores(self, batch, haplotypes, penalties, L, job_hap,
                       job_read, job_pos, job_lens, flank_state, pad, is_rev,
                       tgt, quals):
        with timers.phase("populate_stage"):
            cfg = self.config
            n = len(job_hap)
            W = L + 2 * pad - 1
            offset = np.maximum(job_pos - pad, 0)
            win = np.zeros((n, W), np.int32)
            opn = np.zeros((n, W), np.int32)
            ext = np.zeros((n, W), np.int32)
            mask = np.full((n, W), PAD_CODE, np.int32)
            prior = np.zeros((n, W), np.int32)
            wcol = np.arange(W)
            flank_rows: list[int] = []
            rev_of_job = is_rev[job_read]
            # the host DP discounts the band's columns past the haplotype end as
            # flank, with FlankState(0, 0) when there is no flank state; the
            # device scorer's rows get the same correction, so that no score
            # depends on where its job set ran
            flank = flank_state or FlankState(0, 0)
            for h in np.unique(job_hap):
                p = penalties[h]
                hl = len(p.codes)
                hsel = np.flatnonzero(job_hap == h)
                idx = offset[hsel][:, None] + wcol[None, :]
                over = idx >= hl
                idx = np.minimum(idx, hl - 1)
                # window may run past the haplotype end because of length-bucket
                # padding; overflow cells are unreachable by real-read rows and
                # get neutral fill (N bases, stiff gap penalties)
                win[hsel] = np.where(over, 4, p.codes[idx])
                opn[hsel] = np.where(over, 64, p.gap_open[idx])
                ext[hsel] = np.where(over, 64, p.gap_extend[idx])
                if p.snv_mask_fwd is not None:
                    rev = rev_of_job[hsel]
                    m = np.where(rev[:, None], p.snv_mask_rev[idx], p.snv_mask_fwd[idx])
                    pr = np.where(rev[:, None], p.snv_prior_rev[idx], p.snv_prior_fwd[idx])
                    mask[hsel] = np.where(over, PAD_CODE, m)
                    prior[hsel] = np.where(over, 0, pr)
                in_flank = ((job_pos[hsel] < flank.lhs_flank + pad)
                            | (job_pos[hsel] + job_lens[hsel] + pad
                               > hl - flank.rhs_flank))
                flank_rows.extend(int(k) for k in hsel[in_flank])

        # small job sets run the native host DP instead of paying a device
        # round trip (launch latency >> the few thousand DP cells; the
        # reference's analog is its single-pair SIMD calls)
        if n <= cfg.host_hmm_max:
            rows = np.arange(n)
            with timers.phase("hmm_host_dp"):
                corrected = self._flank_corrected_scores(
                    rows, penalties, job_hap, job_read, job_pos, job_lens,
                    flank, pad, is_rev,
                    tgt.astype(np.int32), quals.astype(np.int32),
                    win, opn, ext, mask, prior, L, W)
            ROUTING.record(self.source, "host_dp", n)
            return -LN10_DIV_10 * corrected.astype(np.float64)

        # one launch for the whole job set, at its real size
        tgt_i = tgt.astype(np.int32)
        qual_i = quals.astype(np.int32)
        with timers.phase("hmm_device"):
            scores = pairhmm_scores(tgt_i, qual_i, win, opn, ext, mask, prior,
                                    pad=pad, nuc_prior=cfg.nuc_prior,
                                    device=self.device).cpu().numpy()
        ROUTING.record(self.source, scorer_name(self.device), n)
        ln = -LN10_DIV_10 * scores.astype(np.float64)

        # flank discount: traceback-and-subtract for reads overlapping flanks
        # (simd_pair_hmm.hpp:352-430), batched through the host extension
        if flank_rows:
            with timers.phase("populate_flank"):
                rows = np.asarray(flank_rows, np.int64)
                corrected = self._flank_corrected_scores(
                    rows, penalties, job_hap, job_read, job_pos, job_lens,
                    flank, pad, is_rev, tgt_i, qual_i,
                    win, opn, ext, mask, prior, L, W)
                ln[rows] = -LN10_DIV_10 * corrected.astype(np.float64)
        return ln

    def _flank_corrected_scores(self, rows, penalties, job_hap, job_read,
                                job_pos, job_lens, flank_state, pad, is_rev,
                                tgt_i, qual_i, win, opn, ext, mask, prior,
                                L, W):
        """Flank-corrected phred scores for the given job rows via the
        native batched banded-align."""
        n = len(rows)
        hap_lens = np.asarray([len(penalties[h].codes)
                               for h in job_hap[rows]], np.int32)
        offsets = np.maximum(job_pos[rows] - pad, 0).astype(np.int64)
        lens = job_lens[rows].astype(np.int32)
        w_rows = lens + 2 * pad - 1
        lhs_w = np.maximum(flank_state.lhs_flank - offsets, 0).astype(np.int32)
        rhs_w = np.maximum(flank_state.rhs_flank + offsets + w_rows
                           - hap_lens, 0).astype(np.int32)
        c = np.ascontiguousarray
        raw = _native.flank_banded_scores(
            int(n), int(L), int(W), int(pad), int(self.config.nuc_prior),
            c(tgt_i[rows]), c(qual_i[rows]), c(win[rows]), c(opn[rows]),
            c(ext[rows]), c(mask[rows]), c(prior[rows]),
            c(lens), c(lhs_w), c(rhs_w))
        return np.frombuffer(raw, np.int32)


def populate_assignment_blocks(jobs, config: LikelihoodConfig | None = None
                               ) -> list[np.ndarray]:
    """Score many small (reads x called-haplotypes) assignment blocks in a
    few merged evaluations.

    jobs: list of (ReadBatch, [hap_codes], [subst_mask], hap_begin, pad).
    Per job the result equals
    ``HaplotypeLikelihoodArray(config).populate([batch], haps, hap_begin,
    substitution_masks=masks, pad=pad).sample_matrix(0)`` — candidate
    anchors, scores and the per-job MQ mixture are identical; the merge
    only amortises per-call host overhead and turns hundreds of micro
    evaluations (one per CSR facet block) into device-sized batches.
    """
    from ...basics.reads import ReadBatch

    arr = HaplotypeLikelihoodArray(config, source="assignment")
    arr._pooled_cap_trig = None
    cfg = arr.config
    results: list = [None] * len(jobs)
    by_pad: dict[int, list[int]] = {}
    for idx, (batch, haps, _masks, _hb, pad) in enumerate(jobs):
        if len(batch) == 0 or not haps:
            results[idx] = np.zeros((len(haps), len(batch)), np.float64)
        else:
            by_pad.setdefault(int(pad), []).append(idx)
    for pad, group in by_pad.items():
        with timers.phase("populate_jobs"):
            merged = ReadBatch.concatenate([jobs[i][0] for i in group])
            read_counts = np.asarray([len(jobs[i][0]) for i in group], np.int64)
            read_base = np.zeros(len(group) + 1, np.int64)
            np.cumsum(read_counts, out=read_base[1:])
            haps_g: list = []
            pens: list = []
            hap_of_job: list[list[int]] = []
            for gi, i in enumerate(group):
                ids = []
                for codes, mask in zip(jobs[i][1], jobs[i][2]):
                    ids.append(len(haps_g))
                    haps_g.append(codes)
                    pens.append(arr._haplotype_penalties(codes, mask))
                hap_of_job.append(ids)
            nh = np.asarray([len(ids) for ids in hap_of_job], np.int64)
            hap_base = np.zeros(len(group) + 1, np.int64)
            np.cumsum(nh, out=hap_base[1:])
            lens = merged.lengths()
            job_of_read = np.repeat(np.arange(len(group)), read_counts)
            hb = np.asarray([jobs[i][3] for i in group], np.int64)
            original = np.maximum(merged.begins - hb[job_of_read], 0)
            is_rev = merged.is_reverse()
            job_hap, job_read, job_pos = _gather_jobs(
                merged.seq, merged.seq_offsets, original, haps_g,
                read_base, hap_base, None, pad,
                lambda h, r: (f"assignment-block haplotype too short "
                              f"(hap {len(haps_g[h])}, "
                              f"job {group[int(job_of_read[r])]})"))
        job_ln = np.full(len(job_hap), -np.inf, np.float64)
        job_lens = lens[job_read]
        bucket = cfg.length_bucket
        job_bucket = -(-job_lens // bucket) * bucket
        for L in np.unique(job_bucket):
            sel = np.flatnonzero(job_bucket == L)
            job_ln[sel] = arr._eval_jobs_fixed_len(
                merged, haps_g, pens, int(L), job_hap[sel], job_read[sel],
                job_pos[sel], job_lens[sel], None, pad, is_rev)
        # scatter into per-job (n_haps, n_reads) matrices through one flat
        # block buffer (max over candidate anchors per pair)
        blk_sizes = nh * read_counts
        blk_base = np.zeros(len(group) + 1, np.int64)
        np.cumsum(blk_sizes, out=blk_base[1:])
        flat = np.full(int(blk_base[-1]), -np.inf, np.float64)
        gi_of_pair = job_of_read[job_read]
        loc_h = job_hap - hap_base[gi_of_pair]
        loc_r = job_read - read_base[gi_of_pair]
        flat_idx = (blk_base[gi_of_pair] + loc_h * read_counts[gi_of_pair]
                    + loc_r)
        np.maximum.at(flat, flat_idx, job_ln)
        for gi, i in enumerate(group):
            out = flat[blk_base[gi]:blk_base[gi + 1]].reshape(
                int(nh[gi]), int(read_counts[gi])).copy()
            if cfg.use_mapping_quality:
                sub = jobs[i][0]
                mq = sub.mapq.astype(np.float64)
                cap, trig = arr._mq_cap_and_trigger(sub)
                if trig is not None and trig < cap:
                    mq = np.where(mq >= trig, cap, mq)
                ln_miss = -LN10_DIV_10 * mq
                ln_mapped = np.log1p(-np.exp(ln_miss))
                a = ln_mapped[None, :] + out
                hi = np.maximum(a, ln_miss[None, :])
                lo = np.minimum(a, ln_miss[None, :])
                out = hi + np.log1p(np.exp(lo - hi))
            out[out > -1e-15] = 0.0
            results[i] = out
    return results


__all__ = [
    "HaplotypeLikelihoodArray",
    "LikelihoodConfig",
    "ROUTING",
    "FlankState",
    "populate_assignment_blocks",
]
