"""Read-to-haplotype assignment and realignment.

Capability-equivalent to the reference's ReadAssigner + ReadRealigner
(src/core/tools/read_assigner.{hpp,cpp}, read_realigner.{hpp,cpp}): assign
each read to the haplotype of the called genotype with the highest
likelihood (ties -> ambiguous policy), realign it to that haplotype with the
banded HMM traceback, and lift the alignment back to reference coordinates
through the haplotype's variant structure.  Drives the evidence-BAM output
(--bamout, bam_realigner.hpp) and the CSR read-assignment facets.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...basics import cigar as cg
from ...basics.reads import ReadBatch
from ..likelihood.likelihood_array import HaplotypeLikelihoodArray, LikelihoodConfig
from ..likelihood import pairhmm_ref as ph
from ..likelihood.error_models import make_error_models
from ..types.haplotypes import Haplotype


@dataclass
class Assignment:
    hap_of_read: np.ndarray      # (n_reads,) haplotype index, -1 ambiguous
    support: dict[int, np.ndarray]  # hap -> read indices
    log_likelihoods: np.ndarray | None = None  # (n_reads,) best-hap lnL
    # (n_unique, n_reads) bool, rows in `support`'s key order: the
    # haplotypes within the margin of each read's best (its tie set; more
    # than one row for an ambiguous read), as the reference keeps an
    # AmbiguousRead's haplotypes (read_assigner.hpp:63-91)
    ties: np.ndarray | None = None


def _assignment_from_matrix(lnL: np.ndarray, unique_haps: list[int],
                            ambiguous_margin: float = 1e-9) -> Assignment:
    """(n_unique, n_reads) likelihood matrix -> Assignment (argmax with
    tie -> ambiguous policy; each read's tie set kept)."""
    best = np.argmax(lnL, axis=0)
    ties = (lnL.max(axis=0)[None, :] - lnL) <= ambiguous_margin
    hap_of_read = np.asarray(unique_haps, np.int64)[best]
    hap_of_read[ties.sum(axis=0) > 1] = -1
    support = {h: np.flatnonzero(hap_of_read == h) for h in unique_haps}
    best_lnl = lnL[best, np.arange(lnL.shape[1])]
    return Assignment(hap_of_read, support, best_lnl, ties)


def _assignment_model_config(scoring: LikelihoodConfig | None = None
                             ) -> LikelihoodConfig:
    """The reference's make_default_haplotype_likelihood_model for read
    assignment (read_assigner.cpp:366-373): NO mapping-quality mixture (the
    mismap floor would tie every fragment of a noisy long read — raw HMM
    scores must discriminate), max_indel_error=8, no flank state.

    `scoring` is the run's LikelihoodConfig: assignment scores on its
    device with its host-DP gate (LikelihoodConfig's defaults without one)."""
    base = scoring or LikelihoodConfig()
    return LikelihoodConfig(use_mapping_quality=False, max_indel_error=8,
                            use_flank_state=False, device=base.device,
                            host_hmm_max=base.host_hmm_max)


def assign_reads(batch: ReadBatch, haplotypes: list[Haplotype],
                 genotype: list[int], hap_begin: int,
                 config: LikelihoodConfig | None = None,
                 ambiguous_margin: float = 1e-9,
                 scoring: LikelihoodConfig | None = None) -> Assignment:
    """Assign reads to the haplotypes of a called genotype by likelihood
    (`config` is the assignment model; without one, the reference's, on
    the device of `scoring`)."""
    from ..likelihood.likelihood_array import select_band
    unique_haps = sorted(set(genotype))
    cfg = config or _assignment_model_config(scoring)
    arr = HaplotypeLikelihoodArray(cfg, source="assignment")
    seqs = [haplotypes[h].sequence for h in unique_haps]
    masks = [haplotypes[h].substitution_mask() for h in unique_haps]
    # band from the called haplotypes' own indels: SNV-only blocks keep the
    # narrow warmed kernel (select_band)
    band = select_band([v for h in unique_haps
                        for v in haplotypes[h].variants],
                       cfg.max_indel_error)
    arr.populate([batch], seqs, hap_begin, substitution_masks=masks,
                 pad=band)
    lnL = arr.sample_matrix(0)           # (n_unique, n_reads)
    return _assignment_from_matrix(lnL, unique_haps, ambiguous_margin)


def assign_reads_grouped(jobs, config: LikelihoodConfig | None = None,
                         ambiguous_margin: float = 1e-9,
                         scoring: LikelihoodConfig | None = None
                         ) -> list[Assignment]:
    """Batch form of assign_reads over many independent blocks.

    jobs: list of (batch, haplotypes, hap_begin) — every haplotype of each
    job participates (the CSR ReadAssignments facet's shape).  Scores are
    identical to per-job assign_reads; the merged evaluation amortises the
    per-block host overhead (one merged evaluation per band instead of one
    per facet block) and produces device-sized batches.
    """
    from ..likelihood.likelihood_array import (
        populate_assignment_blocks, select_band)
    cfg = config or _assignment_model_config(scoring)
    packed = []
    for batch, haplotypes, hap_begin in jobs:
        seqs = [h.sequence for h in haplotypes]
        masks = [h.substitution_mask() for h in haplotypes]
        band = select_band([v for h in haplotypes for v in h.variants],
                           cfg.max_indel_error)
        packed.append((batch, seqs, masks, hap_begin, band))
    mats = populate_assignment_blocks(packed, cfg)
    return [_assignment_from_matrix(lnL, list(range(len(haplotypes))),
                                    ambiguous_margin)
            for (batch, haplotypes, _), lnL in zip(jobs, mats)]


def realign_read_to_haplotype(batch: ReadBatch, read_idx: int,
                              hap: Haplotype, pad: int = 8,
                              nuc_prior: int = 2, penalties=None):
    """(new_ref_begin, new_cigar) for one read realigned via the haplotype.

    The read aligns to the haplotype with the banded HMM traceback; the
    haplotype->reference CIGAR lifts coordinates back (read_realigner.cpp
    realign_to_reference). `penalties` are the haplotype's indel penalties
    (haplotype_penalties), for a caller that realigns many reads to it."""
    seq = batch.sequence(read_idx)
    quals = batch.qualities(read_idx)
    pen = haplotype_penalties(hap) if penalties is None else penalties
    offset = max(int(batch.begins[read_idx]) - hap.begin, 0)
    aln_offset = max(0, offset - pad)
    W = len(seq) + 2 * pad - 1
    if aln_offset + W > len(hap.sequence):
        aln_offset = max(0, len(hap.sequence) - W)
    if aln_offset < 0 or aln_offset + W > len(hap.sequence):
        return int(batch.begins[read_idx]), batch.cigar(read_idx)
    sl = slice(aln_offset, aln_offset + W)
    aln = ph.banded_align(
        hap.sequence[sl], seq, quals,
        pen.gap_open[sl], pen.gap_extend[sl],
        nuc_prior=nuc_prior, pad=pad,
    )
    hap_pos = aln_offset + aln.first_pos     # position on haplotype
    # read->haplotype cigar from the op string
    ops = []
    for op in aln.ops:
        code = {"M": cg.M, "I": cg.I, "D": cg.D}[op]
        if ops and ops[-1][1] == code:
            ops[-1][0] += 1
        else:
            ops.append([1, code])
    read_hap_cigar = np.asarray(ops, np.int32).reshape(-1, 2)
    return lift_to_reference(hap, hap_pos, read_hap_cigar)


def haplotype_penalties(hap: Haplotype):
    """The default indel error model's gap penalties along `hap`."""
    return make_error_models()[1].set_penalties(hap.sequence)


def lift_to_reference(hap: Haplotype, hap_pos: int, read_cigar: np.ndarray):
    """Compose read->haplotype alignment with haplotype->reference CIGAR."""
    # expand haplotype cigar to per-haplotype-base reference deltas
    ref_pos = hap.begin
    hp = 0
    # haplotype base -> (ref_pos, is_insertion)
    hap_ref = np.zeros(len(hap.sequence) + 1, np.int64)
    hap_ins = np.zeros(len(hap.sequence) + 1, bool)
    events = []   # (hap_index, deleted_ref_len_after)
    del_after = np.zeros(len(hap.sequence) + 1, np.int64)
    for length, op in hap.cigar:
        length = int(length)
        if op in (cg.EQ, cg.X, cg.M):
            for k in range(length):
                hap_ref[hp + k] = ref_pos + k
            hp += length
            ref_pos += length
        elif op == cg.I:
            for k in range(length):
                hap_ref[hp + k] = ref_pos
                hap_ins[hp + k] = True
            hp += length
        elif op == cg.D:
            del_after[hp] += length
            ref_pos += length
    hap_ref[hp] = ref_pos
    # walk the read->haplotype cigar, emitting reference-space ops
    out: list[list[int]] = []

    def push(n, op):
        if n <= 0:
            return
        if out and out[-1][1] == op:
            out[-1][0] += n
        else:
            out.append([n, op])

    h = hap_pos
    new_begin = None
    for length, op in read_cigar:
        length = int(length)
        if op == cg.M:
            for _ in range(length):
                if del_after[h] and out:
                    push(int(del_after[h]), cg.D)
                if hap_ins[h]:
                    push(1, cg.I)
                else:
                    if new_begin is None:
                        new_begin = int(hap_ref[h])
                    push(1, cg.M)
                h += 1
        elif op == cg.I:
            push(length, cg.I)
        elif op == cg.D:
            for _ in range(length):
                if del_after[h] and out:
                    push(int(del_after[h]), cg.D)
                if not hap_ins[h]:
                    push(1, cg.D)
                h += 1
    if new_begin is None:
        new_begin = int(hap_ref[hap_pos])
    # leading insertions become soft clips
    if out and out[0][1] == cg.I:
        out[0][1] = cg.S
    if out and out[-1][1] == cg.I:
        out[-1][1] = cg.S
    return new_begin, np.asarray(out, np.int32).reshape(-1, 2)


__all__ = ["assign_reads", "realign_read_to_haplotype", "lift_to_reference", "Assignment"]
