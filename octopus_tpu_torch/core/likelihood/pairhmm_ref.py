"""Reference (host/numpy) banded pair-HMM — the semantic golden model.

Implements the same alignment model as the reference's SIMD kernel
(src/core/models/pairhmm/simd_pair_hmm.hpp:240-324) and frontend
(src/core/models/pairhmm/pair_hmm.hpp): a banded glocal Viterbi in integer
phred space over three states M/I/D, where

* the read (target) must be explained end-to-end,
* the haplotype (truth) window start/end are free within a band of
  D = 2*pad diagonals (pad == the reference's band_size, default 8),
* match cost: 0 if equal; else min(base quality, SNV-context cap) or the
  N score (2) when the truth base is N,
* insertion: gap_open/gap_extend at the preceding truth position + nuc_prior
  (no D->I), deletion: gap_open/gap_extend at the deleted truth position
  (I->D allowed),
* the final score converts to ln-likelihood via -ln(10)/10 * score, with the
  flank portion of the optimal path discounted when the read overlaps the
  truth flanks (pair_hmm.hpp:694-766).

The DP here runs row-by-row over read positions with the band as a vector of
diagonals — the same formulation the Pallas TPU kernel uses — rather than the
reference's interleaved anti-diagonal half-steps; the recurrences are
algebraically identical.

This module is used for: unit-test ground truth of the device kernel, the
traceback/align path (read realignment, evidence BAMs, read assignment,
de novo checks).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

from ..._build import NATIVE as _native
from ...basics.phred import LN10_DIV_10
from ...basics.sequence import N

INF = np.int32(1 << 29)
N_SCORE = 2          # phred cost of aligning against truth 'N'
DEFAULT_NUC_PRIOR = 2
DEFAULT_PAD = 8      # == reference band_size for max_indel_error=8
MAX_QUALITY = 64     # padding quality used by the reference kernel


@dataclass
class HmmParams:
    """Per-haplotype penalty tracks (full haplotype length)."""

    gap_open: np.ndarray        # int16 (L,)
    gap_extend: np.ndarray      # int16 (L,)
    snv_mask: np.ndarray | None = None    # uint8 codes (L,)
    snv_prior: np.ndarray | None = None   # int16 (L,)
    nuc_prior: int = DEFAULT_NUC_PRIOR
    lhs_flank: int = 0
    rhs_flank: int = 0


class Alignment(NamedTuple):
    score: int
    first_pos: int          # window-relative truth position of alignment start
    ops: str                # 'M'/'I'/'D' per aligned op (start -> end)


def match_costs(
    target: np.ndarray,
    quals: np.ndarray,
    truth_win: np.ndarray,
    snv_mask_win: np.ndarray | None,
    snv_prior_win: np.ndarray | None,
) -> np.ndarray:
    """(R, W) matrix of match penalties between target[y] and window[x]."""
    t = target[:, None].astype(np.int32)
    w = truth_win[None, :].astype(np.int32)
    q = quals[:, None].astype(np.int32)
    if snv_mask_win is not None:
        capped = np.where(
            snv_mask_win[None, :].astype(np.int32) == t,
            np.minimum(q, snv_prior_win[None, :].astype(np.int32)),
            q,
        )
    else:
        capped = q
    pen = np.where(t == w, 0, capped).astype(np.int32)
    pen = np.where(w == N, np.minimum(pen, N_SCORE), pen)
    return pen


def banded_score(
    truth_win: np.ndarray,
    target: np.ndarray,
    quals: np.ndarray,
    gap_open_win: np.ndarray,
    gap_extend_win: np.ndarray,
    snv_mask_win: np.ndarray | None = None,
    snv_prior_win: np.ndarray | None = None,
    nuc_prior: int = DEFAULT_NUC_PRIOR,
    pad: int = DEFAULT_PAD,
) -> int:
    """Banded Viterbi min-penalty; truth_win must be len(target) + 2*pad - 1."""
    R = len(target)
    D = 2 * pad
    W = R + 2 * pad - 1
    assert len(truth_win) == W, (len(truth_win), W)
    cm = match_costs(target, quals, truth_win, snv_mask_win, snv_prior_win)
    opn = gap_open_win.astype(np.int32)
    ext = gap_extend_win.astype(np.int32)
    d_idx = np.arange(D)

    M = np.zeros(D, dtype=np.int32)          # y=0: fresh start at any diagonal
    # Parity quirk inherited from the reference's interleaved half-step SIMD
    # (simd_pair_hmm.hpp:271-320): a fresh start at an EVEN truth offset gets
    # its match cost added before the I/D transitions read it, so gap ops can
    # only begin an alignment from ODD start offsets.  M_gap is the row-0 M
    # visible to gap transitions.
    M_gap = np.where(d_idx % 2 == 1, 0, INF).astype(np.int32)
    Ii = np.full(D, INF, dtype=np.int32)
    Dd = np.full(D, INF, dtype=np.int32)
    # start-with-deletion chain (y=0): D[0][d] over x-1 = d-1
    for d in range(1, D):
        Dd[d] = min(M_gap[d - 1] + opn[d - 1], Dd[d - 1] + ext[d - 1])

    for y in range(1, R + 1):
        x_im1 = y - 1 + d_idx                      # truth index for this row's ops
        Mn = cm[y - 1, x_im1] + np.minimum(np.minimum(M, Ii), Dd)
        # insertion from previous row, diagonal d+1
        M_for_gap = M_gap if y == 1 else M
        Mp_s = np.concatenate((M_for_gap[1:], [INF]))
        Ip_s = np.concatenate((Ii[1:], [INF]))
        In = nuc_prior + np.minimum(Mp_s + opn[x_im1], Ip_s + ext[x_im1])
        # deletion: in-row tropical prefix chain
        Dn = np.full(D, INF, dtype=np.int32)
        base = np.minimum(Mn, In)
        for d in range(1, D):
            Dn[d] = min(base[d - 1] + opn[y + d - 1], Dn[d - 1] + ext[y + d - 1])
        M, Ii, Dd = Mn, In, Dn

    return int(min(M.min(), Ii.min(), Dd.min()))


def banded_align(
    truth_win: np.ndarray,
    target: np.ndarray,
    quals: np.ndarray,
    gap_open_win: np.ndarray,
    gap_extend_win: np.ndarray,
    snv_mask_win: np.ndarray | None = None,
    snv_prior_win: np.ndarray | None = None,
    nuc_prior: int = DEFAULT_NUC_PRIOR,
    pad: int = DEFAULT_PAD,
) -> Alignment:
    """Banded Viterbi with traceback.

    Tie-breaking prefers M over I over D (as the reference's label packing
    does).  Returns window-relative start position and op string. The host
    extension's banded_traceback runs the DP; _banded_align_py is its numpy
    form cell for cell, which tests hold it to.
    """
    R = len(target)
    W = R + 2 * pad - 1
    assert len(truth_win) == W
    cm = match_costs(target, quals, truth_win, snv_mask_win, snv_prior_win)
    opn = gap_open_win.astype(np.int32)
    ext = gap_extend_win.astype(np.int32)
    if R > 0:
        score, first_pos, ops = _native.banded_traceback(
            np.ascontiguousarray(cm, np.int32), np.ascontiguousarray(opn),
            np.ascontiguousarray(ext), R, pad, int(nuc_prior))
        return Alignment(score, first_pos, ops.decode())
    return _banded_align_py(cm, opn, ext, R, nuc_prior, pad)


def _banded_align_py(cm, opn, ext, R, nuc_prior, pad) -> Alignment:
    D = 2 * pad

    # state tables (R+1, D); backpointers: predecessor state 0=M,1=I,2=D,3=START
    Mt = np.full((R + 1, D), INF, dtype=np.int32)
    It = np.full((R + 1, D), INF, dtype=np.int32)
    Dt = np.full((R + 1, D), INF, dtype=np.int32)
    Mb = np.zeros((R + 1, D), dtype=np.int8)
    Ib = np.zeros((R + 1, D), dtype=np.int8)
    Db = np.zeros((R + 1, D), dtype=np.int8)

    Mt[0] = 0
    Mb[0] = 3
    # gap ops may only start from odd offsets (see banded_score)
    m0_gap = np.where(np.arange(D) % 2 == 1, 0, INF).astype(np.int32)
    for d in range(1, D):
        via_open = m0_gap[d - 1] + opn[d - 1]
        via_ext = Dt[0, d - 1] + ext[d - 1]
        if via_open <= via_ext:
            Dt[0, d] = via_open
            Db[0, d] = 0
        else:
            Dt[0, d] = via_ext
            Db[0, d] = 2

    for y in range(1, R + 1):
        m_gap_row = m0_gap if y == 1 else Mt[y - 1]
        for d in range(D):
            x_im1 = y - 1 + d
            # match
            cands = (Mt[y - 1, d], It[y - 1, d], Dt[y - 1, d])
            k = int(np.argmin(cands))
            Mt[y, d] = cm[y - 1, x_im1] + cands[k]
            Mb[y, d] = k
            # insertion
            if d + 1 < D:
                via_open = m_gap_row[d + 1] + opn[x_im1]
                via_ext = It[y - 1, d + 1] + ext[x_im1]
                if via_open <= via_ext:
                    It[y, d] = nuc_prior + via_open
                    Ib[y, d] = 0
                else:
                    It[y, d] = nuc_prior + via_ext
                    Ib[y, d] = 1
            # deletion (uses this row's M/I at d-1)
            if d > 0:
                x_del = y + d - 1
                cands_d = (
                    Mt[y, d - 1] + opn[x_del],
                    It[y, d - 1] + opn[x_del],
                    Dt[y, d - 1] + ext[x_del],
                )
                kd = int(np.argmin(cands_d))
                Dt[y, d] = cands_d[kd]
                Db[y, d] = kd

    finals = np.stack((Mt[R], It[R], Dt[R]))
    flat = int(np.argmin(finals))
    state, d = flat // D, flat % D
    score = int(finals[state, d])

    # traceback; the start cell is (state=M, y=0, d=start diagonal)
    ops: list[str] = []
    y = R
    while not (y == 0 and state == 0):
        if state == 0:  # M consumed t[y-1], w[y-1+d]; predecessor at (y-1, d)
            state = Mb[y, d]
            ops.append("M")
            y -= 1
        elif state == 1:  # I consumed t[y-1]; predecessor at (y-1, d+1)
            state = Ib[y, d]
            ops.append("I")
            y -= 1
            d += 1
        else:  # D consumed w[y+d-1]; predecessor at (y, d-1)
            state = Db[y, d]
            ops.append("D")
            d -= 1
    ops.reverse()
    first_pos = 0 + d  # x at start cell (y=0, d)
    return Alignment(score, first_pos, "".join(ops))


# ---------------------------------------------------------------------------
# Frontend: evaluate with naive shortcuts, flank discount, MQ mixture
# (mirrors pair_hmm.hpp evaluate/simd_evaluate + haplotype_likelihood_model).
# ---------------------------------------------------------------------------

def try_naive_evaluate(
    truth: np.ndarray,
    target: np.ndarray,
    quals: np.ndarray,
    target_offset: int,
    params: HmmParams,
) -> tuple[float, bool]:
    """Fast path for (near-)perfect alignments (pair_hmm.hpp:278-319)."""
    R = len(target)
    window = truth[target_offset:target_offset + R]
    if len(window) < R:
        return 0.0, False
    mism = np.flatnonzero(window != target)
    if len(mism) == 0:
        return 0.0, True
    if len(mism) == 1:
        i = int(mism[0])
        truth_idx = target_offset + i
        if params.lhs_flank or params.rhs_flank:
            if truth_idx < params.lhs_flank or truth_idx >= len(truth) - params.rhs_flank:
                return 0.0, True
        q = int(quals[i])
        if params.snv_mask is not None and params.snv_mask[truth_idx] == target[i]:
            q = min(q, int(params.snv_prior[truth_idx]))
        gap_open = int(params.gap_open[truth_idx])
        if q <= gap_open:
            return -LN10_DIV_10 * q, True
        # single-base-shift checks (deletion/insertion of one base)
        if np.array_equal(target[i + 1:], truth[truth_idx:truth_idx + (R - i - 1)]):
            return -LN10_DIV_10 * gap_open, True
        if np.array_equal(target[i:], truth[truth_idx + 1:truth_idx + 1 + (R - i)]):
            return -LN10_DIV_10 * gap_open, True
        if q <= gap_open + int(params.gap_extend[truth_idx]):
            return -LN10_DIV_10 * q, True
    return 0.0, False


def _windows(truth: np.ndarray, params: HmmParams, offset: int, W: int):
    sl = slice(offset, offset + W)
    return (
        truth[sl],
        params.gap_open[sl],
        params.gap_extend[sl],
        None if params.snv_mask is None else params.snv_mask[sl],
        None if params.snv_prior is None else params.snv_prior[sl],
    )


def flank_score_of_path(
    aln: Alignment,
    target: np.ndarray,
    quals: np.ndarray,
    truth_win: np.ndarray,
    gap_open_win: np.ndarray,
    gap_extend_win: np.ndarray,
    snv_mask_win: np.ndarray | None,
    snv_prior_win: np.ndarray | None,
    lhs_flank: int,
    rhs_flank: int,
    nuc_prior: int,
    window_len: int,
) -> tuple[int, int]:
    """(flank_score, target_mask_size): penalty accumulated within the flanks
    along the alignment path (simd_pair_hmm.hpp:352-430)."""
    truth_idx = aln.first_pos
    target_idx = 0
    score = 0
    mask = 0
    rhs_begin = window_len - rhs_flank
    prev = "M"
    for op in aln.ops:
        in_flank = truth_idx < lhs_flank or truth_idx >= rhs_begin
        if op == "M":
            if in_flank:
                t, w = int(target[target_idx]), int(truth_win[truth_idx])
                if t != w:
                    if w == N:
                        score += N_SCORE
                    else:
                        q = int(quals[target_idx])
                        if snv_mask_win is not None and int(snv_mask_win[truth_idx]) == t:
                            q = min(q, int(snv_prior_win[truth_idx]))
                        score += q
                mask += 1
            truth_idx += 1
            target_idx += 1
        elif op == "I":
            if in_flank:
                if prev == "I":
                    score += int(gap_extend_win[truth_idx - 1]) + nuc_prior
                else:
                    score += int(gap_open_win[truth_idx - 1]) + nuc_prior
                mask += 1
            target_idx += 1
        else:  # D
            if in_flank:
                if prev == "D":
                    score += int(gap_extend_win[truth_idx])
                else:
                    score += int(gap_open_win[truth_idx])
            truth_idx += 1
        prev = op
    return score, mask


def hmm_evaluate(
    truth: np.ndarray,
    target: np.ndarray,
    quals: np.ndarray,
    target_offset: int,
    params: HmmParams,
    pad: int = DEFAULT_PAD,
) -> float:
    """ln p(target | truth, mapped at ~target_offset); naive shortcut first."""
    value, ok = try_naive_evaluate(truth, target, quals, target_offset, params)
    if ok:
        return value
    R = len(target)
    W = R + 2 * pad - 1
    offset = max(0, target_offset - pad)
    if offset + W > len(truth):
        return -np.inf
    truth_win, opn_win, ext_win, mask_win, prior_win = _windows(truth, params, offset, W)
    overlaps_flank = (
        (params.lhs_flank or params.rhs_flank)
        and (
            target_offset < params.lhs_flank + pad
            or target_offset + R + pad > len(truth) - params.rhs_flank
        )
    )
    if not overlaps_flank:
        score = banded_score(
            truth_win, target, quals, opn_win, ext_win, mask_win, prior_win,
            nuc_prior=params.nuc_prior, pad=pad,
        )
        return -LN10_DIV_10 * score
    aln = banded_align(
        truth_win, target, quals, opn_win, ext_win, mask_win, prior_win,
        nuc_prior=params.nuc_prior, pad=pad,
    )
    lhs = max(0, params.lhs_flank - offset)
    rhs = max(0, params.rhs_flank + offset + W - len(truth))
    fscore, mask_size = flank_score_of_path(
        aln, target, quals, truth_win, opn_win, ext_win, mask_win, prior_win,
        lhs, rhs, params.nuc_prior, W,
    )
    if R - mask_size < 2:
        fscore = 0
    return -LN10_DIV_10 * (aln.score - fscore)


def is_in_range(position: int, read_len: int, hap_len: int, pad: int = DEFAULT_PAD) -> bool:
    return position >= pad and position + read_len + pad <= hap_len


def evaluate_read(
    truth: np.ndarray,
    target: np.ndarray,
    quals: np.ndarray,
    mapping_positions: list[int],
    original_position: int,
    params: HmmParams,
    mapping_quality: int | None = None,
    pad: int = DEFAULT_PAD,
    mapping_quality_cap: int = 120,
    mapping_quality_cap_trigger: int | None = None,
) -> float:
    """Full per-read likelihood: max over candidate anchors + MQ mixture
    (haplotype_likelihood_model.cpp:211-304)."""
    best = -np.inf
    saw_original = False
    any_in_range = False
    for pos in mapping_positions:
        if pos == original_position:
            saw_original = True
        if is_in_range(pos, len(target), len(truth), pad):
            any_in_range = True
            best = max(best, hmm_evaluate(truth, target, quals, pos, params, pad))
    if not saw_original and is_in_range(original_position, len(target), len(truth), pad):
        any_in_range = True
        best = max(best, hmm_evaluate(truth, target, quals, original_position, params, pad))
    if not any_in_range:
        pos = original_position
        shift_needed = 0
        if pos < pad:
            shift_needed = pad - pos
            pos += shift_needed
        else:
            over = pos + len(target) + pad - len(truth)
            if over > 0:
                pos -= over
        if not is_in_range(pos, len(target), len(truth), pad) or pos < 0:
            raise ValueError("haplotype too short for alignment")
        best = hmm_evaluate(truth, target, quals, pos, params, pad)
    if mapping_quality is not None:
        mq = mapping_quality
        if mapping_quality_cap_trigger is not None and mq >= mapping_quality_cap_trigger:
            mq = mapping_quality_cap
        ln_missmapped = -LN10_DIV_10 * mq
        ln_mapped = np.log1p(-np.exp(ln_missmapped))
        hi = max(ln_mapped + best, ln_missmapped)
        lo = min(ln_mapped + best, ln_missmapped)
        best = hi + np.log1p(np.exp(lo - hi))
    return 0.0 if best > -1e-15 else float(best)


__all__ = [
    "HmmParams",
    "Alignment",
    "match_costs",
    "banded_score",
    "banded_align",
    "try_naive_evaluate",
    "hmm_evaluate",
    "evaluate_read",
    "flank_score_of_path",
    "is_in_range",
    "INF",
    "DEFAULT_PAD",
    "DEFAULT_NUC_PRIOR",
]
