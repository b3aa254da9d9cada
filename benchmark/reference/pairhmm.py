"""The plain pair-HMM: the banded Viterbi of the reference SSE2 kernel in
phred integers, in NumPy, vectorised over pairs.

The model (octopus's src/core/models/pairhmm/simd_pair_hmm.hpp and
pair_hmm.hpp): a glocal alignment of a read (the target) against a window
of the haplotype W = R + 2*pad - 1 wide, kept in a band of D = 2*pad
diagonals, over three states M, I and D:

* match cost 0 where the bases agree, else the base quality, capped by the
  SNV prior where the window's SNV mask equals the read base; against an N
  in the window at most 2;
* an insertion opens or extends at the window position before it, plus the
  nucleotide prior; a deletion opens or extends at the deleted position; a
  deletion may follow an insertion, an insertion no deletion;
* row 0 starts anywhere, and a gap may open from row 0 only at an odd
  diagonal (the reference's interleaved half steps);
* the score is the least over the states and diagonals of the read's last
  row. Where the read overlaps the haplotype's flanks, the flank part of
  the best path (ties broken M before I before D, the lowest diagonal
  first) is taken off again, unless fewer than two read bases lie outside
  the flanks (pair_hmm.hpp:735-766, simd_pair_hmm.hpp:352-430).

`banded_scores` is the score of padded rows (what a card launch returns);
`flank_scores` the score of each row at its own length with the flank
discount (what the host DP returns). Both take the tracks the program
passed in, as int32 arrays. `dtype` and `inf` give the control: the same
recurrences in a narrower integer, saturating at the type's top.
"""

from __future__ import annotations

import numpy as np

INF = 1 << 29
N_CODE = 4
N_SCORE = 2


class _Arith:
    """Adds and constants in one integer type: int64 exact, or a narrow
    type whose adds saturate at `top` (the control)."""

    def __init__(self, dtype, inf: int | None):
        self.dtype = np.dtype(dtype)
        self.exact = self.dtype == np.int64
        self.top = inf if inf is not None else INF
        self.inf = INF if self.exact else self.top

    def cast(self, a):
        a = np.asarray(a, np.int64)
        if self.exact:
            return a
        return np.minimum(a, self.top).astype(self.dtype)

    def add(self, a, b):
        if self.exact:
            return a + b
        s = a.astype(np.int64) + b
        return np.minimum(s, self.top).astype(self.dtype)


def _match_cost(ar, t, q, w, m, p):
    pen = np.where(t == w, 0, np.where(m == t, np.minimum(q, p), q))
    pen = np.where((w == N_CODE) & (pen > N_SCORE), N_SCORE, pen)
    return ar.cast(pen)


def _dp(tgt, qual, win, opn, ext, mask, prior, pad, nuc_prior, stop,
        ar, keep_paths):
    """Run the band DP of n pairs over rows 1..max(stop); return the
    (3, n, D) states at each pair's row `stop` and, with keep_paths, the
    backpointers (rows, 3, n, D) int8."""
    n = tgt.shape[0]
    D = 2 * pad
    inf = ar.inf
    dd = np.arange(D)
    rows_needed = int(stop.max()) if n else 0
    gap0 = ar.cast(np.where(dd % 2 == 1, 0, inf))             # row-0 M for gaps
    M = ar.cast(np.zeros((n, D)))
    I = ar.cast(np.full((n, D), inf))
    Dl = ar.cast(np.full((n, D), inf))
    back = (np.zeros((rows_needed + 1, 3, n, D), np.int8) if keep_paths
            else None)
    for d in range(1, D):
        vo = ar.add(gap0[d - 1], ar.cast(opn[:, d - 1]))
        ve = ar.add(Dl[:, d - 1], ar.cast(ext[:, d - 1]))
        Dl[:, d] = np.minimum(vo, ve)
        if keep_paths:
            back[0, 2, :, d] = np.where(vo <= ve, 0, 2)
    final = np.zeros((3, n, D), ar.dtype)
    at0 = stop == 0
    final[:, at0] = np.stack((M, I, Dl))[:, at0]
    for y in range(1, rows_needed + 1):
        x = y - 1 + dd                                        # (D,)
        t = tgt[:, y - 1][:, None]
        q = qual[:, y - 1][:, None]
        cm = _match_cost(ar, t, q, win[:, x], mask[:, x], prior[:, x])
        # match from (y-1, d): ties M, then I, then D
        k = np.where(I < M, 1, 0)
        best = np.minimum(M, I)
        k = np.where(Dl < best, 2, k)
        best = np.minimum(best, Dl)
        Mn = ar.add(cm, best)
        # insertion from (y-1, d+1)
        Mprev = np.broadcast_to(gap0, M.shape) if y == 1 else M
        o = ar.cast(opn[:, x[:-1]])
        e = ar.cast(ext[:, x[:-1]])
        vo = ar.add(Mprev[:, 1:], o)
        ve = ar.add(I[:, 1:], e)
        In = np.empty_like(I)
        In[:, :-1] = ar.add(np.minimum(vo, ve), nuc_prior)
        In[:, -1] = inf
        # deletion along the row: from (y, d-1)
        Dn = np.empty_like(Dl)
        Dn[:, 0] = inf
        kd = np.zeros((n, D), np.int8) if keep_paths else None
        for d in range(1, D):
            od = ar.cast(opn[:, y + d - 1])
            c0 = ar.add(Mn[:, d - 1], od)
            c1 = ar.add(In[:, d - 1], od)
            c2 = ar.add(Dn[:, d - 1], ar.cast(ext[:, y + d - 1]))
            b = np.minimum(c0, c1)
            Dn[:, d] = np.minimum(b, c2)
            if keep_paths:
                kk = np.where(c1 < c0, 1, 0)
                kd[:, d] = np.where(c2 < b, 2, kk)
        if keep_paths:
            back[y, 0] = k
            back[y, 1, :, :-1] = np.where(vo <= ve, 0, 1)
            back[y, 2] = kd
        M, I, Dl = Mn, In, Dn
        here = stop == y
        if here.any():
            final[:, here] = np.stack((M, I, Dl))[:, here]
    return final, back


def banded_scores(tgt, qual, win, opn, ext, mask, prior, *, pad: int,
                  nuc_prior: int, dtype=np.int64, inf: int | None = None
                  ) -> np.ndarray:
    """(B,) scores of batch-major tracks: tgt/qual (B, R), the window
    tracks (B, R + 2*pad - 1); every row scored to R."""
    ar = _Arith(dtype, inf)
    tgt = np.asarray(tgt)
    stop = np.full(tgt.shape[0], tgt.shape[1], np.int64)
    final, _ = _dp(tgt, qual, win, opn, ext, mask, prior, pad, nuc_prior,
                   stop, ar, False)
    return final.min(axis=(0, 2)).astype(np.int64)


def flank_scores(tgt, qual, win, opn, ext, mask, prior, lens, lhs, rhs, *,
                 pad: int, nuc_prior: int, dtype=np.int64,
                 inf: int | None = None) -> np.ndarray:
    """(n,) flank-discounted scores: row k scored over its first lens[k]
    read bases and lens[k] + 2*pad - 1 window columns; lhs[k] and rhs[k]
    the flank widths at the two ends of that window."""
    ar = _Arith(dtype, inf)
    tgt = np.asarray(tgt)
    n = tgt.shape[0]
    D = 2 * pad
    lens = np.asarray(lens, np.int64)
    lhs = np.asarray(lhs, np.int64)
    rhs = np.asarray(rhs, np.int64)
    final, back = _dp(tgt, qual, win, opn, ext, mask, prior, pad, nuc_prior,
                      lens, ar, True)
    flat = final.transpose(1, 0, 2).reshape(n, 3 * D)
    first = flat.argmin(axis=1)                  # state-major, lowest d
    score = flat[np.arange(n), first].astype(np.int64)
    state = first // D
    d = first % D
    y = lens.copy()
    rows = np.arange(n)
    wr = lens + 2 * pad - 1
    rhs_begin = wr - rhs
    fscore = np.zeros(n, np.int64)
    masked = np.zeros(n, np.int64)
    opn = np.asarray(opn, np.int64)
    ext = np.asarray(ext, np.int64)
    active = ~((y == 0) & (state == 0))
    while active.any():
        a = np.flatnonzero(active)
        st, ya, da = state[a], y[a], d[a]
        prev = back[ya, st, a, da].astype(np.int64)
        # the cell's op, at truth index ti and read index yi = y - 1
        ti = np.where(st == 0, ya - 1 + da, np.where(st == 1, ya + da, ya + da - 1))
        in_flank = (ti < lhs[a]) | (ti >= rhs_begin[a])
        yi = np.maximum(ya - 1, 0)
        t = tgt[a, yi].astype(np.int64)
        tic = np.clip(ti, 0, win.shape[1] - 1)
        w = win[a, tic].astype(np.int64)
        q = qual[a, yi].astype(np.int64)
        q = np.where(mask[a, tic] == t, np.minimum(q, prior[a, tic]), q)
        cost_m = np.where(t != w, np.where(w == N_CODE, N_SCORE, q), 0)
        gap_at = np.clip(ya + da - 1, 0, opn.shape[1] - 1)
        cost_i = np.where(prev == 1, ext[a, gap_at], opn[a, gap_at]) + nuc_prior
        cost_d = np.where(prev == 2, ext[a, gap_at], opn[a, gap_at])
        cost = np.where(st == 0, cost_m, np.where(st == 1, cost_i, cost_d))
        fscore[a] += np.where(in_flank, cost, 0)
        masked[a] += np.where(in_flank & (st != 2), 1, 0)
        # step to the predecessor cell
        y[a] = np.where(st == 2, ya, ya - 1)
        d[a] = np.where(st == 1, da + 1, np.where(st == 2, da - 1, da))
        state[a] = prev
        active[a] = ~((y[a] == 0) & (state[a] == 0))
    fscore = np.where(lens - masked < 2, 0, fscore)
    return score - fscore


__all__ = ["banded_scores", "flank_scores", "INF"]
