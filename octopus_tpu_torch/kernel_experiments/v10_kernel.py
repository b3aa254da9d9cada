"""Port of experiments/v10_kernel.py: fewer instructions a cell.

v10 computes v9's score in another arithmetic, 12 int32 instructions a cell
against v9's 14, from five per-position values that the experiment's XLA
prologue builds outside the kernel (`v10_tracks`, here torch element-wise
ops and a cumsum): capN (the N cap in one min), opn_nuc_dn and ext_nuc_dn
(opn and ext plus nuc_prior, one row down, INF above), pre = cumsum(ext)
and ompre = opn - pre (the deletion chain as a running minimum in primed
space). `v10_rows_plain` is that arithmetic in plain torch on the ten
tracks, the function's plain version; tests hold it against Pallas v9, as
pairhmm_scores_lanes_plain is held for v8.

`scores_v10` launches csrc/exp_v10.cu's Hopper design on the seven raw
tracks, with no prologue: the kernel derives v10's values once a window
position, as it enters the band (`v10_schedule_plain` is that order of work
in plain torch). Its variants: `regs_p16` holds the band's derived values
in registers, `rings` in a shared-memory ring. The first
port, the prologue's ten tracks read by K pairs a thread, stays as
`tracks10_K1/K2/K4/K8`, reached through `launch_v10` on `v10_tracks` (or
`tracks10_call`). B must be a multiple of 128*K, as in the experiment; K
sets nothing else.
"""

from __future__ import annotations

import torch

from . import _common as c
from ..basics.sequence import N
from ..core.likelihood.pairhmm_batch import (DEFAULT_NUC_PRIOR, INF, N_SCORE,
                                             _min_scan, _shift_down,
                                             _shift_up)

K_VARIANTS = (1, 2, 4, 8)    # the experiment's __main__
# the first port's ten tracks, the prologue's output
TRACKS = ("tgt", "qual", "win", "mask", "prior", "capN", "opn_nuc_dn",
          "ext_nuc_dn", "ompre", "pre")
# kernel variant -> exp_v10_launch's variant argument (csrc/exp_v10.cu's
# enum Variant): the Hopper designs on the raw tracks, then the first port
# on TRACKS with K pairs a thread
VARIANTS = {"regs_p16": 0, "rings": 1, "tracks10_K1": 2, "tracks10_K2": 3,
            "tracks10_K4": 4, "tracks10_K8": 5}
DEFAULT_VARIANT = "regs_p16"


def v10_tracks(tgtT, qualT, winT, opnT, extT, maskT, priorT, *,
               nuc_prior: int = DEFAULT_NUC_PRIOR) -> list[torch.Tensor]:
    """The prologue: the ten tracks the first port's kernel reads, in
    TRACKS order, contiguous int32 on the tracks' device."""
    preT = torch.cumsum(extT, dim=0, dtype=torch.int32)
    capN = torch.where(winT == N, torch.full_like(winT, N_SCORE),
                       torch.full_like(winT, INF))
    pad_row = torch.full_like(winT[:1], INF)
    opn_nuc_dn = torch.cat([pad_row, opnT[:-1] + nuc_prior])
    ext_nuc_dn = torch.cat([pad_row, extT[:-1] + nuc_prior])
    return [t.contiguous() for t in (tgtT, qualT, winT, maskT, priorT, capN,
                                     opn_nuc_dn, ext_nuc_dn, opnT - preT,
                                     preT)]


def v10_rows_plain(tracks: list[torch.Tensor], *, pad: int) -> torch.Tensor:
    """`_kernel_v10`'s arithmetic on the ten tracks, all pairs at once:
    (B,) int32."""
    tgt, qual, win, mask, prior, capn, opn_dn, ext_dn, ompre, pre = tracks
    Rn, B = tgt.shape
    D = 2 * pad
    d_odd = (torch.arange(D, device=tgt.device) % 2 == 1)[:, None].expand(D, B)
    ZERO = torch.zeros((D, B), dtype=torch.int32, device=tgt.device)
    INFc = torch.full_like(ZERO, INF)
    M0_gap = torch.where(d_odd, ZERO, INFc)

    def step(y, M, Mg, Ii, Dd):
        lo, hi = y - 1, y - 1 + D
        t, q = tgt[lo:lo + 1], qual[lo:lo + 1]
        w, m, p = win[lo:hi], mask[lo:hi], prior[lo:hi]
        capped = torch.where(m == t, torch.minimum(q, p), q)
        cm = torch.minimum(torch.where(t == w, torch.zeros_like(capped),
                                       capped), capn[lo:hi])
        Mn = cm + torch.minimum(torch.minimum(M, Ii), Dd)
        In = _shift_up(torch.minimum(Mg + opn_dn[lo:hi], Ii + ext_dn[lo:hi]),
                       INF)
        bvp = _shift_down(torch.minimum(Mn, In), INF) + ompre[lo:hi]
        return Mn, In, _min_scan(bvp, D) + pre[lo:hi]

    pre0 = _shift_down(pre[0:D], 0)
    bv0 = _shift_down(M0_gap, INF) + _shift_down(ompre[0:D], 0)
    M, Ii, Dd = step(1, ZERO, M0_gap, INFc, _min_scan(bv0, D) + pre0)
    for y in range(2, Rn + 1):
        M, Ii, Dd = step(y, M, M, Ii, Dd)
    return torch.amin(torch.minimum(torch.minimum(M, Ii), Dd), dim=0)


def v10_schedule_plain(tgtT, qualT, winT, opnT, extT, maskT, priorT, *,
                       pad: int, nuc_prior: int = DEFAULT_NUC_PRIOR
                       ) -> torch.Tensor:
    """The Hopper design's order of work in plain torch, all pairs at once:
    v10's values of the first 2*pad window positions derived into a band
    of slots, pre a running int32 sum; row 0; then each row's diagonals in
    order, the slot of diagonal 0 taking position y + 2*pad - 1 right after
    it. (B,) int32."""
    Rn, B = tgtT.shape
    D = 2 * pad
    W = winT.shape[0]
    inf = torch.full((B,), INF, dtype=torch.int32, device=tgtT.device)
    zero = torch.zeros_like(inf)
    acc = zero.clone()
    slots = [None] * D

    def derive(j):
        nonlocal acc
        acc = acc + extT[j]
        w = winT[j]
        return (w, maskT[j], priorT[j],
                torch.where(w == N, torch.full_like(w, N_SCORE), inf),
                opnT[j] + nuc_prior, extT[j] + nuc_prior, opnT[j] - acc, acc)

    for j in range(D):
        slots[j] = derive(j)
    # row 0
    M, I, Dl = [zero] * D, [inf] * D, [None] * D
    run = inf
    for d in range(D):
        m_gap_prev = INF if d == 0 else (0 if (d - 1) % 2 else INF)
        om = zero if d == 0 else slots[d - 1][6]
        pe = zero if d == 0 else slots[d - 1][7]
        run = torch.minimum(run, m_gap_prev + om)
        Dl[d] = run + pe
    for y in range(1, Rn + 1):
        t, q = tgtT[y - 1], qualT[y - 1]
        mi_prev, run = inf, inf
        for k in range(D):
            w, m, p, cn, on, en, om, pe = slots[(y - 1 + k) % D]
            # cn >= 0: a matching base costs 0 whatever the N cap
            cm = torch.where(t == w, zero, torch.minimum(
                torch.minimum(q, torch.where(m == t, p, q)), cn))
            if k + 1 < D:
                m_up = (torch.full_like(inf, 0 if (k + 1) % 2 else INF)
                        if y == 1 else M[k + 1])
                i_in = torch.minimum(I[k + 1] + en, m_up + on)
            else:
                i_in = inf
            mn = cm + torch.minimum(torch.minimum(M[k], I[k]), Dl[k])
            run = torch.minimum(mi_prev + om, run)
            Dl[k] = run + pe
            M[k], I[k] = mn, i_in
            mi_prev = torch.minimum(mn, i_in)
            if k == 0 and y + D - 1 < W:
                slots[(y - 1) % D] = derive(y + D - 1)
    best = inf
    for k in range(D):
        best = torch.minimum(best, torch.minimum(torch.minimum(M[k], I[k]),
                                                 Dl[k]))
    return best


def _checked(tracks, pad: int, K: int):
    return c.check_tracks(tracks, pad, c.LANES * K, f"128 * K, K = {K}")


def scores_v10_plain(tgtT, qualT, winT, opnT, extT, maskT, priorT, *,
                     pad: int = 8, nuc_prior: int = DEFAULT_NUC_PRIOR,
                     K: int = 4) -> torch.Tensor:
    tracks = [tgtT, qualT, winT, opnT, extT, maskT, priorT]
    _checked(tracks, pad, K)
    return v10_rows_plain(v10_tracks(*tracks, nuc_prior=nuc_prior), pad=pad)


def launch_v10(tracks: list[torch.Tensor], *, pad: int,
               nuc_prior: int = DEFAULT_NUC_PRIOR,
               variant: str = DEFAULT_VARIANT) -> torch.Tensor:
    """One launch of csrc/exp_v10.cu's `variant` on CUDA int32 tracks: the
    seven raw tracks (tgt, qual, win, opn, ext, mask, prior) for the Hopper
    designs, B a multiple of 128; the prologue's ten (TRACKS, `v10_tracks`,
    nuc_prior folded in) for tracks10_K*, B a multiple of 128 K. pre =
    cumsum(ext) is int32 there as in the kernel: scores equal v9's while W
    * max(ext) < 2^31."""
    if variant not in VARIANTS:
        raise ValueError(f"csrc/exp_v10.cu has variants {sorted(VARIANTS)}, "
                         f"not {variant!r}")
    if pad != c.PAD:
        raise ValueError(f"csrc/exp_v10.cu has pad {c.PAD}, not {pad}")
    if variant.startswith("tracks10"):
        K = int(variant.rsplit("K", 1)[1])
        if len(tracks) != len(TRACKS):
            raise ValueError(f"{variant} takes the tracks {TRACKS}")
        Rn, B, W = _checked(tracks[:7], pad, K)
        if any(t.shape != (W, B) for t in tracks[7:]):
            raise ValueError(f"{variant} takes (W, B) window tracks")
        ptrs = tracks
    else:
        Rn, B, W = c.check_tracks(tracks, pad, c.LANES, "128")
        ptrs = tracks + [None] * (len(TRACKS) - len(tracks))
    c.require_cuda("launch_v10", tracks)
    out = torch.empty(B, dtype=torch.int32, device=tracks[0].device)
    return c.launch("v10", ptrs, out,
                    (B, Rn, W, pad, nuc_prior, VARIANTS[variant]))


def tracks10_call(tracks, *, pad: int = 8,
                  nuc_prior: int = DEFAULT_NUC_PRIOR,
                  variant: str = "tracks10_K4") -> torch.Tensor:
    """A tracks10 variant with its prologue, as the first port's scores_v10
    ran it."""
    return launch_v10(v10_tracks(*tracks, nuc_prior=nuc_prior), pad=pad,
                      variant=variant)


def scores_v10_cuda(tgtT, qualT, winT, opnT, extT, maskT, priorT, *,
                    pad: int = 8, nuc_prior: int = DEFAULT_NUC_PRIOR,
                    K: int = 4) -> torch.Tensor:
    """One launch of csrc/exp_v10.cu's default variant on CUDA tracks, no
    prologue."""
    tracks = [tgtT, qualT, winT, opnT, extT, maskT, priorT]
    _checked(tracks, pad, K)
    return launch_v10(tracks, pad=pad, nuc_prior=nuc_prior)


def scores_v10(tgtT, qualT, winT, opnT, extT, maskT, priorT, *, pad: int = 8,
               nuc_prior: int = DEFAULT_NUC_PRIOR, K: int = 4,
               device="cuda") -> torch.Tensor:
    """(B,) int32 scores on `device`: the kernel on a card, the plain
    version on the CPU."""
    return c.dispatch(scores_v10_plain, scores_v10_cuda,
                      [tgtT, qualT, winT, opnT, extT, maskT, priorT],
                      device, pad=pad, nuc_prior=nuc_prior, K=K)


def main() -> None:
    c.check_parity("v10 K=4", scores_v10, K=4)
    c.bench("v9 (#1)  ", c.v9_on_card)
    for variant in VARIANTS:
        c.bench(f"v10 {variant}", lambda *t, **kw: (
            tracks10_call(list(t), variant=variant, **kw)
            if variant.startswith("tracks10") else
            launch_v10(list(t), variant=variant, **kw)))


if __name__ == "__main__":
    main()
