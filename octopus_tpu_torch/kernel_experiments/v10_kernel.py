"""Port of experiments/v10_kernel.py: fewer instructions a cell, more bytes
a pair.

v10 computes v9's score in another arithmetic. A prologue (`v10_tracks`:
torch element-wise ops and a cumsum, as XLA computed them outside the
Pallas kernel) builds five more tracks: capN (the N cap in one min),
opn_nuc_dn and ext_nuc_dn (opn and ext plus nuc_prior, one row down, INF
above), pre = cumsum(ext) and ompre = opn - pre (the deletion chain as a
running minimum in primed space). `v10_rows_plain` is that arithmetic in
plain torch, `launch_v10` csrc/exp_v10.cu on the ten tracks with K pairs a
thread; tests hold the plain form against Pallas v9, as
pairhmm_scores_lanes_plain is held for v8. B must be a multiple of 128*K,
as in the experiment.
"""

from __future__ import annotations

import torch

from . import _common as c
from ..basics.sequence import N
from ..core.likelihood.pairhmm_batch import (DEFAULT_NUC_PRIOR, INF, N_SCORE,
                                             _min_scan, _shift_down,
                                             _shift_up)

K_VARIANTS = (1, 2, 4, 8)    # the experiment's __main__
TRACKS = ("tgt", "qual", "win", "mask", "prior", "capN", "opn_nuc_dn",
          "ext_nuc_dn", "ompre", "pre")


def v10_tracks(tgtT, qualT, winT, opnT, extT, maskT, priorT, *,
               nuc_prior: int = DEFAULT_NUC_PRIOR) -> list[torch.Tensor]:
    """The prologue: the ten tracks the v10 kernel reads, in TRACKS order,
    contiguous int32 on the tracks' device."""
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


def _checked(tracks, pad: int, K: int):
    return c.check_tracks(tracks, pad, c.LANES * K, f"128 * K, K = {K}")


def scores_v10_plain(tgtT, qualT, winT, opnT, extT, maskT, priorT, *,
                     pad: int = 8, nuc_prior: int = DEFAULT_NUC_PRIOR,
                     K: int = 4) -> torch.Tensor:
    tracks = [tgtT, qualT, winT, opnT, extT, maskT, priorT]
    _checked(tracks, pad, K)
    return v10_rows_plain(v10_tracks(*tracks, nuc_prior=nuc_prior), pad=pad)


def launch_v10(tracks10: list[torch.Tensor], *, pad: int, K: int
               ) -> torch.Tensor:
    """One launch of csrc/exp_v10.cu on the ten CUDA int32 tracks."""
    if len(tracks10) != len(TRACKS):
        raise ValueError(f"launch_v10 takes the tracks {TRACKS}")
    Rn, B, W = _checked(tracks10[:5] + tracks10[5:7], pad, K)
    c.require_cuda("launch_v10", tracks10)
    if pad != c.PAD or K not in K_VARIANTS or any(
            t.shape != (W, B) for t in tracks10[7:]):
        raise ValueError(f"csrc/exp_v10.cu has pad {c.PAD}, K in "
                         f"{K_VARIANTS} and (W, B) window tracks")
    out = torch.empty(B, dtype=torch.int32, device=tracks10[0].device)
    return c.launch("v10", tracks10, out, (B, Rn, W, pad, K))


def scores_v10_cuda(tgtT, qualT, winT, opnT, extT, maskT, priorT, *,
                    pad: int = 8, nuc_prior: int = DEFAULT_NUC_PRIOR,
                    K: int = 4) -> torch.Tensor:
    """The prologue and one launch of csrc/exp_v10.cu on CUDA tracks."""
    tracks = [tgtT, qualT, winT, opnT, extT, maskT, priorT]
    _checked(tracks, pad, K)
    c.require_cuda("scores_v10_cuda", tracks)
    return launch_v10(v10_tracks(*tracks, nuc_prior=nuc_prior), pad=pad, K=K)


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
    for K in K_VARIANTS:
        c.bench(f"v10 K={K}", scores_v10, K=K)


if __name__ == "__main__":
    main()
