"""Port of experiments/v11_kernel.py: sliding register windows.

`scores_v11` scores kernel-layout tracks with the band across a warp's
lanes (csrc/exp_v11.cu): each lane holds one diagonal and the six window
tracks slide a lane a row by shuffles, only the edge lane loading the new
row. The prologue computes pre = cumsum(ext) with torch, as XLA computed it
outside the Pallas kernel. B must be a multiple of 128*blk, as in the
experiment; blk sets the kernel's block (128*blk threads). The experiment
computes v9's score, so its plain version is pairhmm_scores_plain on the
transposed tracks (`plain_v9`).
"""

from __future__ import annotations

import torch

from . import _common as c
from ..core.likelihood.pairhmm_batch import DEFAULT_NUC_PRIOR

BLK_VARIANTS = (1, 2)    # the experiment's __main__


def scores_v11_plain(tgtT, qualT, winT, opnT, extT, maskT, priorT, *,
                     pad: int = 8, nuc_prior: int = DEFAULT_NUC_PRIOR,
                     blk: int = 1) -> torch.Tensor:
    tracks = [tgtT, qualT, winT, opnT, extT, maskT, priorT]
    c.check_tracks(tracks, pad, c.LANES * blk, f"128 * blk, blk = {blk}")
    return c.plain_v9(tracks, pad, nuc_prior)


def v11_pre(extT: torch.Tensor) -> torch.Tensor:
    """The prologue's pre = cumsum(ext) over window rows, int32."""
    return torch.cumsum(extT, dim=0, dtype=torch.int32)


def launch_v11(tracks: list[torch.Tensor], preT: torch.Tensor, *, pad: int,
               nuc_prior: int, blk: int) -> torch.Tensor:
    """One launch of csrc/exp_v11.cu on the seven CUDA int32 tracks and
    pre."""
    Rn, B, W = c.check_tracks(tracks, pad, c.LANES * blk,
                              f"128 * blk, blk = {blk}")
    c.require_cuda("launch_v11", tracks + [preT])
    if pad != c.PAD or blk not in BLK_VARIANTS or preT.shape != (W, B):
        raise ValueError(f"csrc/exp_v11.cu has pad {c.PAD}, blk in "
                         f"{BLK_VARIANTS} and pre (W, B)")
    out = torch.empty(B, dtype=torch.int32, device=preT.device)
    return c.launch("v11", tracks + [preT], out,
                    (B, Rn, W, pad, nuc_prior, blk))


def scores_v11_cuda(tgtT, qualT, winT, opnT, extT, maskT, priorT, *,
                    pad: int = 8, nuc_prior: int = DEFAULT_NUC_PRIOR,
                    blk: int = 1) -> torch.Tensor:
    """The prologue and one launch of csrc/exp_v11.cu on CUDA tracks."""
    c.require_cuda("scores_v11_cuda", [tgtT])
    return launch_v11([tgtT, qualT, winT, opnT, extT, maskT, priorT],
                      v11_pre(extT), pad=pad, nuc_prior=nuc_prior, blk=blk)


def scores_v11(tgtT, qualT, winT, opnT, extT, maskT, priorT, *, pad: int = 8,
               nuc_prior: int = DEFAULT_NUC_PRIOR, blk: int = 1,
               device="cuda") -> torch.Tensor:
    """(B,) int32 scores on `device`: the kernel on a card, the plain
    version on the CPU."""
    return c.dispatch(scores_v11_plain, scores_v11_cuda,
                      [tgtT, qualT, winT, opnT, extT, maskT, priorT],
                      device, pad=pad, nuc_prior=nuc_prior, blk=blk)


def main() -> None:
    c.check_parity("v11", scores_v11)
    c.bench("v9 (#1)  ", c.v9_on_card)
    for blk in BLK_VARIANTS:
        c.bench(f"v11 blk={blk}", scores_v11, blk=blk)


if __name__ == "__main__":
    main()
