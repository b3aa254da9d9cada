"""Port of experiments/dual_chain.py: K independent pairs a thread.

`scores_dual` scores kernel-layout tracks (tgt/qual (R, B), win/opn/ext/
mask/prior (W, B)) with K pairs' chains interleaved in one thread of
csrc/exp_dual_chain.cu; B must be a multiple of 128*K, as in the
experiment. The experiment computes v9's score, so its plain version is
pairhmm_batch.pairhmm_scores_plain on the transposed tracks (`plain_v9`).
"""

from __future__ import annotations

import torch

from . import _common as c
from ..core.likelihood.pairhmm_batch import DEFAULT_NUC_PRIOR

K_VARIANTS = (2, 4)      # the experiment's __main__
KERNEL_K = (1, 2, 4)     # built: K = 1 is the same kernel's one-pair baseline


def scores_dual_plain(tgtT, qualT, winT, opnT, extT, maskT, priorT, *,
                      pad: int = 8, nuc_prior: int = DEFAULT_NUC_PRIOR,
                      K: int = 2) -> torch.Tensor:
    tracks = [tgtT, qualT, winT, opnT, extT, maskT, priorT]
    c.check_tracks(tracks, pad, c.LANES * K, f"128 * K, K = {K}")
    return c.plain_v9(tracks, pad, nuc_prior)


def scores_dual_cuda(tgtT, qualT, winT, opnT, extT, maskT, priorT, *,
                     pad: int = 8, nuc_prior: int = DEFAULT_NUC_PRIOR,
                     K: int = 2) -> torch.Tensor:
    """One launch of csrc/exp_dual_chain.cu on CUDA int32 tracks."""
    tracks = [tgtT, qualT, winT, opnT, extT, maskT, priorT]
    Rn, B, W = c.check_tracks(tracks, pad, c.LANES * K, f"128 * K, K = {K}")
    c.require_cuda("scores_dual_cuda", tracks)
    if pad != c.PAD or K not in KERNEL_K:
        raise ValueError(f"csrc/exp_dual_chain.cu has pad {c.PAD} and K in "
                         f"{KERNEL_K}, not pad {pad}, K {K}")
    out = torch.empty(B, dtype=torch.int32, device=tgtT.device)
    return c.launch("dual_chain", tracks, out, (B, Rn, W, pad, nuc_prior, K))


def scores_dual(tgtT, qualT, winT, opnT, extT, maskT, priorT, *, pad: int = 8,
                nuc_prior: int = DEFAULT_NUC_PRIOR, K: int = 2,
                device="cuda") -> torch.Tensor:
    """(B,) int32 scores on `device`: the kernel on a card, the plain
    version on the CPU."""
    return c.dispatch(scores_dual_plain, scores_dual_cuda,
                      [tgtT, qualT, winT, opnT, extT, maskT, priorT],
                      device, pad=pad, nuc_prior=nuc_prior, K=K)


def main() -> None:
    c.check_parity("dual K=2", scores_dual, win_hi=4, K=2)
    c.bench("v9 (#1)  ", c.v9_on_card, win_hi=4)
    for K in K_VARIANTS:
        c.bench(f"dual K={K}", scores_dual, win_hi=4, K=K)


if __name__ == "__main__":
    main()
