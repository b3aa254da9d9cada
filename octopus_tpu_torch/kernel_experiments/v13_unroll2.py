"""Port of experiments/v13_unroll2.py: two rows a loop iteration.

`scores_v13` scores kernel-layout tracks with K pairs a thread and the row
loop written two rows an iteration, an odd last row peeled
(csrc/exp_v13.cu); `launch_v13(..., two_rows=False)` runs the same kernel
one row an iteration under #pragma unroll 1, the comparison. B must be a
multiple of 128*K, as in the experiment. The experiment computes v9's
score, so its plain version is pairhmm_scores_plain on the transposed
tracks (`plain_v9`).
"""

from __future__ import annotations

import torch

from . import _common as c
from ..core.likelihood.pairhmm_batch import DEFAULT_NUC_PRIOR

K_VARIANTS = (4, 6)      # the experiment's __main__


def scores_v13_plain(tgtT, qualT, winT, opnT, extT, maskT, priorT, *,
                     pad: int = 8, nuc_prior: int = DEFAULT_NUC_PRIOR,
                     K: int = 4) -> torch.Tensor:
    tracks = [tgtT, qualT, winT, opnT, extT, maskT, priorT]
    c.check_tracks(tracks, pad, c.LANES * K, f"128 * K, K = {K}")
    return c.plain_v9(tracks, pad, nuc_prior)


def launch_v13(tracks: list[torch.Tensor], *, pad: int, nuc_prior: int,
               K: int, two_rows: bool = True) -> torch.Tensor:
    """One launch of csrc/exp_v13.cu on the seven CUDA int32 tracks."""
    Rn, B, W = c.check_tracks(tracks, pad, c.LANES * K, f"128 * K, K = {K}")
    c.require_cuda("launch_v13", tracks)
    if pad != c.PAD or K not in K_VARIANTS:
        raise ValueError(f"csrc/exp_v13.cu has pad {c.PAD} and K in "
                         f"{K_VARIANTS}, not pad {pad}, K {K}")
    out = torch.empty(B, dtype=torch.int32, device=tracks[0].device)
    return c.launch("v13", tracks, out,
                    (B, Rn, W, pad, nuc_prior, K, int(two_rows)))


def scores_v13_cuda(tgtT, qualT, winT, opnT, extT, maskT, priorT, *,
                    pad: int = 8, nuc_prior: int = DEFAULT_NUC_PRIOR,
                    K: int = 4) -> torch.Tensor:
    return launch_v13([tgtT, qualT, winT, opnT, extT, maskT, priorT],
                      pad=pad, nuc_prior=nuc_prior, K=K)


def scores_v13(tgtT, qualT, winT, opnT, extT, maskT, priorT, *, pad: int = 8,
               nuc_prior: int = DEFAULT_NUC_PRIOR, K: int = 4,
               device="cuda") -> torch.Tensor:
    """(B,) int32 scores on `device`: the kernel on a card, the plain
    version on the CPU."""
    return c.dispatch(scores_v13_plain, scores_v13_cuda,
                      [tgtT, qualT, winT, opnT, extT, maskT, priorT],
                      device, pad=pad, nuc_prior=nuc_prior, K=K)


def main() -> None:
    c.check_parity("v13", scores_v13, K=4)
    c.bench("v12 (#1) ", c.v9_on_card)
    for K in K_VARIANTS:
        # the most pairs up to the bench's that 128 * K divides (65,280 at
        # K = 6, where the experiment's own bench asserts)
        B = c.BENCH_B - c.BENCH_B % (c.LANES * K)
        c.bench(f"v13 K={K}x2", scores_v13, B=B, K=K)
        c.bench(f"v13 K={K}x1", lambda *t, **kw: launch_v13(
            list(t), nuc_prior=DEFAULT_NUC_PRIOR, two_rows=False, **kw),
            B=B, K=K)


if __name__ == "__main__":
    main()
