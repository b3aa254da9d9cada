"""Port of experiments/v13_unroll2.py: two rows a loop iteration.

`scores_v13` scores kernel-layout tracks with the row loop written two rows
an iteration, an odd last row peeled (csrc/exp_v13.cu). Its Hopper design,
`shared_K1` (the default) and `shared_K2`, runs one or two pairs a thread
and scores the two rows in one pass over their 17 window positions, so one
load of a window value can serve two cells. The first port's design, four
or six pairs a thread with the two rows one after the other, stays as
`K4x2` and `K6x2`, and the same kernel one row an iteration under #pragma
unroll 1 as `K4x1` and `K6x1`, reached through `launch_v13`. B must be a
multiple of 128*K, as in the experiment; K sets nothing else. The
experiment computes v9's score, so its plain version is
pairhmm_scores_plain on the transposed tracks (`plain_v9`).
"""

from __future__ import annotations

import torch

from . import _common as c
from ..core.likelihood.pairhmm_batch import DEFAULT_NUC_PRIOR

K_VARIANTS = (4, 6)      # the experiment's __main__
# kernel variant -> (pairs a thread, exp_v13_launch's schedule, a Schedule
# of csrc/exp_rows.cuh: 3 two rows in one pass, 1 two rows an iteration, 2
# one row)
VARIANTS = {"shared_K1": (1, 3), "shared_K2": (2, 3),
            "K4x2": (4, 1), "K4x1": (4, 2), "K6x2": (6, 1), "K6x1": (6, 2)}
DEFAULT_VARIANT = "shared_K1"


def scores_v13_plain(tgtT, qualT, winT, opnT, extT, maskT, priorT, *,
                     pad: int = 8, nuc_prior: int = DEFAULT_NUC_PRIOR,
                     K: int = 4) -> torch.Tensor:
    tracks = [tgtT, qualT, winT, opnT, extT, maskT, priorT]
    c.check_tracks(tracks, pad, c.LANES * K, f"128 * K, K = {K}")
    return c.plain_v9(tracks, pad, nuc_prior)


def launch_v13(tracks: list[torch.Tensor], *, pad: int, nuc_prior: int,
               variant: str = DEFAULT_VARIANT) -> torch.Tensor:
    """One launch of csrc/exp_v13.cu's `variant` on the seven CUDA int32
    tracks; B must be a multiple of 128 times its pairs a thread."""
    if variant not in VARIANTS:
        raise ValueError(f"csrc/exp_v13.cu has variants {sorted(VARIANTS)}, "
                         f"not {variant!r}")
    K, schedule = VARIANTS[variant]
    Rn, B, W = c.check_tracks(tracks, pad, c.LANES * K,
                              f"128 * pairs a thread, {variant}")
    c.require_cuda("launch_v13", tracks)
    if pad != c.PAD:
        raise ValueError(f"csrc/exp_v13.cu has pad {c.PAD}, not {pad}")
    out = torch.empty(B, dtype=torch.int32, device=tracks[0].device)
    return c.launch("v13", tracks, out,
                    (B, Rn, W, pad, nuc_prior, K, schedule))


def scores_v13_cuda(tgtT, qualT, winT, opnT, extT, maskT, priorT, *,
                    pad: int = 8, nuc_prior: int = DEFAULT_NUC_PRIOR,
                    K: int = 4) -> torch.Tensor:
    """One launch of csrc/exp_v13.cu's default variant on CUDA tracks."""
    tracks = [tgtT, qualT, winT, opnT, extT, maskT, priorT]
    c.check_tracks(tracks, pad, c.LANES * K, f"128 * K, K = {K}")
    return launch_v13(tracks, pad=pad, nuc_prior=nuc_prior)


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
    for variant, (K, _) in VARIANTS.items():
        # the most pairs up to the bench's that 128 * K divides (65,280 at
        # K = 6, where the experiment's own bench asserts)
        B = c.BENCH_B - c.BENCH_B % (c.LANES * K)
        c.bench(f"v13 {variant}", lambda *t, **kw: launch_v13(
            list(t), nuc_prior=DEFAULT_NUC_PRIOR, variant=variant, **kw), B=B)


if __name__ == "__main__":
    main()
