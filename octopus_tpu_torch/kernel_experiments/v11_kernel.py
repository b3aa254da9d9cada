"""Port of experiments/v11_kernel.py: window tracks held in registers.

`scores_v11` scores kernel-layout tracks with one thread a pair holding the
16 window values of each of the five window tracks in registers
(csrc/exp_v11.cu, `regs`): the row loop is unrolled over P rows, so the
TPU's slide becomes a renaming of registers (P = 16, `regs_ring_p16`) or
one rotation of them a body (P = 4, `regs_ring_p4`, the faster on the H100
and the entry point's; PERF.md), and a row loads one new window row, staged
in shared-memory rings by 16-byte cp.async. The first port's design, the
band across a warp's lanes slid by shuffles with the prologue pre =
cumsum(ext) made by torch (as XLA made it outside the Pallas kernel), stays
as `shfl_blk1` and `shfl_blk2`, reached through `launch_v11`. B must be a
multiple of 128*blk, as in the experiment; blk sets nothing else. The
experiment computes v9's score, so its plain version is
pairhmm_scores_plain on the transposed tracks (`plain_v9`).
"""

from __future__ import annotations

import torch

from . import _common as c
from ..core.likelihood.pairhmm_batch import DEFAULT_NUC_PRIOR

BLK_VARIANTS = (1, 2)    # the experiment's __main__
# kernel variant -> exp_v11_launch's variant argument (csrc/exp_v11.cu's
# enum Variant): the register design with its row loop unrolled over P
# rows (the slots rotate after each body below 16), and the first port's design
VARIANTS = {"regs_ring_p4": 0, "regs_ring_p16": 1, "shfl_blk1": 2,
            "shfl_blk2": 3}
DEFAULT_VARIANT = "regs_ring_p4"


def scores_v11_plain(tgtT, qualT, winT, opnT, extT, maskT, priorT, *,
                     pad: int = 8, nuc_prior: int = DEFAULT_NUC_PRIOR,
                     blk: int = 1) -> torch.Tensor:
    tracks = [tgtT, qualT, winT, opnT, extT, maskT, priorT]
    c.check_tracks(tracks, pad, c.LANES * blk, f"128 * blk, blk = {blk}")
    return c.plain_v9(tracks, pad, nuc_prior)


def v11_pre(extT: torch.Tensor) -> torch.Tensor:
    """The shfl variants' prologue: pre = cumsum(ext) over window rows,
    int32."""
    return torch.cumsum(extT, dim=0, dtype=torch.int32)


def launch_v11(tracks: list[torch.Tensor], preT: torch.Tensor | None = None,
               *, pad: int, nuc_prior: int,
               variant: str = DEFAULT_VARIANT) -> torch.Tensor:
    """One launch of csrc/exp_v11.cu's `variant` on the seven CUDA int32
    tracks (B a multiple of 128); the shfl variants also take pre."""
    Rn, B, W = c.check_tracks(tracks, pad, c.LANES, "128")
    if pad != c.PAD or variant not in VARIANTS:
        raise ValueError(f"csrc/exp_v11.cu has pad {c.PAD} and variants "
                         f"{sorted(VARIANTS)}, not pad {pad}, {variant!r}")
    shfl = variant.startswith("shfl")
    if shfl and (preT is None or preT.shape != (W, B)):
        raise ValueError(f"{variant} takes pre (W, B) = ({W}, {B})")
    c.require_cuda("launch_v11", tracks + ([preT] if shfl else []))
    out = torch.empty(B, dtype=torch.int32, device=tracks[0].device)
    return c.launch("v11", tracks + [preT if shfl else None], out,
                    (B, Rn, W, pad, nuc_prior, VARIANTS[variant]))


def scores_v11_cuda(tgtT, qualT, winT, opnT, extT, maskT, priorT, *,
                    pad: int = 8, nuc_prior: int = DEFAULT_NUC_PRIOR,
                    blk: int = 1) -> torch.Tensor:
    """One launch of csrc/exp_v11.cu's default variant on CUDA tracks."""
    tracks = [tgtT, qualT, winT, opnT, extT, maskT, priorT]
    c.check_tracks(tracks, pad, c.LANES * blk, f"128 * blk, blk = {blk}")
    return launch_v11(tracks, pad=pad, nuc_prior=nuc_prior)


def scores_v11(tgtT, qualT, winT, opnT, extT, maskT, priorT, *, pad: int = 8,
               nuc_prior: int = DEFAULT_NUC_PRIOR, blk: int = 1,
               device="cuda") -> torch.Tensor:
    """(B,) int32 scores on `device`: the kernel on a card, the plain
    version on the CPU."""
    return c.dispatch(scores_v11_plain, scores_v11_cuda,
                      [tgtT, qualT, winT, opnT, extT, maskT, priorT],
                      device, pad=pad, nuc_prior=nuc_prior, blk=blk)


def shfl_call(tracks, *, pad: int = 8, nuc_prior: int = DEFAULT_NUC_PRIOR,
              variant: str = "shfl_blk1") -> torch.Tensor:
    """A shfl variant with its prologue, as the first port's scores_v11 ran it."""
    return launch_v11(tracks, v11_pre(tracks[4]), pad=pad,
                      nuc_prior=nuc_prior, variant=variant)


def main() -> None:
    c.check_parity("v11", scores_v11)
    c.bench("v9 (#1)  ", c.v9_on_card)
    for variant in VARIANTS:
        c.bench(f"v11 {variant}", lambda *t, **kw: (
            shfl_call(list(t), variant=variant, **kw)
            if variant.startswith("shfl") else
            launch_v11(list(t), nuc_prior=DEFAULT_NUC_PRIOR, variant=variant,
                       **kw)))


if __name__ == "__main__":
    main()
