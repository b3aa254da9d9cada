"""The yardstick of kernel #1 (`csrc/pairhmm.cu`): the least time one
NVIDIA H100 SXM5 could take for a launch, frozen here so that no change to
the program moves it.

* Operations: 12 int32 operations a band cell, the fewest any kernel of
  the repository needs for this function (the `regs_p16` variant of
  `csrc/exp_v10.cu`, with the match cost written as
  `t == w ? 0 : min3(q, m == t ? p : q, capN)`), plus 3 a lane for row 0's
  deletion chain and 3 for the last row's band minimum. The program's own
  `pairhmm_batch.pairhmm_bound` counts 14 (a match cost of 6), which
  prices more work than the function needs and so overstates a kernel's
  share.
* The int32 rate: 132 SMs x 64 INT32 lanes x 1.98 GHz boost = 16.73
  Tops/s. It is derived from the H100 SXM5's unit counts and boost clock,
  not a published peak.
* Bytes: each track byte read once (tgt and qual R int32 a pair, the five
  window tracks W = R + 2*pad - 1 each) and each int32 score written once,
  over the published 3.35 TB/s of HBM3.

The least time of a launch is the larger of the two; at 65,536 x 150,
band 8 (pad 8) it is 0.11321 ms, by operations.
"""

from __future__ import annotations

OPS_PER_CELL = 12
EDGE_OPS = 6                          # row 0's chain and the last row's minimum
INT32_OPS_PER_S = 132 * 64 * 1.98e9   # derived from unit counts, not published
INT32_RATE_SOURCE = "derived from unit counts: 132 SMs x 64 INT32 lanes x 1.98 GHz boost"
HBM_BYTES_PER_S = 3.35e12             # published, H100 SXM5
HBM_SOURCE = "published: H100 SXM5 HBM3, 3.35 TB/s"


def pairhmm_least_seconds(B: int, R: int, pad: int) -> tuple[float, str]:
    """(seconds, what binds) of one launch of B pairs of R rows at pad."""
    D = 2 * pad
    W = R + 2 * pad - 1
    ops = (OPS_PER_CELL * R + EDGE_OPS) * D * B
    nbytes = (2 * R + 5 * W) * 4 * B + 4 * B
    t_ops = ops / INT32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def launches_least_seconds(launches) -> float:
    """Sum over launches [(B, R, pad)] of each one's least time."""
    return sum(pairhmm_least_seconds(*launch)[0] for launch in launches)


__all__ = ["pairhmm_least_seconds", "launches_least_seconds",
           "OPS_PER_CELL", "INT32_OPS_PER_S", "HBM_BYTES_PER_S",
           "INT32_RATE_SOURCE", "HBM_SOURCE"]
