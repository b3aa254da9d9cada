"""The yardstick of the genotype reduction's matrix product on the card
(`core/models/genotype_likelihoods.py`, `genotype_log_likelihoods_torch`:
S = C @ E, C the (G, H) counts matrix, E the (H, R) exponentials, in
float32): the least time one NVIDIA H100 SXM5 could take for it, frozen
here so that no change to the program moves it.

* Operations: 2*G*H*R float32 operations (a multiply and an add a term),
  over the **published** H100 SXM5 FP32 rate of 67 TFLOPS (CUDA cores, no
  tensor cores: the product runs in full float32, not TF32).
* Bytes: C, E and S each once, (G*H + H*R + G*R) * 4 bytes, over the
  **published** 3.35 TB/s of HBM3.

The least time is the larger of the two. The program keeps sums over its
reductions (`likelihood_array.ROUTING.card_reductions`: G*H*R, G*H, H*R,
G*R), so a window's least time here is the larger of two sums, which is
never more than the sum of each reduction's own least time: a share over
it can only read low.
"""

from __future__ import annotations

FP32_OPS_PER_S = 67e12                # published, H100 SXM5 FP32 (non-tensor)
FP32_RATE_SOURCE = "published: H100 SXM5 FP32, 67 TFLOPS"
HBM_BYTES_PER_S = 3.35e12             # published, H100 SXM5
HBM_SOURCE = "published: H100 SXM5 HBM3, 3.35 TB/s"


def gemm_least_seconds(ghr: int, gh: int, hr: int, gr: int) -> tuple[float, str]:
    """(seconds, what binds) of products summing to G*H*R, G*H, H*R, G*R."""
    t_ops = 2 * ghr / FP32_OPS_PER_S
    t_bytes = (gh + hr + gr) * 4 / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


__all__ = ["gemm_least_seconds", "FP32_OPS_PER_S", "HBM_BYTES_PER_S",
           "FP32_RATE_SOURCE", "HBM_SOURCE"]
