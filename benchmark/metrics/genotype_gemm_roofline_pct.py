"""The card genotype reductions' matrix product as a share of its
roofline over the traced window: the least time of the window's products
(benchmark/roofline_genotype.py: 2*G*H*R float32 operations over the
published FP32 rate, or C, E and S once over the published HBM rate,
whichever is larger, from the sums the program keeps in
likelihood_array.ROUTING.card_reductions) over the profiler time of the
GEMM kernels. Taken from sums, the least time is the larger of two sums,
never more than the sum of each product's own: the share can only read
low. Nothing to read where no reduction ran on the card, or on a program
without the sums."""

import re

from benchmark.roofline_genotype import gemm_least_seconds

# cuBLAS's float32 GEMM kernels as the profiler names them on the H100
GEMM_KERNEL = re.compile(r"gemm", re.IGNORECASE)


def read(r):
    from octopus_tpu_torch.core.likelihood import likelihood_array
    sums = getattr(getattr(likelihood_array, "ROUTING", None), "card_reductions", None)
    if r.device is None or not sums or not sums.get("ghr"):
        return None
    kernel_s = sum(v for k, v in r.device.seconds_by_kernel().items()
                   if GEMM_KERNEL.search(k))
    if kernel_s <= 0:
        return None
    least = gemm_least_seconds(sums["ghr"], sums["gh"], sums["hr"], sums["gr"])[0]
    return 100.0 * least / kernel_s
