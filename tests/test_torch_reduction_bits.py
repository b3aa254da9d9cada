"""The genotype reduction's CPU bits depend only on its inputs.

`--device cpu` records and the pool's float64-gated reductions must be the
same on every host and in every process, so the CPU float32 reduction
(`genotype_log_likelihoods_torch`: max, exp, counts @ E, log, sum) must
not take other bits with torch's intra-op thread count, with ATen's CPU
dispatch (ATEN_CPU_CAPABILITY) or with MKL's (MKL_ENABLE_INSTRUCTIONS,
MKL_CBWR). torch's own CPU exp and log do change with the dispatch on an
AVX-512 host; vb_math's fexp/flog, which the reduction takes, do not.
"""

import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from octopus_tpu_torch.core.models.genotype_likelihoods import (
    genotype_counts_matrix, genotype_log_likelihoods_torch)

ROOT = Path(__file__).resolve().parent.parent

# (haplotypes, reads): the 128 x 319 reduction of the window where the
# records once moved, and shapes that split unevenly over threads
SHAPES = ((128, 319), (36, 2001), (10, 33000), (300, 77))

PROBE = r"""
import hashlib, sys
import numpy as np, torch
from octopus_tpu_torch.core.models.genotype_likelihoods import (
    genotype_counts_matrix, genotype_log_likelihoods_torch)
H, R = 128, 319
rng = np.random.default_rng(7)
lnL = torch.tensor(rng.uniform(-60, 0, (H, R)).astype(np.float32))
gts = np.array([(i, j) for i in range(H) for j in range(i, H)])
counts = torch.tensor(genotype_counts_matrix(gts, H), dtype=torch.float32)
out = genotype_log_likelihoods_torch(lnL, counts, 2)
print(hashlib.sha1(out.numpy().tobytes()).hexdigest())
"""


def inputs(H, R, seed):
    rng = np.random.default_rng(seed)
    lnL = torch.tensor(rng.uniform(-60, 0, (H, R)).astype(np.float32))
    gts = np.array([(i, j) for i in range(H) for j in range(i, H)])
    counts = torch.tensor(genotype_counts_matrix(gts, H), dtype=torch.float32)
    return lnL, counts


def digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.contiguous().numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("H,R", SHAPES)
def test_cpu_reduction_bits_do_not_depend_on_threads(H, R):
    """The reduction, and the product counts @ E inside it, give one set of
    bits at 1, 2, 5 and 8 intra-op threads."""
    lnL, counts = inputs(H, R, H)
    E = torch.exp(lnL - lnL.amax(0))
    saved = torch.get_num_threads()
    seen, products = set(), set()
    try:
        for n in (1, 2, 5, 8):
            torch.set_num_threads(n)
            seen.add(digest(genotype_log_likelihoods_torch(lnL, counts, 2)))
            products.add(digest(counts @ E))
    finally:
        torch.set_num_threads(saved)
    assert len(seen) == 1 and len(products) == 1


@pytest.mark.parametrize("env", [
    {"ATEN_CPU_CAPABILITY": "avx2"},
    {"ATEN_CPU_CAPABILITY": "default"},
    {"MKL_ENABLE_INSTRUCTIONS": "AVX2"},
    {"MKL_CBWR": "COMPATIBLE"},
], ids=lambda e: "-".join(f"{k}={v}" for k, v in e.items()))
def test_cpu_reduction_bits_do_not_depend_on_cpu_dispatch(env):
    """A fresh interpreter under another ATen or MKL dispatch reduces the
    128 x 319 input to the same bits as this one."""
    lnL, counts = inputs(128, 319, 7)
    want = digest(genotype_log_likelihoods_torch(lnL, counts, 2))
    child = {k: v for k, v in os.environ.items()
             if not k.startswith(("ATEN_CPU_", "MKL_"))}
    child.update(env, PYTHONPATH=str(ROOT))
    got = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=child,
                         capture_output=True, text=True, timeout=120)
    assert got.returncode == 0, got.stderr[-2000:]
    assert got.stdout.strip().splitlines()[-1] == want
