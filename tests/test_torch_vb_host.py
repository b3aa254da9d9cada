"""The subclone VB evaluation in one host call (csrc/vb_host.cpp's
vb_subclone_host) against its torch form, vb_subclone_ops, on the CPU.

vb_subclone runs the whole evaluation natively for float32 CPU tensors once
the host library is built. Every case compares the float32 bits of elbo,
alpha and responsibilities with vb_subclone_ops over a seeded sweep: K 1-9
(9 takes fsum's pairwise tree), N 0-1,100 (32 and 33 sit on the ELBO's fdot
and window forms, 1,100 makes more than 32 windows, so they nest), S 1-3,
1, 2 or 40 rounds, the callers' concentrations (0.05 takes digamma's and
lgamma's reflection) and lnL from -1e3 to 0.
"""

import numpy as np
import pytest
import torch

from octopus_tpu_torch.core.models import subclone_vb as vb
from octopus_tpu_torch.core.models import vb_math

CONCENTRATIONS = [
    lambda K: [0.05] * K,
    lambda K: [0.5] * K,
    lambda K: [1.5] * K,
    lambda K: [50.0] * K,
    lambda K: [50.0] * (K - 1) + [0.05],      # the cancer caller's normal
    lambda K: [1.5] * (K - 1) + [1.0],        # and tumour
]


def inputs(seed, G, S, K, N, conc):
    """lnl (G, K, N) at a random scale up to 1e3 nats, a few reads at one
    shared value, alpha0 and the seeds, as float32 tensors."""
    rng = np.random.default_rng(seed)
    lnl = -rng.exponential(rng.choice([0.1, 2.0, 50.0]), (G, K, N))
    lnl[..., :N // 7] = rng.uniform(-1e3, 0.0)
    lnl = np.minimum(lnl, 0.0).astype(np.float32)
    alpha0 = torch.tensor(CONCENTRATIONS[conc](K), dtype=torch.float32)
    seeds = torch.tensor(vb.subclone_seeds(K, N, S))
    return torch.from_numpy(lnl), alpha0, seeds


def assert_same_bits(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert torch.equal(g.contiguous().view(torch.int32),
                           w.contiguous().view(torch.int32))


@pytest.mark.parametrize("n_iter", [1, 2, 40])
@pytest.mark.parametrize("N", [0, 1, 31, 32, 33, 200, 1100])
@pytest.mark.parametrize("K", [1, 2, 3, 4, 9])
def test_native_evaluation_has_the_torch_bits(K, N, n_iter):
    for conc in range(len(CONCENTRATIONS)):
        S = conc % 3 + 1
        args = inputs([K, N, n_iter, conc], 2, S, K, N, conc)
        before = vb.COUNTS.host_native
        got = vb.vb_subclone(*args, n_iter=n_iter)
        assert vb.COUNTS.host_native == before + 1, "no native call"
        assert_same_bits(got, vb.vb_subclone_ops(*args, n_iter=n_iter))


def test_fallback_without_the_library_gives_the_same_bits(monkeypatch):
    args = inputs(1, 3, 2, 3, 70, 4)
    native = vb.vb_subclone(*args, n_iter=40)
    monkeypatch.setattr(vb_math, "_HOST", False)
    before = vb.COUNTS.host_native
    fallback = vb.vb_subclone(*args, n_iter=40)
    assert vb.COUNTS.host_native == before
    assert_same_bits(fallback, native)


def test_host_native_counts_native_calls_and_resets():
    vb.COUNTS.reset()
    args = inputs(2, 2, 2, 2, 40, 5)
    for calls in (1, 2, 3):
        vb.vb_subclone(*args, n_iter=2)
        assert vb.COUNTS.host_native == calls
    vb.COUNTS.reset()
    assert vb.COUNTS.host_native == 0


def test_row_chunks_and_threads_change_no_bit(monkeypatch):
    rng = np.random.default_rng(7)
    H, K, N, G = 6, 3, 150, 12
    lnL = -rng.exponential(2.0, (H, N))
    tuples = np.stack([rng.choice(H, K, replace=False) for _ in range(G)])
    alpha0 = np.asarray([50.0, 50.0, 0.05], np.float32)
    model = vb.SubcloneModel(n_seeds=2, n_iter=40, device="cpu")
    vb.COUNTS.reset()
    whole = model.evaluate(tuples, lnL, alpha0_vec=alpha0)
    assert vb.COUNTS.host_native == 1
    monkeypatch.setenv("OCTOPUS_TPU_VB_BUDGET_ELEMS", str(2 * K * N * 5))
    chunked = model.evaluate(tuples, lnL, alpha0_vec=alpha0)
    assert vb.COUNTS.host_native == 1 + 3          # rows 5 + 5 + 2
    assert np.array_equal(chunked.genotype_log_evidences,
                          whole.genotype_log_evidences)
    assert np.array_equal(chunked.map_alphas, whole.map_alphas)
    # above 2^18 element-rounds the rows are split over torch's threads
    args = inputs(3, 40, 2, 3, 200, 5)
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        one = vb.vb_subclone(*args, n_iter=40)
        torch.set_num_threads(4)
        assert_same_bits(vb.vb_subclone(*args, n_iter=40), one)
    finally:
        torch.set_num_threads(threads)
