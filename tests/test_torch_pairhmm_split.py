"""csrc/pairhmm.cu's split deletion chain, held against the reference.

With T threads a pair, the kernel runs the deletion chain of a row inside
each thread over its K = D/T diagonals and carries it across the threads by
a log2(T)-step scan of min-plus maps. `pairhmm_scores_plain(threads=T)`
follows that order (`_deletion_split`); here it must give the same integers
as the XLA wavefront, Pallas v9 and v12 in interpret mode and the golden
binary, at bands 8, 16 and 32 and every T up to D, on batches whose chains
carry INF-scale terms. The wrappers' checks of variants and layouts run
here too; the kernels themselves run in test_torch_cuda.py on the card.
"""

import os

import numpy as np
import pytest
import torch

from octopus_tpu.core.likelihood.pairhmm_batch import (
    LANES,
    V12_GROUPS,
    pairhmm_scores_pallas_v9,
    pairhmm_scores_pallas_v12,
    pairhmm_scores_xla,
)
from octopus_tpu_torch.core.likelihood import pairhmm_batch as pb
from test_pairhmm_batch import make_batch
from test_pairhmm_golden import HARNESS, run_reference
from test_torch_cuda import GOLDEN_CASES, pack_cases

SPLIT_THREADS = (1, 2, 4, 8)


def split(batch, pad, threads):
    args = [torch.from_numpy(np.ascontiguousarray(a, np.int32)) for a in batch]
    return pb.pairhmm_scores_plain(*args, pad=pad, threads=threads).numpy()


def heavy_indel_batch(seed, B, pad, R=40):
    """Reads with long indels against windows whose gap penalties are 1-3 to
    open and 0-1 to extend, so deletion chains run the whole band and the
    row-0 chain's INF-scale terms (2*INF + opn) reach every diagonal."""
    rng = np.random.default_rng(seed)
    W = R + 2 * pad - 1
    win = rng.integers(0, 4, (B, W))
    tgt = np.empty((B, R), np.int64)
    for b in range(B):
        gap = int(rng.integers(-pad + 1, pad))
        src = np.clip(pad + np.arange(R) + np.where(np.arange(R) > R // 2,
                                                    gap, 0), 0, W - 1)
        tgt[b] = win[b, src]
    qual = rng.integers(20, 45, (B, R))
    opn = rng.integers(1, 4, (B, W))
    ext = rng.integers(0, 2, (B, W))
    mask = np.full((B, W), pb.PAD_CODE)
    prior = np.zeros((B, W))
    return [np.ascontiguousarray(a, np.int32)
            for a in (tgt, qual, win, opn, ext, mask, prior)]


def test_split_chain_equals_log_step_scan():
    rng = np.random.default_rng(11)
    for D in (16, 32, 64):
        bv = rng.integers(0, 300, (D, 40))
        bv[rng.random((D, 40)) < 0.3] = pb.INF + 9
        bv[0] = 2 * pb.INF
        ev = rng.integers(0, 65, (D, 40))
        bv, ev = (torch.from_numpy(a.astype(np.int32)) for a in (bv, ev))
        want = pb._deletion_scan(bv, ev, D)
        for T in pb.THREADS:
            if T <= D:
                assert torch.equal(pb._deletion_split(bv, ev, D, T), want)


@pytest.mark.parametrize("pad", [8, 16, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_split_matches_xla(seed, pad):
    batch, _ = make_batch(seed + 20, B=24, pad=pad, rmax=40)
    want = np.asarray(pairhmm_scores_xla(*batch, pad=pad))
    for T in SPLIT_THREADS:
        np.testing.assert_array_equal(split(batch, pad, T), want)


@pytest.mark.parametrize("pad", [8, 16, 32])
def test_split_matches_xla_heavy_indel(pad):
    batch = heavy_indel_batch(pad, B=32, pad=pad)
    want = np.asarray(pairhmm_scores_xla(*batch, pad=pad))
    for T in pb.THREADS:
        if T <= 2 * pad:
            np.testing.assert_array_equal(split(batch, pad, T), want)


@pytest.mark.parametrize("pad", [8, 16])
def test_split_matches_pallas_v9_interpret(pad):
    batch, _ = make_batch(seed=5 + pad, B=LANES, pad=pad, rmax=24)
    argsT = [np.ascontiguousarray(a.T) for a in batch]
    want = np.asarray(pairhmm_scores_pallas_v9(*argsT, pad=pad,
                                               interpret=True))
    for T in SPLIT_THREADS:
        np.testing.assert_array_equal(split(batch, pad, T), want)


def test_split_matches_pallas_v12_interpret():
    batch, _ = make_batch(seed=6, B=LANES * V12_GROUPS, rmax=24)
    argsT = [np.ascontiguousarray(a.T) for a in batch]
    want = np.asarray(pairhmm_scores_pallas_v12(*argsT, pad=8,
                                                interpret=True))
    for T in SPLIT_THREADS:
        np.testing.assert_array_equal(split(batch, 8, T), want)


@pytest.mark.parametrize("kind", sorted(GOLDEN_CASES))
def test_split_matches_golden_binary(kind):
    if not os.path.exists(HARNESS):
        pytest.skip("golden harness not built")
    cases, pad = GOLDEN_CASES[kind]()
    want = run_reference(cases, pad=pad)
    batch = pack_cases(cases, pad)
    for T in SPLIT_THREADS:
        assert split(batch, pad, T).tolist() == want


def test_split_refuses_bad_threads():
    batch, _ = make_batch(seed=3, B=4, pad=8, rmax=16)
    args = [torch.from_numpy(a) for a in batch]
    with pytest.raises(ValueError, match="threads"):
        pb.pairhmm_scores_plain(*args, pad=8, threads=3)
    with pytest.raises(ValueError, match="threads"):
        pb.pairhmm_scores_plain(*args, pad=8, threads=32)


@pytest.mark.parametrize("pad", [8, 16, 32])
def test_variant_rules_pick_built_variants(pad):
    for B in (1, 17, 519, pb.WAVE_BELOW - 1, pb.WAVE_BELOW, 65536):
        T = pb.pairhmm_threads(B, pad)
        assert T in pb.THREADS and T <= 2 * pad
        assert not pb.pairhmm_wave(B, pad) or pb.wave_ok(T, pad)
        assert pb.lanes_width(B, pad) in pb.lanes_widths(pad)
    # a launch of a few hundred pairs takes the wavefront, the bench shape
    # the split chain
    assert pb.pairhmm_wave(300, pad) and not pb.pairhmm_wave(65536, pad)


def test_launchers_refuse_bad_variants_and_layouts():
    batch, _ = make_batch(seed=3, B=4, pad=8, rmax=16)
    args = [torch.from_numpy(a) for a in batch]
    with pytest.raises(ValueError, match="threads"):
        pb.launch_kernel(args, pad=8, threads=32)
    with pytest.raises(ValueError, match="wavefront"):
        pb.launch_kernel(args, pad=8, threads=1, wave=True)
    with pytest.raises(ValueError, match="wavefront"):
        pb.launch_kernel(args, pad=8, threads=16, wave=True)
    with pytest.raises(ValueError, match="lanes"):
        pb.launch_lanes(args, pad=8, lanes=4)
    # row-major (rows, B) kernel-layout tracks are refused
    with pytest.raises(ValueError, match=r"\(B, R\)"):
        pb.launch_kernel([a.t().contiguous() for a in args], pad=8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pb.launch_kernel(args, pad=8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pb.launch_kernel(args, pad=8, threads=4, wave=True)
