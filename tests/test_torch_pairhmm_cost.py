"""csrc/pairhmm_cost.cu's split deletion chain, held against the reference.

The cost kernel gives a pair T threads, each running the deletion chain
over its K = D/T diagonals, carried across the threads by a log2(T)-step
scan of min-plus maps. `pairhmm_scores_cost_plain(threads=T)` follows that
order over the same (R*D, B) match-cost tensor; here it must give the
integers of Pallas v2 (the TPU kernel it replaces) in interpret mode and of
the XLA wavefront, at bands 8, 16 and 32, every T up to D, on ragged
batches with heavy indels. The wrapper's rule and checks run here too; the
kernel itself runs in test_torch_cuda.py on the card.
"""

import numpy as np
import pytest
import torch

from octopus_tpu.core.likelihood.pairhmm_batch import (
    LANES,
    pairhmm_scores_pallas_v2,
    pairhmm_scores_xla,
)
from octopus_tpu_torch.core.likelihood import pairhmm_batch as pb
from test_pairhmm_batch import make_batch
from test_torch_pairhmm_split import heavy_indel_batch


def cost_split(batch, pad, threads):
    args = [torch.from_numpy(np.ascontiguousarray(a, np.int32)) for a in batch]
    return pb.pairhmm_scores_cost_plain(*args, pad=pad,
                                        threads=threads).numpy()


def every_t(pad):
    return [T for T in pb.THREADS if T <= 2 * pad]


@pytest.mark.parametrize("pad", [8, 16, 32])
def test_cost_split_matches_pallas_v2_interpret(pad):
    # Pallas v2 takes whole blocks of LANES pairs; the ragged tail is held
    # against XLA below
    batch = heavy_indel_batch(40 + pad, B=LANES, pad=pad, R=24)
    want = np.asarray(pairhmm_scores_pallas_v2(*batch, pad=pad,
                                               interpret=True))
    np.testing.assert_array_equal(
        np.asarray(pairhmm_scores_xla(*batch, pad=pad)), want)
    for T in every_t(pad):
        np.testing.assert_array_equal(cost_split(batch, pad, T), want)


@pytest.mark.parametrize("B", [1, 9, 37])
@pytest.mark.parametrize("pad", [8, 16, 32])
def test_cost_split_matches_xla_ragged(pad, B):
    heavy = heavy_indel_batch(B + pad, B=B, pad=pad, R=33)
    mixed, _ = make_batch(B * pad, B=B, pad=pad, rmax=40)
    for batch in (heavy, mixed):
        want = np.asarray(pairhmm_scores_xla(*batch, pad=pad))
        for T in every_t(pad):
            np.testing.assert_array_equal(cost_split(batch, pad, T), want)


@pytest.mark.parametrize("pad", [8, 16, 32])
def test_cost_rule_picks_built_variants(pad):
    for B in (1, 9, 519, 2047, 2048, 16383, 16384, 65536):
        assert pb.cost_threads_ok(pb.cost_threads(B, pad), pad)
    # few pairs take the most threads a pair, the bench shape the fewest
    # that hold the band
    assert pb.cost_threads(519, pad) == pb.THREADS[-1]
    assert pb.cost_threads(65536, pad) == max(2, 2 * pad // 16)
    # a thread holds at most COST_MAX_DIAGONALS diagonals: no band spills
    built = [T for T in pb.THREADS if pb.cost_threads_ok(T, pad)]
    assert built and all(2 * pad // T <= pb.COST_MAX_DIAGONALS for T in built)
    assert max(built) == pb.THREADS[-1]


def test_cost_twin_and_launcher_refuse_bad_threads():
    batch, _ = make_batch(seed=3, B=4, pad=8, rmax=16)
    args = [torch.from_numpy(a) for a in batch]
    with pytest.raises(ValueError, match="threads"):
        pb.pairhmm_scores_cost_plain(*args, pad=8, threads=3)
    with pytest.raises(ValueError, match="threads"):
        pb.pairhmm_scores_cost_plain(*args, pad=8, threads=32)
    tracks32, _ = make_batch(seed=3, B=4, pad=32, rmax=16)
    opnT, extT = (torch.from_numpy(a).t().contiguous() for a in tracks32[3:5])
    cm = pb.match_cost_tensor(*(torch.from_numpy(tracks32[i])
                                for i in (0, 1, 2, 5, 6)), pad=32)
    # band 64 at one thread a pair would hold 64 diagonals a thread
    with pytest.raises(ValueError, match="variant"):
        pb.launch_cost(cm, opnT, extT, pad=32, threads=1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pb.launch_cost(cm, opnT, extT, pad=32, threads=4)
