"""The port's pair-HMM scorers against the reference package's scorers.

Each plain PyTorch twin must be bit-identical to the XLA wavefront, to the
Pallas kernel it stands for run in interpret mode (v9 and v12 for
`pairhmm_scores_plain`, v8 for `pairhmm_scores_lanes_plain`, v2 for
`pairhmm_scores_cost_plain`), and to the reference C++ kernel through the
golden harness, at pads 8/16/32. The CUDA kernels are held against their
plain twins and the harness in test_torch_cuda.py.
"""

import os

import numpy as np
import pytest
import torch

from octopus_tpu.core.likelihood.pairhmm_batch import (
    LANES,
    V12_GROUPS,
    pairhmm_scores_pallas_v2,
    pairhmm_scores_pallas_v8,
    pairhmm_scores_pallas_v9,
    pairhmm_scores_pallas_v12,
    pairhmm_scores_xla,
)
from octopus_tpu_torch.core.likelihood import pairhmm_batch as pb
from test_pairhmm_batch import make_batch
from test_pairhmm_golden import HARNESS, run_reference
from test_torch_cuda import GOLDEN_CASES, pack_cases


def plain(batch, pad, fn=pb.pairhmm_scores_plain):
    args = [torch.from_numpy(np.ascontiguousarray(a, np.int32)) for a in batch]
    return fn(*args, pad=pad).numpy()


TWINS = {"v8_lanes": pb.pairhmm_scores_lanes_plain,
         "v2_cost": pb.pairhmm_scores_cost_plain}


@pytest.mark.parametrize("pad", [8, 16, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_xla(seed, pad):
    batch, _ = make_batch(seed, B=24, pad=pad, rmax=40)
    want = np.asarray(pairhmm_scores_xla(*batch, pad=pad))
    np.testing.assert_array_equal(plain(batch, pad), want)


def test_plain_matches_pallas_v9_interpret():
    batch, _ = make_batch(seed=5, B=LANES, rmax=24)
    argsT = [np.ascontiguousarray(a.T) for a in batch]
    want = np.asarray(pairhmm_scores_pallas_v9(*argsT, pad=8, interpret=True))
    np.testing.assert_array_equal(plain(batch, 8), want)


def test_plain_matches_pallas_v12_interpret():
    batch, _ = make_batch(seed=6, B=LANES * V12_GROUPS, rmax=24)
    argsT = [np.ascontiguousarray(a.T) for a in batch]
    want = np.asarray(pairhmm_scores_pallas_v12(*argsT, pad=8, interpret=True))
    np.testing.assert_array_equal(plain(batch, 8), want)


@pytest.mark.parametrize("kind", sorted(GOLDEN_CASES))
def test_plain_matches_golden_binary(kind):
    if not os.path.exists(HARNESS):
        pytest.skip("golden harness not built")
    cases, pad = GOLDEN_CASES[kind]()
    want = run_reference(cases, pad=pad)
    got = plain(pack_cases(cases, pad), pad)
    assert got.tolist() == want


@pytest.mark.parametrize("seed", [3, 8])
def test_lanes_plain_matches_pallas_v8_interpret_and_xla(seed):
    batch, _ = make_batch(seed=seed, B=LANES, rmax=32)
    argsT = [np.ascontiguousarray(a.T) for a in batch]
    want = np.asarray(pairhmm_scores_pallas_v8(*argsT, pad=8, interpret=True))
    np.testing.assert_array_equal(np.asarray(pairhmm_scores_xla(*batch, pad=8)),
                                  want)
    np.testing.assert_array_equal(
        plain(batch, 8, pb.pairhmm_scores_lanes_plain), want)


def test_cost_plain_matches_pallas_v2_interpret():
    batch, _ = make_batch(seed=4, B=LANES, rmax=32)
    want = np.asarray(pairhmm_scores_pallas_v2(*batch, pad=8, interpret=True))
    np.testing.assert_array_equal(
        plain(batch, 8, pb.pairhmm_scores_cost_plain), want)


@pytest.mark.parametrize("pad", [8, 16, 32])
@pytest.mark.parametrize("twin", sorted(TWINS))
def test_twins_match_xla(twin, pad):
    batch, _ = make_batch(seed=pad, B=24, pad=pad, rmax=40)
    want = np.asarray(pairhmm_scores_xla(*batch, pad=pad))
    np.testing.assert_array_equal(plain(batch, pad, TWINS[twin]), want)


@pytest.mark.parametrize("kind", sorted(GOLDEN_CASES))
@pytest.mark.parametrize("twin", sorted(TWINS))
def test_twins_match_golden_binary(twin, kind):
    if not os.path.exists(HARNESS):
        pytest.skip("golden harness not built")
    cases, pad = GOLDEN_CASES[kind]()
    want = run_reference(cases, pad=pad)
    got = plain(pack_cases(cases, pad), pad, TWINS[twin])
    assert got.tolist() == want


def test_match_cost_tensor_matches_xla():
    from octopus_tpu.core.likelihood.pairhmm_batch import (
        _match_cost_tensor as xla_cost)
    batch, _ = make_batch(seed=2, B=16, pad=16, rmax=24)
    tgt, qual, win, _, _, mask, prior = batch
    want = np.asarray(xla_cost(*(a.T for a in (tgt, qual, win, mask, prior)),
                               24, 32))
    got = pb.match_cost_tensor(*(torch.from_numpy(a) for a in
                                 (tgt, qual, win, mask, prior)), pad=16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dispatch_runs_lanes_twin_when_unrolled(monkeypatch):
    batch, _ = make_batch(seed=3, B=8, pad=8, rmax=24)
    ran = []
    real = pb.pairhmm_scores_lanes_plain
    monkeypatch.setattr(pb, "pairhmm_scores_lanes_plain",
                        lambda *a, **k: ran.append(1) or real(*a, **k))
    monkeypatch.setenv("OCTOPUS_TPU_UNROLLED_HMM", "1")
    before = [c.launches for c in pb.KERNEL_COUNTS.values()]
    assert pb.scorer_name(torch.device("cpu")) == "pairhmm_lanes_plain"
    got = pb.pairhmm_scores(*batch, pad=8, device="cpu")
    assert ran == [1]
    np.testing.assert_array_equal(got.numpy(), plain(batch, 8))
    assert [c.launches for c in pb.KERNEL_COUNTS.values()] == before
    monkeypatch.delenv("OCTOPUS_TPU_UNROLLED_HMM")
    assert pb.scorer_name(torch.device("cpu")) == "pairhmm_plain"
    pb.pairhmm_scores(*batch, pad=8, device="cpu")
    assert ran == [1]


def test_dispatch_runs_plain_on_cpu_and_takes_numpy():
    batch, _ = make_batch(seed=3, B=8, pad=8, rmax=24)
    before = pb.COUNTS.launches
    got = pb.pairhmm_scores(*batch, pad=8, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), plain(batch, 8))
    assert pb.COUNTS.launches == before


def test_dispatch_defaults_to_cuda_for_numpy(monkeypatch):
    batch, _ = make_batch(seed=3, B=4, pad=8, rmax=16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pb.pairhmm_scores(*batch, pad=8)
    # torch inputs stay where they are
    got = pb.pairhmm_scores(*(torch.from_numpy(a) for a in batch), pad=8)
    np.testing.assert_array_equal(got.numpy(), plain(batch, 8))


@pytest.mark.parametrize("wrapper", ["pairhmm_scores_cuda",
                                     "pairhmm_scores_lanes_cuda",
                                     "pairhmm_scores_cost_cuda"])
def test_cuda_wrapper_refuses_cpu_tensors(wrapper):
    batch, _ = make_batch(seed=3, B=4, pad=8, rmax=16)
    args = [torch.from_numpy(a) for a in batch]
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(pb, wrapper)(*args, pad=8)


def test_kernel_launchers_refuse_cpu_tensors():
    batch, _ = make_batch(seed=3, B=4, pad=8, rmax=16)
    args = [torch.from_numpy(a) for a in batch]
    with pytest.raises(ValueError, match="CUDA tensors"):
        pb.launch_lanes(args, pad=8)
    cm = pb.match_cost_tensor(*(args[i] for i in (0, 1, 2, 5, 6)), pad=8)
    opnT, extT = (a.t().contiguous() for a in args[3:5])
    with pytest.raises(ValueError, match="CUDA tensors"):
        pb.launch_cost(cm, opnT, extT, pad=8)


def test_shape_checks():
    batch, _ = make_batch(seed=3, B=4, pad=8, rmax=16)
    args = [torch.from_numpy(a) for a in batch]
    with pytest.raises(ValueError, match="pad"):
        pb.pairhmm_scores_plain(*args, pad=12)
    with pytest.raises(ValueError, match="win"):
        pb.pairhmm_scores_plain(*args, pad=16)
