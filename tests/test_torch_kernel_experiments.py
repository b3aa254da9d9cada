"""The kernel experiments' ports held against the reference's experiments.

experiments/*.py are the reference's Pallas probes of the pair-HMM kernel
(dual_chain, v10_kernel, v11_kernel, v13_unroll2, i16_probe). Each is loaded
by file path and run in TPU interpret mode on the CPU; the port's entry
point (octopus_tpu_torch/kernel_experiments/) runs its plain version on the
same numpy-seeded inputs, the experiments' check_parity distributions, for
every K or blk of the experiment's __main__. Scores are int32 and int16, so
every comparison is exact. v10's rewritten arithmetic is also held against
Pallas v9 directly, and so is the order of work of v10's Hopper kernel
(`v10_schedule_plain`), against Pallas v10 too. The kernels themselves
(csrc/exp_*.cu) run on the card in test_torch_cuda.py; here their wrappers
must refuse CPU tensors and a missing card.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from octopus_tpu.core.likelihood.pairhmm_batch import pairhmm_scores_pallas_v9
from octopus_tpu_torch.kernel_experiments import (
    _common as xc,
    dual_chain,
    i16_probe,
    v10_kernel,
    v11_kernel,
    v13_unroll2,
)

ROOT = Path(__file__).resolve().parent.parent


@functools.cache
def experiment(name):
    """experiments/<name>.py, loaded (and, for i16_probe, run) in TPU
    interpret mode."""
    spec = importlib.util.spec_from_file_location(
        f"reference_experiments_{name}", ROOT / "experiments" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    with pltpu.force_tpu_interpret_mode():
        spec.loader.exec_module(module)
    return module


def interpret(fn, *args, **kw):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*args, **kw))


@functools.cache
def reference(name, fn_name, B, win_hi, rows=xc.R, kind=None, **kw):
    """experiments/<name>.py's fn_name in interpret mode on `inputs`."""
    return interpret(getattr(experiment(name), fn_name),
                     *inputs(B, win_hi, rows, kind), pad=xc.PAD, **kw)


@functools.cache
def reference_v9(B, win_hi, rows=xc.R, kind=None):
    """Pallas v9 in interpret mode on `inputs`."""
    return interpret(pairhmm_scores_pallas_v9, *inputs(B, win_hi, rows, kind),
                     pad=xc.PAD, interpret=True)


@functools.cache
def inputs(B, win_hi, rows=xc.R, kind=None):
    """The check_parity tracks, or (kind set) the edge inputs of
    `rows` read bases."""
    if kind is None:
        return tuple(xc.parity_inputs(B, win_hi))
    return tuple(xc.edge_inputs(B, rows, kind))


# (experiment file, its function, the port's entry point, keyword, B,
# window bases drawn from [0, win_hi)): every variant of each __main__, at
# the check_parity distributions (dual_chain's windows have no N)
SCORER_CASES = (
    [("dual_chain", "scores_dual", dual_chain.scores_dual, {"K": K}, 1024, 4)
     for K in dual_chain.K_VARIANTS]
    + [("v10_kernel", "scores_v10", v10_kernel.scores_v10, {"K": K}, 1024, 5)
       for K in v10_kernel.K_VARIANTS]
    + [("v11_kernel", "scores_v11", v11_kernel.scores_v11, {"blk": b}, 1024, 5)
       for b in v11_kernel.BLK_VARIANTS]
    + [("v13_unroll2", "scores_v13", v13_unroll2.scores_v13, {"K": K},
        1024 if K == 4 else 1536, 5) for K in v13_unroll2.K_VARIANTS])
SCORER_CASES = [c + (xc.R, None) for c in SCORER_CASES]
# v11 and v13 at the edge shapes the bench never hits (xc.EDGE_CASES: odd
# and even R from 2, R off the 16-row period and the 8-row chunk, half the
# window bases N, opn and ext just below 2^22): v11 at every shape and v13
# (4-12x slower in interpret mode) at the first four, which cover every
# kind, at the experiments' default keyword; one at the other
SCORER_CASES += (
    [("v11_kernel", "scores_v11", v11_kernel.scores_v11, {"blk": 1}, 128, 5,
      rows, kind) for rows, kind in xc.EDGE_CASES]
    + [("v13_unroll2", "scores_v13", v13_unroll2.scores_v13, {"K": 4}, 512, 5,
        rows, kind) for rows, kind in xc.EDGE_CASES[:4]]
    + [("v11_kernel", "scores_v11", v11_kernel.scores_v11, {"blk": 2}, 256, 5,
        17, "n_bases"),
       ("v13_unroll2", "scores_v13", v13_unroll2.scores_v13, {"K": 6}, 768, 5,
        3, "parity")])


def case_id(case):
    name, _, _, kw, _, _, rows, kind = case
    (key, value), = kw.items()
    return f"{name}-{key}{value}" + (f"-R{rows}-{kind}" if kind else "")


@pytest.mark.parametrize("name,fn_name,port,kw,B,win_hi,rows,kind",
                         SCORER_CASES, ids=[case_id(c) for c in SCORER_CASES])
def test_port_equals_the_experiment(name, fn_name, port, kw, B, win_hi, rows,
                                    kind):
    tracks = inputs(B, win_hi, rows, kind)
    want = reference(name, fn_name, B, win_hi, rows, kind, **kw)
    got = port(*tracks, pad=xc.PAD, device="cpu", **kw).numpy()
    assert got.dtype == np.int32 and got.shape == (B,)
    np.testing.assert_array_equal(got, want)


def test_v10_rewrite_equals_pallas_v9():
    """v10's own arithmetic (prologue tracks, capN, primed deletion scan)
    gives v9's integers."""
    tracks = inputs(1024, 5)
    want = reference_v9(1024, 5)
    t = [torch.from_numpy(a) for a in tracks]
    got = v10_kernel.v10_rows_plain(v10_kernel.v10_tracks(*t), pad=xc.PAD)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(xc.plain_v9(t, xc.PAD, 2).numpy(), want)


# (B, rows, kind): the parity input, then every edge shape
V10_SCHEDULE_CASES = [(1024, xc.R, None)] + [(128, rows, kind)
                                             for rows, kind in xc.EDGE_CASES]


@pytest.mark.parametrize("B,rows,kind", V10_SCHEDULE_CASES,
                         ids=[f"R{r}-{k or 'check_parity'}"
                              for _, r, k in V10_SCHEDULE_CASES])
def test_v10_schedule_equals_pallas_v10_and_v9(B, rows, kind):
    """The order of work of v10's Hopper kernel (values derived once a
    window position as it enters the band, pre a running sum, row 0 from
    the first 16 positions) gives Pallas v10's and v9's integers and the
    plain version's, at the parity input and the edge shapes (R 2-41, half
    N, opn and ext near 2^22)."""
    t = [torch.from_numpy(a) for a in inputs(B, 5, rows, kind)]
    got = v10_kernel.v10_schedule_plain(*t, pad=xc.PAD).numpy()
    assert got.dtype == np.int32 and got.shape == (B,)
    np.testing.assert_array_equal(
        got, reference("v10_kernel", "scores_v10", B, 5, rows, kind, K=1))
    np.testing.assert_array_equal(got, reference_v9(B, 5, rows, kind))
    np.testing.assert_array_equal(
        got, v10_kernel.v10_rows_plain(v10_kernel.v10_tracks(*t),
                                       pad=xc.PAD).numpy())


def test_i16_probe_equals_the_experiment_on_its_input():
    module = experiment("i16_probe")
    got = i16_probe.probe(device="cpu")
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), np.asarray(module.out))
    assert [int(v) for v in got[:3, 0]] == [51, 50, 49]


def test_i16_probe_equals_the_experiment_on_seeded_input():
    rng = np.random.default_rng(16)
    a, b = (rng.integers(0, 1000, (16, 256)).astype(np.int16) for _ in range(2))
    b[:, ::3] = a[:, ::3]                      # equal entries take the min
    want = interpret(experiment("i16_probe").run, a, b)
    got = i16_probe.run(a, b, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def _cpu_tracks(B=1024):
    return [torch.from_numpy(a) for a in xc.parity_inputs(B, 5)]


CUDA_WRAPPERS = {
    "dual_chain": lambda t: dual_chain.scores_dual_cuda(*t),
    "v10": lambda t: v10_kernel.scores_v10_cuda(*t),
    "v10_launch": lambda t: v10_kernel.launch_v10(v10_kernel.v10_tracks(*t),
                                                  pad=8, variant="tracks10_K4"),
    "v10_regs_p16": lambda t: v10_kernel.launch_v10(t, pad=8,
                                                    variant="regs_p16"),
    "v10_rings": lambda t: v10_kernel.launch_v10(t, pad=8, variant="rings"),
    "v10_tracks10_call": lambda t: v10_kernel.tracks10_call(
        t, variant="tracks10_K2"),
    "v11": lambda t: v11_kernel.scores_v11_cuda(*t),
    "v11_launch": lambda t: v11_kernel.launch_v11(
        t, v11_kernel.v11_pre(t[4]), pad=8, nuc_prior=2, variant="shfl_blk1"),
    "v11_regs_p16": lambda t: v11_kernel.launch_v11(t, pad=8, nuc_prior=2,
                                                    variant="regs_ring_p16"),
    "v13": lambda t: v13_unroll2.launch_v13(t, pad=8, nuc_prior=2,
                                            variant="K4x1"),
    "v13_shared": lambda t: v13_unroll2.scores_v13_cuda(*t),
    "i16": lambda t: i16_probe.run_cuda(t[0][:16].short(), t[1][:16].short()),
}


@pytest.mark.parametrize("wrapper", sorted(CUDA_WRAPPERS))
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    with pytest.raises(ValueError, match="CUDA"):
        CUDA_WRAPPERS[wrapper](_cpu_tracks())


ENTRY_POINTS = {
    "dual_chain": lambda t: dual_chain.scores_dual(*t),
    "v10": lambda t: v10_kernel.scores_v10(*t),
    "v11": lambda t: v11_kernel.scores_v11(*t),
    "v13": lambda t: v13_unroll2.scores_v13(*t),
    "i16": lambda t: i16_probe.run(t[0][:16].short(), t[1][:16].short()),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda_and_raise_without_it(entry,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[entry](_cpu_tracks())


@pytest.mark.parametrize("port,kw", [
    (dual_chain.scores_dual, {"K": 4}), (v10_kernel.scores_v10, {"K": 8}),
    (v10_kernel.scores_v10, {"K": 2}),
    (v11_kernel.scores_v11, {"blk": 2}), (v13_unroll2.scores_v13, {"K": 6})])
def test_batch_must_divide_as_in_the_experiment(port, kw):
    with pytest.raises(ValueError, match="multiple"):
        port(*_cpu_tracks(640), device="cpu", **kw)


@pytest.mark.parametrize("launch", [
    lambda t: v11_kernel.launch_v11(t, pad=8, nuc_prior=2, variant="blk1"),
    lambda t: v13_unroll2.launch_v13(t, pad=8, nuc_prior=2, variant="K8x2"),
    lambda t: v10_kernel.launch_v10(t, pad=8, variant="K4")],
    ids=["v11", "v13", "v10"])
def test_launch_refuses_unknown_variants(launch):
    with pytest.raises(ValueError, match="variants"):
        launch(_cpu_tracks(256))


def test_v11_shfl_variants_take_pre():
    t = _cpu_tracks(256)
    with pytest.raises(ValueError, match="pre"):
        v11_kernel.launch_v11(t, pad=8, nuc_prior=2, variant="shfl_blk2")
    assert v11_kernel.v11_pre(t[4]).shape == t[4].shape


def test_v10_tracks10_takes_the_prologue_tracks():
    """The first port's variants read the prologue's ten tracks, the Hopper
    designs the seven raw ones."""
    t = _cpu_tracks(256)
    with pytest.raises(ValueError, match="takes the tracks"):
        v10_kernel.launch_v10(t, pad=8, variant="tracks10_K1")
    with pytest.raises(ValueError, match="tracks must be"):
        v10_kernel.launch_v10(v10_kernel.v10_tracks(*t), pad=8,
                              variant="regs_p16")
