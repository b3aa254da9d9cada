"""Dense germline calling through the stateful haplotype generator, the
port against the JAX package on the CPU.

A simulated 5 kb diploid at 35x with sites 50-150 bp apart over its middle
3 kb gives one active region of more than 24 candidates, which both
callers step through the stateful generator (`_call_with_generator`), its
holdout, lagging and pruning rounds. The VCF record lines must be
identical. `--max-haplotypes 16` keeps both runs short: the generator's
route depends on the candidate count, not on the cap, and a low cap only
adds pruning rounds. The reference CLI pins its host paths by writing
OCTOPUS_TPU_HOST_HMM_MAX and OCTOPUS_TPU_HOST_LATENTS into the
environment, so both are cleared before the port runs, and its records are
made under octopus's rule for tied reads (`reference_tie_rule`).

The port's run also records every phase it opens, with the phases open
around it, and the counters of the generator (`ROUTING.hapgen_packets`,
`ROUTING.prune_rounds`); the card reduction's phase and its shapes
(`genotype_card`, `ROUTING.card_reductions`) are held on a reduction sent
to the device path on the CPU.
"""

import contextlib
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import reference_tie_rule as tie_rule
from octopus_tpu import cli as ref_cli
from octopus_tpu_torch import cli
from octopus_tpu_torch.core.likelihood import likelihood_array as la
from octopus_tpu_torch.core.models import genotype_likelihoods as gl
from octopus_tpu_torch.utils import timers
from octopus_tpu_torch.utils.synthetic import simulate_diploid

PINNED = ("OCTOPUS_TPU_HOST_HMM_MAX", "OCTOPUS_TPU_HOST_LATENTS")
ARGS = ["--max-haplotypes", "16"]


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    d = tmp_path_factory.mktemp("dense")
    fa, bam, truth, _ = simulate_diploid(str(d), kb=5, depth=35, seed=5,
                                         spacing=(50, 150))
    return d, fa, bam, truth


@pytest.fixture(scope="module")
def reference_vcf(sample):
    d, fa, bam, _ = sample
    out = str(d / "reference.vcf")
    saved = {k: os.environ.get(k) for k in PINNED}
    try:
        with tie_rule.applied():
            assert ref_cli.main(["-R", fa, "-I", bam, "-o", out, *ARGS]) == 0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


@pytest.fixture(scope="module")
def port_run(sample):
    """(VCF path, every phase opened as the tuple of the phases open from
    the outermost in, the generator's packets, its pruning rounds)."""
    d, fa, bam, _ = sample
    opened = []
    stack = []

    @contextlib.contextmanager
    def recording(name):
        stack.append(name)
        opened.append(tuple(stack))
        try:
            yield
        finally:
            stack.pop()

    mp = pytest.MonkeyPatch()
    for k in PINNED:
        mp.delenv(k, raising=False)
    mp.setattr(timers, "phase", recording)
    out = str(d / "port.vcf")
    la.ROUTING.reset()
    # one torch thread: the card's plain twin runs thousands of small ops,
    # which a thread pool shared with the other test workers slows tenfold
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert cli.main(["-R", fa, "-I", bam, "-o", out, "--device", "cpu",
                         *ARGS]) == 0
    finally:
        torch.set_num_threads(threads)
        mp.undo()
    return out, opened, la.ROUTING.hapgen_packets, la.ROUTING.prune_rounds


def records(path):
    return [line for line in Path(path).read_text().splitlines()
            if not line.startswith("##")]


def test_port_writes_the_reference_records_through_the_generator(
        sample, reference_vcf, port_run):
    out, _, packets, _ = port_run
    got, want = records(out), records(reference_vcf)
    assert got == want
    # most of the truth is called, and the generator made the haplotypes
    assert len(got) - 1 >= 0.8 * len(sample[3])
    assert packets >= 1


def test_generator_phase_holds_its_pruning_rounds(port_run):
    _, opened, packets, rounds = port_run
    assert sum(p[-1] == "hapgen_tree" for p in opened) >= packets
    inside = {p[-1] for p in opened if "hapgen_tree" in p[:-1]}
    # the pruning rounds' populate phases nest in the generator's phase
    assert {"populate_jobs", "populate_stage"} <= inside
    assert rounds > 0
    # the generator's packets are each an active region, outside the tree
    assert not any("hapgen_tree" in p and p[-1] == "active_region"
                   for p in opened)


@pytest.mark.parametrize("on_device", [False, True])
def test_card_reduction_phase_and_shapes(on_device, monkeypatch):
    """A reduction sent to the device path (the CPU's float32 twin here)
    opens genotype_card inside whatever phase is open and adds its G*H*R,
    G*H, H*R, G*R to ROUTING.card_reductions; one under the host gate
    opens no phase and adds none."""
    rng = np.random.default_rng(3)
    H, R = 5, 40
    lnL = -rng.random((H, R)) * 20
    genotypes = np.array([(i, j) for i in range(H) for j in range(i, H)])
    G = len(genotypes)
    opened = []

    @contextlib.contextmanager
    def recording(name):
        opened.append(name)
        yield

    monkeypatch.setattr(timers, "phase", recording)
    monkeypatch.setattr(gl, "HOST_GATE", 0 if on_device else 10**9)
    la.ROUTING.reset()
    gl.COUNTS.reset()
    out = gl.genotype_log_likelihoods(lnL, genotypes, device="cpu")
    want = gl.genotype_log_likelihoods_np(lnL, genotypes)
    if on_device:
        assert opened == ["genotype_card"]
        assert dict(la.ROUTING.card_reductions) == {
            "ghr": G * H * R, "gh": G * H, "hr": H * R, "gr": G * R}
        assert (gl.COUNTS.host, gl.COUNTS.device) == (0, 1)
        np.testing.assert_allclose(out, want, rtol=1e-5)
    else:
        assert opened == []
        assert not la.ROUTING.card_reductions
        assert (gl.COUNTS.host, gl.COUNTS.device) == (1, 0)
        np.testing.assert_array_equal(out, want)


def test_reset_clears_the_new_counters():
    la.ROUTING.reset()
    la.ROUTING.record_packet()
    la.ROUTING.record_prune_round()
    la.ROUTING.record_card_reduction(3, 2, 7)
    assert (la.ROUTING.hapgen_packets, la.ROUTING.prune_rounds) == (1, 1)
    assert dict(la.ROUTING.card_reductions) == {"ghr": 42, "gh": 6, "hr": 14,
                                                "gr": 21}
    la.ROUTING.reset()
    assert la.ROUTING.hapgen_packets == 0
    assert la.ROUTING.prune_rounds == 0
    assert not la.ROUTING.card_reductions
    gl.COUNTS.device, gl.COUNTS.host = 2, 3
    gl.COUNTS.reset()
    assert (gl.COUNTS.host, gl.COUNTS.device) == (0, 0)
