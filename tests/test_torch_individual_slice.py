"""The slice end to end: reads -> IndividualCaller -> VCF records.

A ~5 kb simulated diploid goes through the reference package (JAX on the
CPU) and through the port (device="cpu") with identical settings; the VCF
record lines must be identical. The variant spacing and haplotype cap make
some windows dense enough for the haplotype beam.
"""

import dataclasses

import numpy as np
import pytest
import torch

from octopus_tpu.basics.reads import make_read_batch as ref_make_read_batch
from octopus_tpu.core.callers.individual import CallerConfig as RefConfig
from octopus_tpu.core.callers.individual import IndividualCaller as RefCaller
from octopus_tpu.core.tools import vcf_record_factory as ref_vrf
from octopus_tpu.io.fasta import InMemoryReference as RefInMemory
from octopus_tpu.io.fasta import ReferenceGenome as RefGenome
from octopus_tpu.utils import synthetic as ref_synthetic
from octopus_tpu_torch.basics.reads import make_read_batch
from octopus_tpu_torch.convert import caller_config_from_reference
from octopus_tpu_torch.core.callers.base import BaseCallerConfig
from octopus_tpu_torch.core.callers.individual import IndividualCaller
from octopus_tpu_torch.core.hapgen import beam
from octopus_tpu_torch.core.likelihood import likelihood_array as la
from octopus_tpu_torch.core.tools import vcf_record_factory as vrf
from octopus_tpu_torch.io.fasta import InMemoryReference, ReferenceGenome
from octopus_tpu_torch.utils.synthetic import simulate_diploid_reads

KB, SPACING, MAX_HAPLOTYPES = 5, (150, 450), 8


@pytest.fixture(scope="module")
def sample():
    return simulate_diploid_reads(kb=KB, depth=30, read_len=150, seed=5,
                                  spacing=SPACING)


def reference_lines(seq, reads, n, config):
    ref = RefGenome(RefInMemory({"chr1": seq}))
    batch = ref_make_read_batch("chr1", reads).sorted_by_begin()
    calls = RefCaller(ref, "chr1", config).call(0, n, batch)
    return [ref_vrf.site_call_to_record(c, "chr1", ref).to_line()
            for c in calls]


def port_lines(seq, reads, n, config):
    ref = ReferenceGenome(InMemoryReference({"chr1": seq}))
    batch = make_read_batch("chr1", reads).sorted_by_begin()
    calls = IndividualCaller(ref, "chr1", config).call(0, n, batch)
    return [vrf.site_call_to_record(c, "chr1", ref).to_line() for c in calls]


@pytest.mark.parametrize("gate", [384, 0])
def test_port_writes_the_reference_records(sample, gate, monkeypatch):
    seq, reads, truth, n = sample
    monkeypatch.setenv("OCTOPUS_TPU_HOST_HMM_MAX", str(gate))
    ref_config = RefConfig(max_haplotypes=MAX_HAPLOTYPES)
    want = reference_lines(seq, reads, n, ref_config)
    config = caller_config_from_reference(dataclasses.asdict(ref_config),
                                          device="cpu")
    config.likelihood.host_hmm_max = gate
    grown = []
    real_grow = beam.grow_haplotypes_beam
    monkeypatch.setattr(beam, "grow_haplotypes_beam",
                        lambda *a, **k: grown.append(1) or real_grow(*a, **k))
    la.ROUTING.reset()
    got = port_lines(seq, reads, n, config)
    assert got == want
    assert len(got) >= len(truth) - 1
    assert grown, "no window was dense enough for the haplotype beam"
    assert la.ROUTING.device_job_sets > 0


def test_simulator_matches_the_reference_rng_sequence(sample, tmp_path):
    seq, reads, truth, n = sample
    _, _, ref_truth, ref_n = ref_synthetic.simulate_diploid(
        str(tmp_path), kb=KB, seed=5, spacing=SPACING)
    assert ref_truth == truth and ref_n == n
    assert len(reads) > 0 and all(len(r[2]) == 150 for r in reads)


def test_config_conversion_keeps_every_setting():
    ref_config = RefConfig(max_haplotypes=17, ploidy=3,
                           haplotype_holdout_threshold=99)
    ref_config.likelihood.max_indel_error = 32
    ref_config.scanner.min_bq = 11
    config = caller_config_from_reference(dataclasses.asdict(ref_config),
                                          device="cpu")
    d = dataclasses.asdict(config)
    assert d.pop("device") == "cpu"
    assert d.pop("defer_heavy") == 0
    assert d["likelihood"].pop("device") == "cpu"
    assert d["likelihood"].pop("host_hmm_max") == 384
    assert d == dataclasses.asdict(ref_config)


def test_default_device_raises_without_cuda(sample):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    seq, _, _, _ = sample
    ref = ReferenceGenome(InMemoryReference({"chr1": seq}))
    assert BaseCallerConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        IndividualCaller(ref, "chr1")


def test_truth_is_called(sample):
    seq, reads, truth, n = sample
    got = port_lines(seq, reads, n, BaseCallerConfig(
        device="cpu", max_haplotypes=MAX_HAPLOTYPES))
    called = np.asarray(sorted(int(line.split("\t")[1]) - 1 for line in got))
    hits = [np.abs(called - p).min() <= 5 for p in truth]
    assert np.mean(hits) >= 0.95
