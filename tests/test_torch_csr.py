"""The port's inline threshold CSR against the reference package's.

The same simulated reads are called by both packages' individual callers
(on the CPU); then, call by call, read assignment (`assign_reads_grouped`),
the measures (`compute_measures` over facet bundles) and the threshold
filter's decision must be identical, the reference's made under octopus's
rule for tied reads (`reference_tie_rule`), which the port follows.
"""

import dataclasses

import numpy as np
import pytest

import reference_tie_rule as tie_rule
from octopus_tpu import run as ref_run
from octopus_tpu.basics.reads import make_read_batch as ref_make_read_batch
from octopus_tpu.core.callers.individual import CallerConfig as RefConfig
from octopus_tpu.core.callers.individual import IndividualCaller as RefCaller
from octopus_tpu.core.csr.measures import compute_measures as ref_measures
from octopus_tpu.core.csr.threshold import ThresholdFilter as RefThreshold
from octopus_tpu.core.tools.read_assigner import (
    assign_reads_grouped as ref_assign_grouped)
from octopus_tpu.io.fasta import InMemoryReference as RefInMemory
from octopus_tpu.io.fasta import ReferenceGenome as RefGenome
from octopus_tpu.readpipe.pipe import ReadPipeReport as RefReport
from octopus_tpu_torch import run
from octopus_tpu_torch.basics.reads import make_read_batch
from octopus_tpu_torch.convert import caller_config_from_reference
from octopus_tpu_torch.core.csr import measures
from octopus_tpu_torch.core.csr.threshold import ThresholdFilter
from octopus_tpu_torch.core.likelihood import likelihood_array as la
from octopus_tpu_torch.core.tools.read_assigner import assign_reads_grouped
from octopus_tpu_torch.io.fasta import InMemoryReference, ReferenceGenome
from octopus_tpu_torch.readpipe.pipe import ReadPipeReport
from octopus_tpu_torch.utils.synthetic import simulate_diploid_reads


class Window:
    contig, begin = "chr1", 0

    def __init__(self, end):
        self.end = end


@pytest.fixture(scope="module")
def both():
    """(reference side, port side): each (reference, reads, calls)."""
    seq, reads, _, n = simulate_diploid_reads(kb=5, seed=5,
                                              spacing=(150, 450))
    ref_config = RefConfig(max_haplotypes=8)
    sides = []
    for genome, memory, make, caller, config in (
            (RefGenome, RefInMemory, ref_make_read_batch, RefCaller,
             ref_config),
            (ReferenceGenome, InMemoryReference, make_read_batch,
             run.IndividualCaller,
             caller_config_from_reference(dataclasses.asdict(ref_config),
                                          device="cpu"))):
        reference = genome(memory({"chr1": seq}))
        batch = make("chr1", reads).sorted_by_begin()
        calls = caller(reference, "chr1", config).call(0, n, [batch])
        sides.append((reference, batch, [c for c in calls if c.begin < n]))
    assert len(sides[0][2]) == len(sides[1][2]) > 3
    return sides, n


def bundles(module, side, n):
    """Facet bundles of every call, read assignments precomputed; the
    port's score on the CPU."""
    reference, batch, calls = side
    kw = ({"scoring": la.LikelihoodConfig(device="cpu")} if module is run
          else {})
    return module._make_facet_bundles(calls, Window(n), reference, [batch],
                                      ["SIM"], 2, **kw)


def test_assign_reads_grouped_equals_the_reference(both):
    sides, n = both
    jobs = []
    for module, side in ((ref_run, sides[0]), (run, sides[1])):
        facet_of_call, _ = bundles(module, side, n)
        side_jobs = []
        for bundle in dict.fromkeys(facet_of_call.values()):
            lo, _ = bundle.reference_context
            for b, haps in zip(bundle.overlapping_reads,
                               bundle.called_haplotypes_by_sample):
                side_jobs.append((b, haps, lo))
        jobs.append(side_jobs)
    la.ROUTING.reset()
    got = assign_reads_grouped(jobs[1], scoring=la.LikelihoodConfig(
        device="cpu", host_hmm_max=0))
    assert la.ROUTING.job_sets[("assignment", "pairhmm_plain")] > 0
    with tie_rule.applied():
        want = ref_assign_grouped(jobs[0])
    assert len(got) == len(want) > 0
    tied = 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.hap_of_read, w.hap_of_read)
        np.testing.assert_array_equal(g.log_likelihoods, w.log_likelihoods)
        assert sorted(g.support) == sorted(w.support)
        # each read's tie set, the haplotypes within the margin of its best
        assert [tuple(np.flatnonzero(g.ties[:, r]))
                for r in range(len(g.hap_of_read))] == w.tie_haplotypes
        tied += int((g.hap_of_read < 0).sum())
    assert tied > 0


def measure_rows(module, side, n, compute, report, csr):
    """(measures, filters) of each call of one side."""
    reference, batch, calls = side
    facet_of_call, phase_len = bundles(module, side, n)
    rows = []
    for call in calls:
        lo = max(int(call.begin) - 120, 0)
        hi = min(int(call.end) + 120, n)
        m = compute(call, batch, ref_codes=reference.fetch_codes(
            "chr1", lo, hi), ref_begin=lo,
            pipe_report=report(n_raw=len(batch), n_downsampled=len(batch)),
            reads_by_sample=[batch], facets=facet_of_call[id(call)],
            phase_length=phase_len[id(call)])
        rows.append((m, csr.classify(m)))
    return rows


def test_measures_and_threshold_filter_equal_the_reference(both):
    """The reference's side under octopus's rule for tied reads
    (`reference_tie_rule`), which the port follows."""
    sides, n = both
    misses = measures.FACET_MISSES
    with tie_rule.applied():
        want = measure_rows(ref_run, sides[0], n, ref_measures, RefReport,
                            RefThreshold())
    got = measure_rows(run, sides[1], n, measures.compute_measures,
                       ReadPipeReport, ThresholdFilter())
    assert measures.FACET_MISSES == misses
    assert got == want
    assert any(filters for _, filters in want) or all(
        "AD" in m for m, _ in want)
