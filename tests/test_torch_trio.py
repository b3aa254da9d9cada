"""The port's trio caller, PED parsing and Hardy-Weinberg prior against the
reference's, on the CPU.

The cases of tests/test_trio_caller.py (an inherited het, a de novo SNV,
hom-alt parents and child, and the de novo PP at three depths) put the same
numpy-seeded reads through both packages' trio callers; the trio model
reduces on the host in float64, so the SiteCalls must agree exactly and
every quality to 1e-9. tests/test_pedigree_hw.py's PED file and
Hardy-Weinberg priors must give the same trios and log priors.
"""

import numpy as np
import pytest

from octopus_tpu.core.callers import trio as ref_trio
from octopus_tpu.core.models.hardy_weinberg import \
    HardyWeinbergModel as RefHardyWeinbergModel
from octopus_tpu.io.pedigree import Pedigree as RefPedigree
from octopus_tpu_torch.core.callers import trio
from octopus_tpu_torch.core.models import genotype_likelihoods
from octopus_tpu_torch.core.models.hardy_weinberg import HardyWeinbergModel
from octopus_tpu_torch.core.types.genotypes import generate_all_genotypes
from octopus_tpu_torch.io.pedigree import Pedigree
from tests.test_torch_population import (assert_same_calls, diploid_reads,
                                         other, reference_sequence, run_both)


def inherited_het(n_reads=80):
    """Het mother, hom-ref father, het child: inherited, not de novo."""
    seq = reference_sequence(10)
    alt = other(seq[300])
    return seq, [diploid_reads(seq, ({300: alt}, {}), seed=11),
                 diploid_reads(seq, ({}, {}), seed=12),
                 diploid_reads(seq, ({300: alt}, {}), seed=13)]


def denovo(n_reads=80):
    seq = reference_sequence(20)
    alt = other(seq[250])
    return seq, [diploid_reads(seq, ({}, {}), seed=21),
                 diploid_reads(seq, ({}, {}), seed=22),
                 diploid_reads(seq, ({250: alt}, {}), seed=23, n_reads=120)]


def hom_parents_hom_child(n_reads=80):
    seq = reference_sequence(30)
    alt = other(seq[350])
    hom = ({350: alt}, {350: alt})
    return seq, [diploid_reads(seq, hom, seed=31 + i) for i in range(3)]


def denovo_at_depth(n_reads):
    """tests/test_trio_caller.py's PP calibration trio at n_reads a sample."""
    seq = reference_sequence(40)
    alt = other(seq[250])
    return seq, [diploid_reads(seq, ({}, {}), seed=41, n_reads=n_reads),
                 diploid_reads(seq, ({}, {}), seed=42, n_reads=n_reads),
                 diploid_reads(seq, ({250: alt}, {}), seed=43,
                               n_reads=n_reads)]


CASES = {"inherited_het": (inherited_het, 80),
         "denovo": (denovo, 80),
         "hom_parents_hom_child": (hom_parents_hom_child, 80),
         **{f"denovo_pp_{n}_reads": (denovo_at_depth, n)
            for n in (100, 200, 400)}}


def run_trio(case):
    build, n_reads = CASES[case]
    seq, samples = build(n_reads)
    return run_both(ref_trio.TrioCaller,
                    ref_trio.TrioCallerConfig(use_device=False),
                    trio.TrioCaller, trio.TrioCallerConfig, seq, samples)


@pytest.mark.parametrize("case", sorted(CASES))
def test_trio_caller_gives_the_reference_calls(case):
    got, want = run_trio(case)
    assert_same_calls(got, want)
    if case == "inherited_het":
        assert len(got) == 1 and "DENOVO" not in got[0].info
        assert [sorted(g) for g in got[0].genotypes] == [[0, 1], [0, 0], [0, 1]]
    elif case == "hom_parents_hom_child":
        assert got[0].genotypes == [[1, 1]] * 3
        assert "DENOVO" not in got[0].info
    else:
        dn = [c for c in got if c.info.get("DENOVO")]
        assert len(dn) == 1 and dn[0].begin == 250
        assert dn[0].genotypes[:2] == [[0, 0], [0, 0]]


def test_denovo_pp_rises_with_depth_as_in_the_reference():
    """The de novo PP sits below the default filter's PP 40 at ~15x, near it
    at ~30x and past it at ~60x (tests/test_trio_caller.py)."""
    pps = {}
    for n in (100, 200, 400):
        got, _ = run_trio(f"denovo_pp_{n}_reads")
        pps[n] = next(c.info["PP"] for c in got if c.info.get("DENOVO"))
    assert pps[100] < 30 and 20 < pps[200] < 60 and pps[400] > 60


def test_trio_caller_keeps_a_cpu_run_off_the_card(monkeypatch):
    monkeypatch.setattr(genotype_likelihoods, "HOST_GATE", 0)
    seq, samples = denovo()
    config = trio.TrioCallerConfig(device="cpu")
    config.likelihood.device = "cpu"
    genotype_likelihoods.COUNTS.reset()
    from octopus_tpu_torch.basics.reads import make_read_batch
    from octopus_tpu_torch.io.fasta import InMemoryReference, ReferenceGenome
    calls = trio.TrioCaller(
        ReferenceGenome(InMemoryReference({"chr1": seq})), "chr1",
        config).call(0, len(seq), [make_read_batch("chr1", r).sorted_by_begin()
                                   for r in samples])
    assert [c.begin for c in calls] == [250]
    assert genotype_likelihoods.COUNTS.device > 0


PED = ("#comment\n"
       "FAM1 NA12878 NA12891 NA12892 2 1\n"
       "FAM1 NA12891 0 0 1 1\n"
       "FAM1 NA12892 0 0 2 1\n")


@pytest.mark.parametrize("samples", [
    ["NA12878", "NA12891", "NA12892"], ["NA12892", "NA12878", "NA12891"],
    ["NA12878", "NA12891"], ["X", "Y", "Z"]])
def test_pedigree_finds_the_reference_trio(tmp_path, samples):
    ped = tmp_path / "fam.ped"
    ped.write_text(PED)
    got = Pedigree.read(str(ped)).find_trio(samples)
    want = RefPedigree.read(str(ped)).find_trio(samples)
    assert (got is None) == (want is None)
    if want is not None:
        assert (got.maternal, got.paternal, got.child) == (
            want.maternal, want.paternal, want.child) == (
            "NA12892", "NA12891", "NA12878")


@pytest.mark.parametrize("n_haplotypes,ploidy", [(2, 2), (4, 2), (5, 3)])
def test_hardy_weinberg_gives_the_reference_priors(n_haplotypes, ploidy):
    gts = generate_all_genotypes(n_haplotypes, ploidy)
    got = HardyWeinbergModel(n_haplotypes=n_haplotypes).evaluate_many(gts)
    want = RefHardyWeinbergModel(n_haplotypes=n_haplotypes).evaluate_many(gts)
    assert np.array_equal(got, want)
    assert np.exp(got).sum() == pytest.approx(1.0)
