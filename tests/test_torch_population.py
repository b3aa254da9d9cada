"""The port's population caller and its EM reduction against the
reference's, on the CPU.

The cases of tests/test_population_caller.py (a private and a shared
variant, each with the joint and the independent model) and of
tests/test_population_joint_large.py (the EM marginals and top-k tuple
selection; a ten-sample cohort whose joint prior recovers a thin shared
variant) put the same numpy-seeded reads through both packages' callers.
Genotype reductions stay on the host in float64 (use_device=False), as in
the reference's tests, so the SiteCalls must agree exactly in positions,
alleles, genotypes and annotations, and in every quality to 1e-9.
"""

import dataclasses

import numpy as np
import pytest

from octopus_tpu.basics.reads import make_read_batch as ref_make_read_batch
from octopus_tpu.core.callers import population as ref_population
from octopus_tpu.core.models import population_em as ref_em
from octopus_tpu.io.fasta import InMemoryReference as RefInMemory
from octopus_tpu.io.fasta import ReferenceGenome as RefGenome
from octopus_tpu_torch.basics.reads import FLAG_REVERSE, make_read_batch
from octopus_tpu_torch.convert import caller_config_from_reference
from octopus_tpu_torch.core.callers import population
from octopus_tpu_torch.core.models import genotype_likelihoods, population_em
from octopus_tpu_torch.io.fasta import InMemoryReference, ReferenceGenome


def reference_sequence(seed, n=600):
    rng = np.random.default_rng(seed)
    return "".join("ACGT"[c] for c in rng.integers(0, 4, n))


def other(c):
    return "T" if c != "T" else "A"


def diploid_reads(seq, muts_by_hap, n_reads=80, read_len=90, seed=1):
    """Read tuples alternating over the haplotypes
    (tests/test_population_caller.py sample_reads)."""
    rng = np.random.default_rng(seed)
    haps = []
    for muts in muts_by_hap:
        s = list(seq)
        for pos, alt in muts.items():
            s[pos] = alt
        haps.append("".join(s))
    reads = []
    for i in range(n_reads):
        hap = haps[i % len(haps)]
        begin = int(rng.integers(0, len(hap) - read_len))
        reads.append((begin, f"{read_len}M", hap[begin:begin + read_len],
                      [37] * read_len, 60, FLAG_REVERSE if i % 3 == 0 else 0))
    return reads


def thin_reads(ref_seq, muts, n_reads, read_len=100, seed=1, alt_every=2):
    """Reads over position 300, every alt_every-th from the mutated
    haplotype, at base quality 21 (tests/test_population_joint_large.py
    _sample_reads)."""
    rng = np.random.default_rng(seed)
    hap = list(ref_seq)
    for pos, alt in muts.items():
        hap[pos] = alt
    hap = "".join(hap)
    reads = []
    for i in range(n_reads):
        src = hap if i % alt_every == 0 else ref_seq
        begin = int(rng.integers(max(0, 300 - read_len + 10), 300))
        reads.append((begin, f"{read_len}M", src[begin:begin + read_len],
                      [21] * read_len, 60, FLAG_REVERSE if i % 2 else 0))
    return reads


def summary(calls):
    """Per call: (the fields that must be equal, the qualities)."""
    out = []
    for c in calls:
        exact = (c.begin, c.end, c.phase_set,
                 [(v.begin, v.end, bytes(v.ref), bytes(v.alt))
                  for v in c.alts],
                 [list(map(int, g)) for g in c.genotypes],
                 {k: v for k, v in c.info.items() if not isinstance(v, float)},
                 sorted(c.info), c.model_posteriors is None,
                 c.phase_quality is None)
        qualities = ([c.quality] + list(c.genotype_qualities)
                     + list(c.alt_qualities)
                     + [v for v in c.info.values() if isinstance(v, float)]
                     + list(c.model_posteriors or [])
                     + [c.phase_quality or 0.0])
        out.append((exact, np.asarray(qualities, float)))
    return out


def assert_same_calls(got, want, tol=1e-9):
    got, want = summary(got), summary(want)
    assert [g for g, _ in got] == [w for w, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.shape == w.shape
        assert np.all((g == w) | (np.abs(g - w) <= tol)), (g, w)


def run_both(ref_caller_class, ref_config, caller_class, config_class, seq,
             samples, begin=0, end=None):
    """(the port's calls, the reference's) on the same reads."""
    end = len(seq) if end is None else end
    config = caller_config_from_reference(dataclasses.asdict(ref_config),
                                          device="cpu",
                                          config_class=config_class)
    assert type(config) is config_class
    want = ref_caller_class(RefGenome(RefInMemory({"chr1": seq})), "chr1",
                            ref_config).call(
        begin, end, [ref_make_read_batch("chr1", r).sorted_by_begin()
                     for r in samples])
    got = caller_class(ReferenceGenome(InMemoryReference({"chr1": seq})),
                       "chr1", config).call(
        begin, end, [make_read_batch("chr1", r).sorted_by_begin()
                     for r in samples])
    return got, want


def private_variant():
    """Sample A het at 300, sample B hom ref."""
    seq = reference_sequence(0)
    alt = other(seq[300])
    return seq, [diploid_reads(seq, ({300: alt}, {}), seed=2),
                 diploid_reads(seq, ({}, {}), seed=3)]


def variant_shared_by_all():
    """Sample A hom alt at 250, sample B het."""
    seq = reference_sequence(5)
    alt = other(seq[250])
    return seq, [diploid_reads(seq, ({250: alt}, {250: alt}), seed=6),
                 diploid_reads(seq, ({250: alt}, {}), seed=7)]


CASES = {f.__name__: f for f in (private_variant, variant_shared_by_all)}


def run_population(case, joint, **extra):
    seq, samples = CASES[case]()
    ref_config = ref_population.PopulationCallerConfig(
        use_device=False, joint_model=joint, **extra)
    return run_both(ref_population.PopulationCaller, ref_config,
                    population.PopulationCaller,
                    population.PopulationCallerConfig, seq, samples)


@pytest.mark.parametrize("joint", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_population_caller_gives_the_reference_calls(case, joint):
    got, want = run_population(case, joint)
    assert_same_calls(got, want)
    assert len(got) == 1
    if case == "private_variant":
        assert got[0].begin == 300
        assert sorted(got[0].genotypes[0]) == [0, 1]
        assert got[0].genotypes[1] == [0, 0]
    else:
        assert got[0].genotypes == [[1, 1], [0, 1]]


def test_population_caller_keeps_a_cpu_run_off_the_card(monkeypatch):
    """With the reduction gate at 0 every genotype reduction takes the
    device path: on the caller's device, the CPU here, never a card."""
    monkeypatch.setattr(genotype_likelihoods, "HOST_GATE", 0)
    seq, samples = private_variant()
    config = population.PopulationCallerConfig(device="cpu")
    config.likelihood.device = "cpu"
    genotype_likelihoods.COUNTS.reset()
    calls = population.PopulationCaller(
        ReferenceGenome(InMemoryReference({"chr1": seq})), "chr1",
        config).call(0, len(seq), [make_read_batch("chr1", r).sorted_by_begin()
                                   for r in samples])
    assert [c.begin for c in calls] == [300]
    assert genotype_likelihoods.COUNTS.device > 0
    assert genotype_likelihoods.COUNTS.host == 0


def em_top_k_tuples(em):
    marg = np.asarray([[0.7, 0.2, 0.1], [0.1, 0.8, 0.1], [0.5, 0.25, 0.25]])
    return em.select_top_k_tuples(marg, 4)


def em_top_k_genotypes(em):
    marg = np.asarray([[0.9, 0.05, 0.05], [0.8, 0.1, 0.1],
                       [0.1, 0.85, 0.05]])
    return em.select_top_k_genotypes(marg, 1)


def em_propose_combinations(em):
    rng = np.random.default_rng(0)
    marg = rng.dirichlet(np.ones(10), size=6)
    genotypes = np.stack([np.zeros(2, np.int64)] * 10)
    return em.propose_genotype_combinations(genotypes, marg, 50, hom_ref_idx=7)


def em_marginals(em):
    genotypes = np.asarray([[0, 0], [0, 1], [1, 1]])
    loglik = np.tile(np.asarray([-40.0, -2.0, -40.0]), (8, 1))
    return em.em_genotype_marginals(genotypes, loglik, 2)


EM_CASES = {f.__name__: f for f in (em_top_k_tuples, em_top_k_genotypes,
                                    em_propose_combinations, em_marginals)}


@pytest.mark.parametrize("case", sorted(EM_CASES))
def test_population_em_gives_the_reference_values(case):
    got, want = EM_CASES[case](population_em), EM_CASES[case](ref_em)
    assert np.asarray(got).shape == np.asarray(want).shape
    assert np.array_equal(got, want)
    if case == "em_top_k_tuples":
        assert list(got[0]) == [0, 1, 0]
    if case == "em_marginals":
        assert (got.argmax(axis=1) == 1).all()


CARRIERS = {0, 4, 9}


def cohort_calls(joint, cap):
    """Ten samples at depth 6, carriers 0, 4 and 9 of a variant at 300 that
    two in six of their reads show."""
    seq = reference_sequence(11)
    alt = other(seq[300])
    samples = [thin_reads(seq, {300: alt} if s in CARRIERS else {}, 6,
                          seed=100 + s, alt_every=3) for s in range(10)]
    ref_config = ref_population.PopulationCallerConfig(
        use_device=False, joint_model=joint, max_genotype_combinations=cap)
    return run_both(ref_population.PopulationCaller, ref_config,
                    population.PopulationCaller,
                    population.PopulationCallerConfig, seq, samples,
                    begin=250, end=350)


def called_carriers(calls):
    return {s for c in calls if c.begin == 300
            for s, gt in enumerate(c.genotypes) if any(a > 0 for a in gt)}


@pytest.mark.parametrize("joint,cap", [(True, 800), (False, 800), (True, 500)])
def test_ten_sample_cohort_gives_the_reference_calls(joint, cap):
    got, want = cohort_calls(joint, cap)
    assert_same_calls(got, want)
    if joint:
        # the joint prior pays for the shared variant once: every carrier
        # genotyped, nobody else, past the EM reduction of G^10 tuples
        assert called_carriers(got) == CARRIERS
        site = next(c for c in got if c.begin == 300)
        assert len(site.model_posteriors) == 10
    else:
        assert called_carriers(got) < CARRIERS
