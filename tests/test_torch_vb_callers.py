"""The port's cancer, polyclone and cell callers against the reference's, on
in-memory reads (as tests/test_cancer_polyclone.py and
tests/test_cell_caller.py build them), on the CPU.

Each case's reads go through both packages' callers with one config (the
reference's, carried over by convert.caller_config_from_reference); the
SiteCalls must agree in positions, alleles, genotypes, the SOMATIC, CLONES
and CELLS annotations, and qualities (QUAL, GQ, PP, MP, PPP) to 2 decimals.
A quality built on VB evidences carries their float32 rounding (a few ulps
of an ELBO of a few hundred nats, ~1e-3 phred), which can move its second
decimal by one: qualities may differ by 0.01 after rounding, nothing more.
"""

import dataclasses

import numpy as np
import pytest

from octopus_tpu.basics.reads import make_read_batch as ref_make_read_batch
from octopus_tpu.core.callers import cancer as ref_cancer
from octopus_tpu.core.callers import cell as ref_cell
from octopus_tpu.core.callers import polyclone as ref_polyclone
from octopus_tpu.io.fasta import InMemoryReference as RefInMemory
from octopus_tpu.io.fasta import ReferenceGenome as RefGenome
from octopus_tpu_torch.basics.reads import FLAG_REVERSE, make_read_batch
from octopus_tpu_torch.convert import caller_config_from_reference
from octopus_tpu_torch.core.callers import cancer, cell, polyclone
from octopus_tpu_torch.core.models import subclone_vb
from octopus_tpu_torch.io.fasta import InMemoryReference, ReferenceGenome

CALLERS = {
    "cancer": (ref_cancer.CancerCaller, ref_cancer.CancerCallerConfig,
               cancer.CancerCaller, cancer.CancerCallerConfig),
    "polyclone": (ref_polyclone.PolycloneCaller,
                  ref_polyclone.PolycloneCallerConfig,
                  polyclone.PolycloneCaller, polyclone.PolycloneCallerConfig),
    "cell": (ref_cell.CellCaller, ref_cell.CellCallerConfig,
             cell.CellCaller, cell.CellCallerConfig),
}


def reference_sequence(seed, n=600):
    rng = np.random.default_rng(seed)
    return "".join("ACGT"[c] for c in rng.integers(0, 4, n))


def other(c):
    return "T" if c != "T" else "A"


def mixed_reads(seq, muts_and_fracs, n_reads=150, read_len=90, seed=1):
    """Read tuples from weighted haplotypes: [(muts_dict, fraction), ...]
    (tests/test_cancer_polyclone.py mixed_reads)."""
    rng = np.random.default_rng(seed)
    haps, fracs = [], []
    for muts, f in muts_and_fracs:
        s = list(seq)
        for pos, alt in muts.items():
            s[pos] = alt
        haps.append("".join(s))
        fracs.append(f)
    fracs = np.asarray(fracs) / sum(fracs)
    reads = []
    for i in range(n_reads):
        hap = haps[rng.choice(len(haps), p=fracs)]
        begin = int(rng.integers(0, len(hap) - read_len))
        reads.append((begin, f"{read_len}M", hap[begin:begin + read_len],
                      [37] * read_len, 60, FLAG_REVERSE if i % 3 == 0 else 0))
    return reads


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


def germline_het_with_normal():
    seq = reference_sequence(40)
    alt = other(seq[300])
    samples = [diploid_reads(seq, ({300: alt}, {}), seed=41),
               diploid_reads(seq, ({300: alt}, {}), seed=42)]
    return seq, samples, "cancer", {"normal_sample": 1}, {}


def somatic_with_normal():
    seq = reference_sequence(50)
    alt = other(seq[300])
    samples = [mixed_reads(seq, [({300: alt}, 0.2), ({}, 0.8)], seed=51,
                           n_reads=300),
               diploid_reads(seq, ({}, {}), seed=52, n_reads=150)]
    return (seq, samples, "cancer", {"normal_sample": 1},
            {"inclusion": "somatic", "normal_sample": 1})


def somatic_tumour_only():
    seq, samples, *_ = somatic_with_normal()
    return seq, samples[:1], "cancer", {}, {"inclusion": "somatic"}


def two_clones():
    seq = reference_sequence(60)
    samples = [mixed_reads(seq, [({200: other(seq[200])}, 0.6),
                                 ({400: other(seq[400])}, 0.4)],
                           seed=61, n_reads=250)]
    return seq, samples, "polyclone", {}, {}


def one_clone():
    seq = reference_sequence(70)
    samples = [mixed_reads(seq, [({250: other(seq[250])}, 1.0)], seed=71,
                           n_reads=100)]
    return seq, samples, "polyclone", {}, {}


def somatic_in_two_of_four_cells():
    """Phylogenies of up to three clones over four cells, two of which carry
    a het somatic variant (tests/test_cell_caller.py)."""
    seq = reference_sequence(80)
    alt = other(seq[300])
    samples = [diploid_reads(seq, ({300: alt}, {}), seed=81, n_reads=60),
               diploid_reads(seq, ({300: alt}, {}), seed=82, n_reads=60),
               diploid_reads(seq, ({}, {}), seed=83, n_reads=60),
               diploid_reads(seq, ({}, {}), seed=84, n_reads=60)]
    return seq, samples, "cell", {}, {"inclusion": "cell"}


def germline_het_in_three_cells():
    seq = reference_sequence(90)
    alt = other(seq[250])
    samples = [diploid_reads(seq, ({250: alt}, {}), seed=91 + i, n_reads=60)
               for i in range(3)]
    return seq, samples, "cell", {}, {"inclusion": "cell"}


CASES = {f.__name__: f for f in (
    germline_het_with_normal, somatic_with_normal, somatic_tumour_only,
    two_clones, one_clone, somatic_in_two_of_four_cells,
    germline_het_in_three_cells)}
INFO_KEYS = ("SOMATIC", "CLONES", "CELLS")
QUALITY_KEYS = ("PP", "MP", "PPP")


def summary(calls):
    """(the fields that must be equal, the qualities to 2 decimals) a call."""
    out = []
    for c in calls:
        exact = (c.begin, c.end,
                 [(v.begin, v.end, bytes(v.ref), bytes(v.alt))
                  for v in c.alts],
                 [list(map(int, g)) for g in c.genotypes],
                 {k: c.info[k] for k in INFO_KEYS if k in c.info},
                 sorted(k for k in QUALITY_KEYS if k in c.info))
        qualities = ([c.quality] + list(c.genotype_qualities)
                     + list(c.alt_qualities)
                     + [c.info[k] for k in QUALITY_KEYS if k in c.info])
        out.append((exact, np.round(np.asarray(qualities, float), 2)))
    return out


def assert_same_calls(got, want):
    got, want = summary(got), summary(want)
    assert [g for g, _ in got] == [w for w, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.shape == w.shape
        assert np.all((g == w) | (np.abs(g - w) <= 0.01 + 1e-9)), (g, w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_caller_gives_the_reference_calls(case):
    seq, samples, kind, extra, scanner = CASES[case]()
    RefCaller, RefConfig, Caller, Config = CALLERS[kind]
    ref_config = RefConfig(use_device=False, **extra)
    for k, v in scanner.items():
        setattr(ref_config.scanner, k, v)
    config = caller_config_from_reference(dataclasses.asdict(ref_config),
                                          device="cpu", config_class=Config)
    assert type(config) is Config
    assert dataclasses.asdict(config)["scanner"] == dataclasses.asdict(
        ref_config)["scanner"]
    ref = RefGenome(RefInMemory({"chr1": seq}))
    want = RefCaller(ref, "chr1", ref_config).call(
        0, len(seq), [ref_make_read_batch("chr1", r).sorted_by_begin()
                      for r in samples])
    port_ref = ReferenceGenome(InMemoryReference({"chr1": seq}))
    subclone_vb.COUNTS.reset()
    got = Caller(port_ref, "chr1", config).call(
        0, len(seq), [make_read_batch("chr1", r).sorted_by_begin()
                      for r in samples])
    assert_same_calls(got, want)
    assert got, "no calls"
    assert subclone_vb.COUNTS.host > 0 and subclone_vb.COUNTS.device == 0
    if case == "somatic_with_normal":
        assert [c.begin for c in got if c.info.get("SOMATIC")] == [300]
    if case == "two_clones":
        assert {c.begin for c in got} == {200, 400}
    if case == "somatic_in_two_of_four_cells":
        assert got[0].info.get("SOMATIC") is True
        assert got[0].info.get("CELLS") == 2
