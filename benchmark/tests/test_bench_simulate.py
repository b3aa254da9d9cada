"""The generator and the BAM writer: one seed, one set of inputs; the same
variation and the same reads for every seed, on another sequence (reads
from the seed where the traffic asks for them); files the port reads back
as written."""

import os

import numpy as np
import pytest

from benchmark import bamfile, cell, simulate

SPEC = cell.load_spec()
SMALL = {"contig_kb": 30, "shard_kb": 10}


def inputs(workload, seed, **traffic_keys):
    _, config, traffic = cell.load_cell(SPEC, workload)
    return simulate.simulate(config, {**traffic, **SMALL, **traffic_keys}, seed)


def same(a, b):
    assert np.array_equal(a.reference, b.reference)
    assert [(s.pos, s.kind, s.members, s.somatic) for s in a.sites] == \
        [(s.pos, s.kind, s.members, s.somatic) for s in b.sites]
    for x, y in zip(a.samples, b.samples):
        assert np.array_equal(x.begins, y.begins)
        assert np.array_equal(x.seq, y.seq)
        assert np.array_equal(x.flags, y.flags)
        assert x.cigars == y.cigars


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_same_seed_same_inputs(workload):
    seed = 2**31 + 99
    same(inputs(workload, seed), inputs(workload, seed))
    other = inputs(workload, seed + 1)
    assert not np.array_equal(other.reference, inputs(workload, seed).reference)


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_seed_the_same_variation(workload):
    a, b = inputs(workload, 11), inputs(workload, 12)
    kinds = lambda x: sorted((s.kind, s.zygosity, s.somatic,
                              s.alt if s.kind == "del" else
                              len(s.alt) if s.kind == "ins" else 0)
                             for s in x.sites)
    assert kinds(a) == kinds(b)
    # the same reads at the same places, with their errors at the same
    # bases, on another sequence
    cols = np.arange(a.read_len)
    for x, y in zip(a.samples, b.samples):
        assert np.array_equal(x.begins, y.begins) and x.cigars == y.cigars
        assert np.array_equal(x.flags, y.flags)
        simple = np.asarray([k not in x.cigars for k in range(len(x.begins))])
        at = x.begins[simple, None] + cols
        assert np.array_equal(x.seq[simple] != a.reference[at],
                              y.seq[simple] != b.reference[at])
        assert not np.array_equal(x.seq, y.seq)


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_reads_from_seed(workload):
    """`reads_from_seed` draws the reads from the seed: the same seed gives
    the same reads, another seed other reads, on the same variation."""
    seed = 2**31 + 41
    a = inputs(workload, seed, reads_from_seed=True)
    same(a, inputs(workload, seed, reads_from_seed=True))
    b = inputs(workload, seed + 1, reads_from_seed=True)
    fixed = inputs(workload, seed)
    assert [(s.pos, s.kind) for s in a.sites] == [(s.pos, s.kind) for s in b.sites]
    for x, y, z in zip(a.samples, b.samples, fixed.samples):
        assert not np.array_equal(x.begins, y.begins)
        assert not np.array_equal(x.begins, z.begins)


def test_depth_and_clone():
    x = inputs("somatic-t60n30.subclonal", 5)
    normal, tumour = x.samples
    assert normal.name == "NORMAL" and tumour.name == "TUMOUR"
    n = SMALL["contig_kb"] * 1000
    assert len(normal.begins) == pytest.approx(n * 30 / 150, rel=0.01)
    assert len(tumour.begins) == pytest.approx(n * 60 / 150, rel=0.01)
    assert sum(s.somatic for s in x.sites) == round(14 * n / 100_000)


def test_bam_reads_back(tmp_path):
    from octopus_tpu_torch.io.bam import BamFile
    from octopus_tpu_torch.io.fasta import IndexedFasta
    x = inputs("somatic-t60n30.subclonal", 2**31 + 5)
    fa = os.path.join(tmp_path, "ref.fa")
    bamfile.write_fasta(fa, "chr1", x.reference)
    fasta = IndexedFasta(fa)
    assert np.array_equal(np.asarray(fasta.fetch("chr1", 0, len(x.reference))),
                          x.reference)
    # 7 kb around the first indel, so that reads with their own CIGAR are
    # among those read back
    indel = next(site.pos for site in x.sites if site.kind != "snv")
    lo, hi = max(indel - 3_000, 0), indel + 4_000
    for s in x.samples:
        path = os.path.join(tmp_path, f"{s.name}.bam")
        bamfile.write_bam(path, "chr1", len(x.reference), s, x.base_qual, x.mapq)
        got = BamFile(path).fetch("chr1", lo, hi)[s.name]
        sel = np.flatnonzero((s.ends > lo) & (s.begins < hi))
        read = sorted((int(got.begins[i]), got.sequence(i).tobytes(),
                       int(got.flags[i]), int(got.ends[i]),
                       got.cigar(i).tobytes()) for i in range(len(got.begins)))
        want = sorted((int(s.begins[k]), s.seq[k].tobytes(), int(s.flags[k]),
                       int(s.ends[k]),
                       np.asarray([[length, op] for length, op in
                                   s.cigars.get(k, [(x.read_len, 0)])],
                                  got.cigar(0).dtype).tobytes())
                      for k in sel)
        assert read == want
        assert any(k in s.cigars for k in sel)      # indel reads among them
