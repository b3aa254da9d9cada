"""The port's germline path against the plain reference of the benchmark,
`benchmark/reference/germline.py` (PyTorch float64 on the CPU; it imports
neither JAX nor either package), on seeded random inputs at small sizes:

* genotype reductions: the float64 host path within 1e-9 relative, the
  float32 torch path within the reference's derived float32 bound, and the
  individual model's posteriors;
* read assignment's tie sets, and AD and ADP by octopus's rule for tied
  reads, on random likelihoods with ties forced by duplicated rows (1-6
  haplotypes, 0-300 reads, hom, het and multi-allelic sites);
* a hand-built block: a hom site whose het site lies further away than a
  read, so every read over the hom site ties; its depth counts them all,
  and the counter `ROUTING.tied_reads_credited` and the phase
  `allele_support` see them;
* end to end on the benchmark's germline input at 100 kb (seed
  3,000,000,011): the six hom sites there PASS with AD equal to the reads
  over them, and the JAX package, which counts no tied read, filters
  exactly those six and differs from the port nowhere else.
"""

import os
import sys
import types
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch

from octopus_tpu_torch.basics.reads import make_read_batch
from octopus_tpu_torch.basics.sequence import decode_sequence
from octopus_tpu_torch.core.csr.facets import FacetBlock, FacetBundle
from octopus_tpu_torch.core.likelihood import likelihood_array as la
from octopus_tpu_torch.core.models import genotype_likelihoods as gl
from octopus_tpu_torch.core.models.individual import IndividualModel
from octopus_tpu_torch.core.tools import read_assigner
from octopus_tpu_torch.core.types.variants import Variant
from octopus_tpu_torch.io.fasta import InMemoryReference, ReferenceGenome
from octopus_tpu_torch.utils import timers

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.reference import germline as ref  # noqa: E402

PINNED = ("OCTOPUS_TPU_HOST_HMM_MAX", "OCTOPUS_TPU_HOST_LATENTS")


def random_lnl(rng, H, R, ties=True):
    """(H, R) read log-likelihoods; with `ties`, some rows copy an earlier
    one (haplotypes no read tells apart) and some reads copy their best
    value to another haplotype."""
    lnL = -rng.gamma(2.0, 15.0, size=(H, R))
    if ties and H > 1:
        for h in range(1, H):
            if rng.random() < 0.4:
                lnL[h] = lnL[rng.integers(h)]
        for r in np.flatnonzero(rng.random(R) < 0.2):
            lnL[rng.integers(H), r] = lnL[:, r].max()
    return lnL


def mapping_mixed(rng, lnL):
    """lnL through the likelihood model's mapping-quality mixture, as the
    genotype models see it: each read mismapped with probability
    10^(-MQ/10), MQ 20-60, so every value lies within 0.23 MQ nats of 0
    and no float32 exp of a difference underflows."""
    ln_miss = -np.log(10) / 10 * rng.integers(20, 61, size=lnL.shape[1])
    return np.logaddexp(np.log1p(-np.exp(ln_miss)) + lnL, ln_miss)


# -- genotype reductions and the individual model ---------------------------

@pytest.mark.parametrize("seed", range(6))
def test_genotype_reductions_agree_with_the_reference(seed):
    rng = np.random.default_rng([seed, 19])
    H, R, P = int(rng.integers(1, 7)), int(rng.integers(1, 300)), 2
    lnL = mapping_mixed(rng, random_lnl(rng, H, R))
    genotypes = np.sort(rng.integers(0, H, size=(int(rng.integers(1, 30)), P)),
                        axis=1)
    want = ref.genotype_log_likelihoods(lnL, genotypes).numpy()
    host = gl.genotype_log_likelihoods(lnL, genotypes, use_device=False)
    np.testing.assert_allclose(host, want, rtol=1e-9, atol=0)
    counts = gl.genotype_counts_matrix(genotypes, H)
    f32 = gl.genotype_log_likelihoods_torch(
        torch.as_tensor(lnL, dtype=torch.float32),
        torch.as_tensor(counts), P).double().numpy()
    bound = ref.float32_bound(lnL, genotypes).numpy()
    assert (np.abs(f32 - want) <= bound).all(), np.abs(f32 - want) / bound
    # the float32 path is not the float64 one: the bound is not empty
    assert (np.abs(f32 - want) > 0).any() or R * H < 4


@pytest.mark.parametrize("seed", range(4))
def test_individual_posteriors_agree_with_the_reference(seed):
    rng = np.random.default_rng([seed, 23])
    H, R = int(rng.integers(2, 7)), int(rng.integers(1, 200))
    lnL = mapping_mixed(rng, random_lnl(rng, H, R))
    genotypes = np.asarray([(a, b) for a in range(H) for b in range(a, H)])
    log_priors = np.log(rng.dirichlet(np.ones(len(genotypes))))
    prior = types.SimpleNamespace(evaluate_many=lambda g: log_priors)
    latents = IndividualModel(prior, use_device=False).evaluate(genotypes, lnL)
    want = ref.posteriors(ref.genotype_log_likelihoods(lnL, genotypes),
                          log_priors).numpy()
    np.testing.assert_allclose(latents.posteriors, want, rtol=1e-9, atol=1e-300)
    assert latents.posteriors.sum() == pytest.approx(1.0, rel=1e-12)


# -- tie sets and allele depth ----------------------------------------------

class Reads:
    """The read facts a facet bundle reads: extents and flags."""

    def __init__(self, begins, ends):
        self.begins = np.asarray(begins, np.int64)
        self.ends = np.asarray(ends, np.int64)
        self.flags = np.where(np.arange(len(begins)) % 3 == 0, 0x10, 0)

    def __len__(self):
        return len(self.begins)

    def lengths(self):
        return self.ends - self.begins


SITE = Variant(500, 501, b"\x00", b"\x02")
OTHER = Variant(500, 501, b"\x00", b"\x03")        # another alt of the site


def bundle_of(reads, haps, assignment):
    """A facet bundle of one sample whose facets are given."""
    b = FacetBundle(FacetBlock(contig="chr1", begin=500, end=501,
                               variants=[SITE], genotypes=[[[1, 1]]],
                               reads_by_sample=[reads], samples=["S"],
                               reference=None))
    b.__dict__.update(overlapping_reads=[reads], read_assignments=[assignment],
                      called_haplotypes_by_sample=[haps])
    return b


@pytest.mark.parametrize("seed", range(40))
def test_tie_sets_and_allele_depths_agree_with_the_reference(seed):
    rng = np.random.default_rng([seed, 29])
    H, R = 1 + seed % 6, int(rng.integers(0, 301))
    lnL = random_lnl(rng, H, R)
    # the site on each haplotype: this alt, the reference or another alt;
    # hom (every haplotype this alt) on every fourth seed
    kinds = (np.zeros(H, int) if seed % 4 == 0
             else rng.choice(3, size=H, p=[0.45, 0.45, 0.1]))
    haps = [types.SimpleNamespace(variants=[{0: SITE, 2: OTHER}[k]] if k != 1
                                  else []) for k in kinds]
    begins = rng.integers(300, 560, size=R)
    reads = Reads(begins, begins + 150)
    a = read_assigner._assignment_from_matrix(lnL, list(range(H)))
    np.testing.assert_array_equal(a.ties, ref.tie_sets(lnL).numpy())
    assert ((a.hap_of_read < 0) == (a.ties.sum(axis=0) > 1)).all()
    la.ROUTING.reset()
    (ad, adp), = bundle_of(reads, haps, a).allele_support_context(SITE)
    over = (reads.begins < 501) & (reads.ends > 500)
    want = ref.allele_depths(lnL, kinds == 0, kinds == 1, over)
    assert (ad, adp, la.ROUTING.tied_reads_credited) == want
    support, = bundle_of(reads, haps, a).allele_assignment_support(SITE)
    ties = ref.tie_sets(lnL).numpy()
    for key, side in (("alt", kinds == 0), ("ref", kinds == 1)):
        want_reads = [r for r in range(R)
                      if ties[:, r].any() and side[ties[:, r]].all()]
        assert [i for _, i in support[key].reads] == want_reads
    assert support["n_overlapping"] == int(over.sum())
    assert support["n_ambiguous"] == int((over & (ties.sum(axis=0) > 1)).sum())


def test_hom_site_ties_every_read():
    """Every haplotype carries a hom site, so a read that scores the same
    on all of them supports it, and so does every read assigned."""
    rng = np.random.default_rng(31)
    lnL = np.repeat(-rng.gamma(2.0, 15.0, size=(1, 50)), 2, axis=0)
    haps = [types.SimpleNamespace(variants=[SITE])] * 2
    reads = Reads(np.full(50, 420), np.full(50, 570))
    a = read_assigner._assignment_from_matrix(lnL, [0, 1])
    assert (a.hap_of_read == -1).all()
    la.ROUTING.reset()
    assert bundle_of(reads, haps, a).allele_support_context(SITE) == [(50, 50)]
    assert la.ROUTING.tied_reads_credited == 50


# -- a hand-built block: a hom site, its het site beyond a read --------------

HOM, HET = 600, 1300            # 700 bp apart, reads of 150


def tied_block():
    """A 2 kb contig with a hom SNV at 600 and a het SNV at 1,300, a read of
    150 bp every 10 bp from each haplotype in turn, no errors; the block's
    facet bundle, its read assignment not yet run."""
    rng = np.random.default_rng(37)
    codes = rng.integers(0, 4, size=2000).astype(np.uint8)
    seq = decode_sequence(codes)
    hom = Variant.make(HOM, codes[HOM:HOM + 1], np.uint8([(codes[HOM] + 1) % 4]))
    het = Variant.make(HET, codes[HET:HET + 1], np.uint8([(codes[HET] + 2) % 4]))
    haps = [bytearray(seq.encode()), bytearray(seq.encode())]
    for h in haps:
        h[HOM] = ord(decode_sequence(hom.alt_codes))
    haps[1][HET] = ord(decode_sequence(het.alt_codes))
    reads = [(b, "150M", haps[(b // 10) % 2][b:b + 150].decode(), [30] * 150,
              60, 0x10 if (b // 10) % 3 == 0 else 0)
             for b in range(0, 1850, 10)]
    batch = make_read_batch("chr1", reads)
    reference = ReferenceGenome(InMemoryReference({"chr1": seq}))
    block = FacetBlock(contig="chr1", begin=HOM, end=HET + 1,
                       variants=[hom, het], genotypes=[[[1, 1], [0, 1]]],
                       reads_by_sample=[batch], samples=["S"],
                       reference=reference,
                       scoring=la.LikelihoodConfig(device="cpu"))
    return FacetBundle(block), hom, het, batch


@contextmanager
def kept_matrices():
    """The likelihood matrix of each read assignment, by the id of its
    Assignment."""
    kept = {}
    real = read_assigner._assignment_from_matrix

    def keep(lnL, unique_haps, margin=1e-9):
        a = real(lnL, unique_haps, margin)
        kept[id(a)] = np.array(lnL)
        return a

    mp = pytest.MonkeyPatch()
    mp.setattr(read_assigner, "_assignment_from_matrix", keep)
    try:
        yield kept
    finally:
        mp.undo()


def test_hom_site_beyond_a_read_of_its_het_site_counts_every_read():
    bundle, hom, het, batch = tied_block()
    with kept_matrices() as kept:
        la.ROUTING.reset()
        (ad, adp), = bundle.allele_support_context(hom)
    a, = bundle.read_assignments
    lnL = kept[id(a)]
    haps, = bundle.called_haplotypes_by_sample
    over = (bundle.overlapping_reads[0].begins < HOM + 1) & \
        (bundle.overlapping_reads[0].ends > HOM)
    n_over = int(((batch.begins <= HOM) & (batch.ends > HOM)).sum())
    assert ad == adp == n_over == int(over.sum()) == 15
    # every read over the hom site ties, as no read reaches the het site
    assert (a.hap_of_read[over] == -1).all()
    alt = np.asarray([any(v.begin == HOM for v in h.variants) for h in haps])
    assert ref.allele_depths(lnL, alt, ~alt, over) == \
        (ad, adp, la.ROUTING.tied_reads_credited)
    assert la.ROUTING.tied_reads_credited == n_over
    # the het site: reads over it are assigned, half to each haplotype
    (ad_het, adp_het), = bundle.allele_support_context(het)
    assert 0 < ad_het < adp_het


# -- tracing ---------------------------------------------------------------

def test_routing_reset_clears_the_tied_read_counter():
    routing = la.RoutingCounts()
    routing.record_tied_credits(4)
    routing.record_tied_credits(3)
    routing.record_shortcuts(2)
    assert routing.tied_reads_credited == 7 and routing.shortcut_pairs == 2
    routing.reset()
    assert routing.tied_reads_credited == 0


@pytest.fixture
def recorder():
    """The phase recorder on and empty; its flags restored after."""
    saved = timers.enabled, timers.annotate
    timers.reset()
    timers.enabled, timers.annotate = True, False
    yield timers
    timers.enabled, timers.annotate = saved
    timers.reset()


def test_allele_support_encloses_no_read_assignment(recorder):
    """The block's read assignment runs lazily inside the first count, and
    still outside its phase: the phase's self time is all of its time, so
    no phase (populate's included) opened inside it."""
    bundle, hom, het, _ = tied_block()
    bundle.allele_support_context(hom)
    bundle.allele_assignment_support(het)
    counts = timers.counts()
    assert counts["allele_support"] == 2 and counts["populate_jobs"] > 0
    assert timers.self_totals()["allele_support"] == \
        timers.totals()["allele_support"]
    assert timers.totals()["populate_jobs"] > 0


# -- end to end on the benchmark's germline input ----------------------------

HOM_SITES = [7769, 8673, 15601, 29586, 43017, 58629]   # VCF POS


@pytest.fixture(scope="module")
def germline_100kb(tmp_path_factory):
    """The benchmark's germline input cut to 100 kb, and the records of the
    port and of the JAX package (without the rule), AD and ADP annotated."""
    import json

    from benchmark import bamfile, simulate
    from octopus_tpu import cli as ref_cli
    from octopus_tpu_torch import cli

    d = tmp_path_factory.mktemp("germline")
    config = json.loads((ROOT / "benchmark" / "configs" /
                         "germline-illumina35x.json").read_text())
    traffic = {**json.loads((ROOT / "benchmark" / "traffic" /
                             "wgs.json").read_text()), "contig_kb": 100}
    inputs = simulate.simulate(config, traffic, 3_000_000_011)
    fa, bam = str(d / "ref.fa"), str(d / "HG002.bam")
    bamfile.write_fasta(fa, "chr1", inputs.reference)
    sample, = inputs.samples
    bamfile.write_bam(bam, "chr1", len(inputs.reference), sample,
                      inputs.base_qual, inputs.mapq)
    argv = ["-R", fa, "-I", bam, "--annotations", "AD", "ADP"]
    saved = {k: os.environ.get(k) for k in PINNED}
    try:
        assert ref_cli.main([*argv, "-o", str(d / "jax.vcf")]) == 0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    with pytest.MonkeyPatch.context() as mp:
        for k in PINNED:
            mp.delenv(k, raising=False)
        assert cli.main([*argv, "-o", str(d / "port.vcf"), "--device",
                         "cpu"]) == 0
    return d, inputs, bam


def records(path):
    return [line.split("\t") for line in Path(path).read_text().splitlines()
            if not line.startswith("#")]


def info(fields):
    return dict(kv.split("=", 1) for kv in fields[7].split(";") if "=" in kv)


def test_hom_sites_pass_with_every_read_over_them(germline_100kb):
    from octopus_tpu_torch.io.bam import BamFile
    d, inputs, bam = germline_100kb
    by_pos = {int(r[1]): r for r in records(d / "port.vcf")}
    reads, = BamFile(bam).fetch("chr1", 0, len(inputs.reference)).values()
    truth = {s.pos + 1: s for s in inputs.sites}
    for pos in HOM_SITES:
        r = by_pos[pos]
        assert r[6] == "PASS", r
        assert r[9].startswith("1|1") and len(truth[pos].members) == 2
        # the allele without its anchor base where an indel has one
        anchor = int(len(r[3]) != len(r[4]))
        begin = pos - 1 + anchor
        end = begin + max(len(r[3]) - anchor, 1)
        n_over = int(((reads.begins < end) & (reads.ends > begin)).sum())
        assert int(info(r)["AD"]) == int(info(r)["ADP"]) == n_over > 15, r


def test_jax_package_filters_exactly_the_hom_sites(germline_100kb):
    """The witness: the JAX package, which counts no tied read, filters the
    six hom sites with AD 0, and its records equal the port's elsewhere."""
    d, _, _ = germline_100kb
    port, jax = records(d / "port.vcf"), records(d / "jax.vcf")
    assert [r[:2] for r in port] == [r[:2] for r in jax] and len(port) > 100
    differ = [int(p[1]) for p, j in zip(port, jax) if p != j]
    assert differ == HOM_SITES
    for p, j in zip(port, jax):
        if int(p[1]) in HOM_SITES:
            assert p[6] == "PASS" and "AD1" in j[6].split(";"), (p, j)
            assert info(j)["AD"] == "0"
            strip = lambda r: [*r[:6], {k: v for k, v in info(r).items()
                                        if k not in ("AD", "ADP")}, *r[8:]]
            assert strip(p) == strip(j)
