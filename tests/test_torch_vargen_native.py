"""The port's candidate generation against the reference's.

`VariantGenerator.generate` of the port makes one call of the host
extension a window (`generate_candidates`: the CIGAR scan, its grouping,
depths and inclusion, and the reassembler), then merges the repeat
scanner's proposals. The oracle is the reference package's
`VariantGenerator` on the same reads: both must give the same candidate
list, (begin, end, ref, alt) in the same order, since every later step
(active regions, haplotypes, records) reads it as it comes.

Each case is a seeded simulated window: a random reference, two
haplotypes with SNVs, insertions and deletions, and reads with
substitution errors, low base qualities (masked by the assembler, below
the scanner's thresholds), soft clips, low mapping qualities (the
misalignment filter) and both strands.
"""

import numpy as np
import pytest

from octopus_tpu.basics.reads import make_read_batch as ref_make_batch
from octopus_tpu.core.vargen import generator as ref_generator
from octopus_tpu.core.vargen.assembler import AssemblerOptions as RefAssemblerOptions
from octopus_tpu.core.vargen.cigar_scanner import ScannerOptions as RefScannerOptions
from octopus_tpu.io.fasta import InMemoryReference as RefInMemory
from octopus_tpu.io.fasta import ReferenceGenome as RefGenome
from octopus_tpu_torch import _build
from octopus_tpu_torch.basics.reads import make_read_batch
from octopus_tpu_torch.core.vargen import generator
from octopus_tpu_torch.core.vargen.assembler import AssemblerOptions
from octopus_tpu_torch.core.vargen.cigar_scanner import ScannerOptions
from octopus_tpu_torch.io.fasta import InMemoryReference, ReferenceGenome

CONTIG = "chr1"
ACGTN = "ACGTN"


@pytest.fixture(autouse=True)
def native():
    return _build.require_native()


def haplotype(ref: np.ndarray, sites: list) -> tuple[np.ndarray, np.ndarray]:
    """Bases and their reference coordinates (-1: inserted) of the
    reference with `sites`, (pos, kind, arg) sorted by pos: ("snv", base),
    ("del", size), ("ins", bases)."""
    bases, coords = [], []
    pos = 0
    for p, kind, arg in sites:
        if p < pos:
            continue
        bases.append(ref[pos:p])
        coords.append(np.arange(pos, p))
        if kind == "snv":
            bases.append(np.array([arg], np.uint8))
            coords.append(np.array([p]))
            pos = p + 1
        elif kind == "del":
            pos = p + arg
        else:
            bases.append(ref[p:p + 1])
            coords.append(np.array([p]))
            bases.append(np.asarray(arg, np.uint8))
            coords.append(np.full(len(arg), -1))
            pos = p + 1
    bases.append(ref[pos:])
    coords.append(np.arange(pos, len(ref)))
    return np.concatenate(bases).astype(np.uint8), np.concatenate(coords)


def draw_sites(rng, ref, lo, hi, spacing, indel_fraction=0.3, max_indel=8):
    sites = []
    p = lo + int(rng.integers(*spacing))
    while p < hi:
        r = rng.random()
        if r < 1 - indel_fraction:
            sites.append((p, "snv", (int(ref[p]) + int(rng.integers(1, 4))) % 4))
        elif r < 1 - indel_fraction / 2:
            sites.append((p, "del", int(rng.integers(1, max_indel + 1))))
        else:
            sites.append((p, "ins", rng.integers(0, 4, int(rng.integers(1, max_indel + 1)))))
        p += int(rng.integers(*spacing))
    return sites


def cigar_of(coords: np.ndarray):
    """(reference begin, CIGAR text) of bases at reference `coords` (-1
    inserted): leading and trailing inserted bases soft-clipped."""
    aligned = np.flatnonzero(coords >= 0)
    if not len(aligned):
        return None
    ops = []

    def push(n, op):
        if ops and ops[-1][1] == op:
            ops[-1][0] += n
        else:
            ops.append([n, op])

    first, last_i = int(aligned[0]), int(aligned[-1])
    if first:
        push(first, "S")
    last = None
    for c in coords[first:last_i + 1]:
        c = int(c)
        if c < 0:
            push(1, "I")
            continue
        if last is not None and c > last + 1:
            push(c - last - 1, "D")
        push(1, "M")
        last = c
    if last_i + 1 < len(coords):
        push(len(coords) - last_i - 1, "S")
    return int(coords[first]), "".join(f"{n}{op}" for n, op in ops)


def sample_reads(rng, haps, n_ref, depth, length=(150, 150), err=0.001,
                 indel_err=0.0, forward_at=(), masked=0.03):
    """Read tuples (begin, cigar, seq, quals, mapq, flags) in begin order.
    A read over a position of `forward_at` is on the forward strand; a
    share `masked` of bases has a quality below the assembler's mask."""
    mean_len = sum(length) / 2
    reads = []
    for i in range(int(n_ref * depth / mean_len)):
        bases, coords = haps[i % len(haps)]
        n = int(rng.integers(length[0], length[1] + 1))
        if len(bases) <= n:
            continue
        b = int(rng.integers(0, len(bases) - n))
        seq, co = bases[b:b + n].copy(), coords[b:b + n].copy()
        if indel_err:
            keep = rng.random(n) >= indel_err                   # deletions
            seq, co = seq[keep], co[keep]
            ins = np.flatnonzero(rng.random(len(seq)) < indel_err)
            seq = np.insert(seq, ins, rng.integers(0, 4, len(ins)).astype(np.uint8))
            co = np.insert(co, ins, -1)
        errors = rng.random(len(seq)) < err
        seq[errors] = (seq[errors] + rng.integers(1, 4, int(errors.sum()))) % 4
        if rng.random() < 0.05:                                 # clipped adapter
            c = int(rng.integers(2, 12))
            seq[:c] = rng.integers(0, 4, c)
            co[:c] = -1
        got = cigar_of(co)
        if got is None:
            continue
        begin, cigar = got
        quals = rng.integers(25, 41, len(seq))
        low = rng.random(len(seq))
        quals[low < masked] = rng.integers(2, 10, int((low < masked).sum()))
        quals[(low >= masked) & (low < masked + 0.03)] = 15
        mapq = 60 if rng.random() < 0.95 else int(rng.integers(0, 30))
        span = co[co >= 0]
        forward = any(span.min() <= p <= span.max() for p in forward_at)
        flags = 0 if forward or rng.random() < 0.5 else 16
        reads.append((begin, cigar, "".join(ACGTN[c] for c in seq),
                      [int(q) for q in quals], mapq, flags))
    reads.sort(key=lambda r: r[0])
    return reads


def germline35x(rng):
    n = 24_000
    ref = rng.integers(0, 4, n).astype(np.uint8)
    ref[9_000:9_006] = 4                          # an N run: (k-1)-mers keyed by bytes
    ref[12_000:12_024] = [0, 1] * 12              # (AC)12 for the repeat scanner
    sites = [s for s in draw_sites(rng, ref, 1_000, n - 1_000, (150, 700))
             if not 11_900 < s[0] < 12_100] + [(12_010, "del", 2), (12_014, "ins", [0, 1])]
    sites.sort(key=lambda s: s[0])
    biased = [s for s in sites if s[1] == "snv"][3]
    haps = [haplotype(ref, sites), haplotype(ref, [s for s in sites if s[0] % 2 or s == biased])]
    reads = sample_reads(rng, haps, n, 35, forward_at=(biased[0],))
    # a dip to ~5x: the predicates' low-depth rules
    reads = [r for r in reads if not 14_000 <= r[0] < 17_000 or rng.random() < 0.15]
    return ref, [reads], (4_000, 20_000), {}, {}


def somatic_t60n30(rng):
    n = 20_000
    ref = rng.integers(0, 4, n).astype(np.uint8)
    sites = draw_sites(rng, ref, 1_000, n - 1_000, (400, 1_500))
    normal = [haplotype(ref, sites), haplotype(ref, [s for s in sites if s[0] % 3])]
    somatic = sorted(sites + draw_sites(rng, ref, 1_200, n - 1_200, (600, 900), 0.2))
    clone = [haplotype(ref, somatic), normal[1]]
    tumour = (sample_reads(rng, normal, n, 30) + sample_reads(rng, clone, n, 30))
    tumour.sort(key=lambda r: r[0])
    return (ref, [sample_reads(rng, normal, n, 30), tumour], (3_000, 17_000),
            dict(inclusion="somatic", normal_sample=0), {})


def cell(rng):
    n = 16_000
    ref = rng.integers(0, 4, n).astype(np.uint8)
    sites = draw_sites(rng, ref, 1_000, n - 1_000, (300, 900))
    haps = [haplotype(ref, sites), haplotype(ref, [s for s in sites if s[0] % 2])]
    return (ref, [sample_reads(rng, haps, n, 15) for _ in range(3)], (2_000, 14_000),
            dict(inclusion="cell"), {})


def threshold(rng):
    ref, reads, region, _, _ = germline35x(rng)
    return ref, reads, region, dict(inclusion="threshold", min_observations=3), {}


def pacbio_long(rng):
    n = 40_000
    ref = rng.integers(0, 4, n).astype(np.uint8)
    sites = draw_sites(rng, ref, 2_000, n - 2_000, (250, 1_000), 0.4, 40)
    haps = [haplotype(ref, sites), haplotype(ref, [s for s in sites if s[0] % 2])]
    reads = sample_reads(rng, haps, n, 12, length=(5_000, 15_000), err=0.001,
                         indel_err=0.0005)
    return ref, [reads], (15_000, 25_000), dict(inclusion="pacbio"), {}


def assembler_off(rng):
    ref, reads, region, _, _ = germline35x(rng)
    return ref, reads, region, {}, None


def fallback_k(rng):
    """Units of 35 and 100 bases repeated every 300: the default k-mer
    sizes and the first fallbacks see repeated (k-1)-mers in every bin, so
    bins climb the ladder to k = 40 and to k = 110, past k = 33 (two and
    four 64-bit words a key). Few bases are masked, so that reads hold
    110-mers, and the pileup scanner is off: the reassembler's candidates
    alone."""
    n = 12_000
    ref = rng.integers(0, 4, n).astype(np.uint8)
    for lo, hi, size in ((1_200, 5_000, 35), (6_000, 10_800, 100)):
        for at in range(lo + 300, hi, 300):       # two copies in every bin
            ref[at:at + size] = ref[lo:lo + size]
    sites = draw_sites(rng, ref, 1_000, n - 1_000, (120, 400))
    haps = [haplotype(ref, sites), haplotype(ref, [s for s in sites if s[0] % 2])]
    return (ref, [sample_reads(rng, haps, n, 35, masked=0.0005)], (1_200, 10_800),
            {}, {}, dict(use_pileup_scanner=False))


def diverged(rng):
    """Reads 5% diverged from the reference everywhere (a wrong build):
    most are mismatch-dense, so the reassembler's clustered trigger stands
    down and the indel and clip triggers alone pick bins."""
    n = 6_000
    ref = rng.integers(0, 4, n).astype(np.uint8)
    sites = draw_sites(rng, ref, 500, n - 500, (200, 600))
    haps = [haplotype(ref, sites), haplotype(ref, [s for s in sites if s[0] % 2])]
    return ref, [sample_reads(rng, haps, n, 30, err=0.05)], (1_000, 5_000), {}, {}


CASES = {"germline35x": germline35x, "somatic_t60n30": somatic_t60n30,
         "cell": cell, "threshold": threshold, "pacbio_long": pacbio_long,
         "assembler_off": assembler_off, "fallback_k": fallback_k,
         "diverged": diverged}


def candidates(pkg, ref, samples, region, scanner, assembler, extra=None):
    """The candidate list (begin, end, ref, alt) of one package; `extra`
    holds more of VariantGeneratorConfig's fields."""
    if pkg == "port":
        reference = ReferenceGenome(InMemoryReference({CONTIG: ref}))
        make, mod = make_read_batch, generator
        so, ao = ScannerOptions(**scanner), AssemblerOptions(**(assembler or {}))
    else:
        reference = RefGenome(RefInMemory({CONTIG: ref}))
        make, mod = ref_make_batch, ref_generator
        so, ao = RefScannerOptions(**scanner), RefAssemblerOptions(**(assembler or {}))
    vg = mod.VariantGenerator(reference, CONTIG, mod.VariantGeneratorConfig(
        scanner=so, use_assembler=assembler is not None, assembler=ao,
        **(extra or {})))
    for s, reads in enumerate(samples):
        over = [r for r in reads if r[0] < region[1]]
        batch = make(CONTIG, over)
        keep = np.flatnonzero(batch.ends > region[0])
        vg.add_reads(s, batch.take(keep))
    return [(v.begin, v.end, v.ref, v.alt) for v in vg.generate(*region)]


@pytest.mark.parametrize("case", list(CASES))
def test_candidates_equal_the_reference(case):
    rng = np.random.default_rng([2_300_023, list(CASES).index(case)])
    ref, samples, region, scanner, assembler, *extra = CASES[case](rng)
    want = candidates("reference", ref, samples, region, scanner, assembler, *extra)
    got = candidates("port", ref, samples, region, scanner, assembler, *extra)
    assert len(want) >= 10
    assert got == want
