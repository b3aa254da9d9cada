"""Synthetic read/reference simulation for tests and the chip smoke run.

Simulated samples stand in for external truth sets: a random reference,
truth variants at human-like rates, and error-bearing reads with exact
CIGARs derived from the simulated haplotype structure. The in-memory
functions return reads as tuples for make_read_batch; write_reference,
write_sample_bam, simulate_diploid and simulate_tumour_normal write a FASTA
and indexed BAMs for the CLI, drawing the same random numbers as the reference package's
functions of the same names.
"""

from __future__ import annotations

import os

import numpy as np


def flatten_haplotype(hap_pieces):
    """(flat sequence string, ref coordinate per flat base; -1 = inserted).

    hap_pieces: one string per reference base — "" for a deleted base,
    base+insertion for an insertion anchored at that base.
    """
    chars, refc = [], []
    for ref_i, piece in enumerate(hap_pieces):
        for k, ch in enumerate(piece):
            chars.append(ch)
            refc.append(ref_i if k == 0 else -1)
    return "".join(chars), np.asarray(refc)


def read_from_flat(hap, refc, begin, read_len, rng, err=0.001):
    """One read tuple (pos, cigar, seq) or None (fully-inserted span)."""
    s = list(hap[begin:begin + read_len])
    for j in range(read_len):
        if rng.random() < err:
            s[j] = "ACGT"[rng.integers(0, 4)]
    rc = refc[begin:begin + read_len]
    aligned = np.flatnonzero(rc >= 0)
    if not len(aligned):
        return None
    lead_ins = int(aligned[0])
    cig, last_ref, run_m = [], None, 0
    if lead_ins:
        cig.append(f"{lead_ins}S")
    for j in range(lead_ins, read_len):
        if rc[j] < 0:
            if run_m:
                cig.append(f"{run_m}M"); run_m = 0
            if cig and cig[-1].endswith("I"):
                cig[-1] = f"{int(cig[-1][:-1]) + 1}I"
            else:
                cig.append("1I")
        else:
            if last_ref is not None and rc[j] > last_ref + 1:
                if run_m:
                    cig.append(f"{run_m}M"); run_m = 0
                cig.append(f"{int(rc[j] - last_ref - 1)}D")
            run_m += 1
            last_ref = int(rc[j])
    if run_m:
        cig.append(f"{run_m}M")
    if cig and cig[-1].endswith("I"):
        cig[-1] = cig[-1][:-1] + "S"
    return (int(rc[aligned[0]]), "".join(cig), "".join(s))


def sample_read_tuples(hap_pieces_pair, n_ref, depth, read_len, rng,
                       err=0.001):
    """Reads of a diploid sample from two haplotype piece-lists, as
    (pos, cigar, seq, quals, mapq, flags) tuples for make_read_batch."""
    from ..basics.reads import FLAG_REVERSE
    flats = [flatten_haplotype(h) for h in hap_pieces_pair]
    n_reads = int(n_ref * depth / read_len)
    reads = []
    for i in range(n_reads):
        hap, refc = flats[i % 2]
        if len(hap) <= read_len:
            continue
        begin = int(rng.integers(0, len(hap) - read_len))
        r = read_from_flat(hap, refc, begin, read_len, rng, err=err)
        if r is None:
            continue
        pos, cig, s = r
        reads.append((pos, cig, s, [37] * read_len, 60,
                      FLAG_REVERSE if rng.random() < 0.5 else 0))
    return reads


def write_reference(tmp, seq, name="chr1"):
    fa = os.path.join(tmp, "ref.fa")
    with open(fa, "w") as fh:
        fh.write(f">{name}\n")
        for i in range(0, len(seq), 70):
            fh.write(seq[i:i + 70] + "\n")
    return fa


def write_sample_bam(tmp, name, hap_pieces_pair, n_ref, depth, read_len, rng,
                     contig="chr1", err=0.001):
    """Simulate a diploid sample from two haplotype piece-lists -> BAM path."""
    reads = sample_read_tuples(hap_pieces_pair, n_ref, depth, read_len, rng,
                               err=err)
    return write_reads_bam(tmp, name, reads, contig, n_ref)


def write_reads_bam(tmp, name, reads, contig, n_ref):
    """Read tuples as a sorted, BAI-indexed BAM of one sample."""
    from ..basics.reads import make_read_batch
    from ..io.bam_writer import BamWriter, build_bai
    batch = make_read_batch(contig, reads).sorted_by_begin()
    bam = os.path.join(tmp, f"{name}.bam")
    with BamWriter(bam, [contig], [n_ref], samples=[name]) as w:
        w.write_batch(batch, sample=name)
    build_bai(bam)
    return bam


def random_sequence(rng, n):
    return "".join("ACGT"[c] for c in rng.integers(0, 4, n))


def random_variant(rng, seq, pos, p_indel=0.15, max_indel=6):
    """('snv', alt) | ('del', size) | ('ins', seq) at pos."""
    if rng.random() < p_indel:
        size = int(rng.integers(1, max_indel))
        if rng.random() < 0.5:
            return ("del", size)
        return ("ins", "".join("ACGT"[c] for c in rng.integers(0, 4, size)))
    base = seq[pos]
    return ("snv", "ACGT"[("ACGT".index(base) + int(rng.integers(1, 4))) % 4])


def apply_variant(haps, pos, kind, members, seq):
    """Apply one variant tuple to the given haplotype piece-lists."""
    for m in members:
        if kind[0] == "snv":
            haps[m][pos] = kind[1]
        elif kind[0] == "del":
            for k in range(kind[1]):
                haps[m][pos + k] = ""
        else:
            haps[m][pos] = seq[pos] + kind[1]


def simulate_diploid_reads(kb=100, depth=30, read_len=150, seed=11,
                           spacing=(600, 1800), err=0.001):
    """A diploid sample in memory: (reference sequence, read tuples, truth
    dict {pos: (kind, zygosity)}, reference length).

    Draws the same random numbers in the same order as the reference
    package's simulate_diploid, so a seed gives the same reference, truth
    and reads; nothing is written to disk."""
    rng = np.random.default_rng(seed)
    n = kb * 1000
    seq = random_sequence(rng, n)
    truth = {}
    haps = [list(seq), list(seq)]
    pos = 1000
    while pos < n - 1000:
        pos += int(rng.integers(*spacing))
        if pos >= n - 1000:
            break
        hom = rng.random() < 0.4
        members = (0, 1) if hom else (int(rng.random() < 0.5),)
        kind = random_variant(rng, seq, pos)
        truth[pos] = (kind, "hom" if hom else "het")
        apply_variant(haps, pos, kind, members, seq)
    reads = sample_read_tuples(haps, n, depth, read_len, rng, err=err)
    return seq, reads, truth, n


def simulate_diploid(tmp, kb=100, depth=30, read_len=150, seed=11,
                     spacing=(600, 1800), sample="SIM", err=0.001):
    """Reference FASTA + one diploid BAM + truth dict {pos: (kind, zygosity)}
    (the reads of simulate_diploid_reads, written to disk)."""
    seq, reads, truth, n = simulate_diploid_reads(
        kb=kb, depth=depth, read_len=read_len, seed=seed, spacing=spacing,
        err=err)
    fa = write_reference(tmp, seq)
    return fa, write_reads_bam(tmp, sample, reads, "chr1", n), truth, n


def simulate_tumour_normal(tmp, kb=60, depth=60, seed=7, vaf=0.25,
                           read_len=150, n_somatic=14, err=0.001, min_gap=50):
    """Reference + NORMAL/TUMOUR BAMs + (germline dict, somatic dict).

    The normal is a diploid at depth // 2; the tumour mixes a somatic clone
    (SNVs on haplotype 0) into the normal diploid at read fraction 2*vaf,
    giving expected somatic VAF = vaf. A somatic SNV lands at least min_gap
    bases from every germline variant and earlier somatic SNV. Draws the
    same random numbers in the same order as the reference package's
    function of the same name (min_gap 50), and as bench_e2e_multi.py's
    bench_cancer (min_gap 51). Returns (fasta, normal BAM, tumour BAM,
    germline, somatic, length)."""
    from ..basics.reads import FLAG_REVERSE

    rng = np.random.default_rng(seed)
    n = kb * 1000
    seq = random_sequence(rng, n)
    fa = write_reference(tmp, seq)
    normal = [list(seq), list(seq)]
    germline = {}
    pos = 1500
    while pos < n - 1500:
        pos += int(rng.integers(1200, 3000))
        if pos >= n - 1500:
            break
        kind = random_variant(rng, seq, pos)
        hom = rng.random() < 0.3
        apply_variant(normal, pos, kind,
                      (0, 1) if hom else (int(rng.random() < 0.5),), seq)
        germline[pos] = (kind, "hom" if hom else "het")
    clone = [list(normal[0]), list(normal[1])]
    somatic = {}
    for _ in range(n_somatic):
        pos = int(rng.integers(2000, n - 2000))
        if (any(abs(pos - g) < min_gap for g in germline)
                or any(abs(pos - s) < min_gap for s in somatic)):
            continue
        base = seq[pos]
        alt = "ACGT"[("ACGT".index(base) + 2) % 4]
        clone[0][pos] = alt
        somatic[pos] = (("snv", alt), "som")
    bam_n = write_sample_bam(tmp, "NORMAL", normal, n, depth // 2, read_len,
                             rng, err=err)
    flats_n = [flatten_haplotype(h) for h in normal]
    flats_c = [flatten_haplotype(h) for h in clone]
    n_reads = int(n * depth / read_len)
    reads = []
    for i in range(n_reads):
        hap, refc = (flats_c if rng.random() < 2 * vaf else flats_n)[i % 2]
        begin = int(rng.integers(0, len(hap) - read_len))
        r = read_from_flat(hap, refc, begin, read_len, rng, err=err)
        if r is None:
            continue
        p, cig, s = r
        reads.append((p, cig, s, [37] * read_len, 60,
                      FLAG_REVERSE if rng.random() < 0.5 else 0))
    bam_t = write_reads_bam(tmp, "TUMOUR", reads, "chr1", n)
    return fa, bam_n, bam_t, germline, somatic, n


def _near(positions, p, tol):
    return any(abs(p - q) <= tol for q in positions)


def simulate_trio(tmp, kb=100, depth=30, seed=5, read_len=150):
    """Reference + MOM/DAD/KID BAMs + (germline, de novo) position sets.

    Germline variants land on one parent, on one or both of its haplotypes;
    the child takes the mother's haplotype 0 and the father's haplotype 1,
    plus up to 10 de novo SNVs. Draws the same random numbers in the same
    order as bench_e2e_multi.py's bench_trio, so a seed writes the same
    files. Returns (fasta, [MOM, DAD, KID] BAMs, germline, denovo, length)."""
    rng = np.random.default_rng(seed)
    n = kb * 1000
    seq = random_sequence(rng, n)
    fa = write_reference(tmp, seq)
    mom = [list(seq), list(seq)]
    dad = [list(seq), list(seq)]
    germline = set()
    pos = 1500
    while pos < n - 1500:
        pos += int(rng.integers(900, 2400))
        if pos >= n - 1500:
            break
        kind = random_variant(rng, seq, pos)
        carrier = mom if rng.random() < 0.5 else dad
        members = (0, 1) if rng.random() < 0.3 else (int(rng.random() < 0.5),)
        apply_variant(carrier, pos, kind, members, seq)
        germline.add(pos)
    kid = [list(mom[0]), list(dad[1])]
    denovo = set()
    for _ in range(10):
        pos = int(rng.integers(2000, n - 2000))
        if _near(germline, pos, 50) or _near(denovo, pos, 50):
            continue
        base = seq[pos]
        kid[int(rng.random() < 0.5)][pos] = "ACGT"[("ACGT".index(base) + 1) % 4]
        denovo.add(pos)
    bams = [write_sample_bam(tmp, name, haps, n, depth, read_len, rng)
            for name, haps in (("MOM", mom), ("DAD", dad), ("KID", kid))]
    return fa, bams, germline, denovo, n


def simulate_population(tmp, kb=100, depth=30, seed=9, n_samples=3,
                        read_len=150):
    """Reference + one BAM per sample (S0, S1, ...) + truth {pos: per-sample
    [hap0, hap1] alt flags}.

    Each site draws an allele frequency from {0.17, 0.33, 0.5, 0.83} and
    each sample's two haplotypes carry the alt with it, at least one sample
    carrying it. Draws the same random numbers in the same order as
    bench_e2e_multi.py's bench_population, so a seed writes the same files.
    Returns (fasta, BAMs, truth, length)."""
    rng = np.random.default_rng(seed)
    n = kb * 1000
    seq = random_sequence(rng, n)
    fa = write_reference(tmp, seq)
    samples = [[list(seq), list(seq)] for _ in range(n_samples)]
    truth = {}
    pos = 1500
    while pos < n - 1500:
        pos += int(rng.integers(900, 2400))
        if pos >= n - 1500:
            break
        kind = random_variant(rng, seq, pos)
        af = rng.choice([0.17, 0.33, 0.5, 0.83])
        gts = [[int(rng.random() < af), int(rng.random() < af)]
               for _ in range(n_samples)]
        if not any(any(gt) for gt in gts):
            gts[int(rng.integers(0, n_samples))][0] = 1
        for haps, gt in zip(samples, gts):
            members = tuple(h for h in (0, 1) if gt[h])
            if members:
                apply_variant(haps, pos, kind, members, seq)
        truth[pos] = gts
    bams = [write_sample_bam(tmp, f"S{i}", haps, n, depth, read_len, rng)
            for i, haps in enumerate(samples)]
    return fa, bams, truth, n


def mixture_reads(flats, weights, n_reads, read_len, rng):
    """Reads from flattened haplotypes drawn at the given weights."""
    from ..basics.reads import FLAG_REVERSE
    cum = np.cumsum(weights) / np.sum(weights)
    reads = []
    for _ in range(n_reads):
        hap, refc = flats[int(np.searchsorted(cum, rng.random()))]
        begin = int(rng.integers(0, len(hap) - read_len))
        r = read_from_flat(hap, refc, begin, read_len, rng)
        if r is None:
            continue
        p, cig, s = r
        reads.append((p, cig, s, [37] * read_len, 60,
                      FLAG_REVERSE if rng.random() < 0.5 else 0))
    return reads


def simulate_polyclone(tmp, kb=12, depth=100, read_len=150, seed=31):
    """Three haploid clones at 0.5/0.3/0.2 in one pooled BAM: two trunk SNVs
    in every clone and one private SNV per clone.
    Returns (fasta, BAM, trunk positions, {private position: clone}, length).
    At the defaults these are the reads of the reference package's polyclone
    end-to-end test (tests/test_e2e_polyclone_cell.py)."""
    rng = np.random.default_rng(seed)
    n = kb * 1000
    seq = random_sequence(rng, n)
    fa = write_reference(tmp, seq)
    clones = [list(seq) for _ in range(3)]
    trunk = [n // 6, n // 2]
    private = {n // 3: 0, 2 * n // 3: 1, 5 * n // 6: 2}
    for p in trunk:
        for c in clones:
            c[p] = "T" if seq[p] != "T" else "A"
    for p, ci in private.items():
        clones[ci][p] = "G" if seq[p] != "G" else "C"
    flats = [flatten_haplotype(c) for c in clones]
    reads = mixture_reads(flats, [0.5, 0.3, 0.2], int(n * depth / read_len),
                           read_len, rng)
    return fa, write_reads_bam(tmp, "POOL", reads, "chr1", n), trunk, private, n


def simulate_cells(tmp, kb=9, depth=15, read_len=150, seed=37,
                   clone_of_cell=(0, 0, 0, 1, 1, 1)):
    """Single cells of a founder (two germline hets) and one descendant clone
    (one somatic SNV), one BAM per cell, each cell's haplotypes read at a
    Beta(2, 2) allelic-dropout bias. Returns (fasta, BAMs, germline
    positions, somatic position, length). At the defaults these are the
    reads of the reference package's cell end-to-end test
    (tests/test_e2e_polyclone_cell.py)."""
    rng = np.random.default_rng(seed)
    n = kb * 1000
    seq = random_sequence(rng, n)
    fa = write_reference(tmp, seq)
    founder = [list(seq), list(seq)]
    germ = [2 * n // 9, 13 * n // 18]
    for p in germ:
        founder[int(rng.random() < 0.5)][p] = "T" if seq[p] != "T" else "A"
    clone = [list(founder[0]), list(founder[1])]
    som = 7 * n // 15
    clone[0][som] = "G" if seq[som] != "G" else "C"
    bams = []
    for ci, cl in enumerate(clone_of_cell):
        flats = [flatten_haplotype(h) for h in (founder if cl == 0 else clone)]
        w0 = float(rng.beta(2.0, 2.0))
        reads = mixture_reads(flats, [w0, 1 - w0], int(n * depth / read_len),
                               read_len, rng)
        bams.append(write_reads_bam(tmp, f"CELL{ci}", reads, "chr1", n))
    return fa, bams, germ, som, n


def truth_to_vcf(truth: dict, seq: str, path: str, contig="chr1") -> str:
    """Write a truth dict as a minimal VCF usable for labelling/eval."""
    lines = ["##fileformat=VCFv4.3",
             f"##contig=<ID={contig},length={len(seq)}>",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
    for pos in sorted(truth):
        kind = truth[pos][0] if isinstance(truth[pos], tuple) else truth[pos]
        if kind[0] == "snv":
            ref, alt, vpos = seq[pos], kind[1], pos + 1
        elif kind[0] == "del":
            ref, alt, vpos = seq[pos - 1:pos + kind[1]], seq[pos - 1], pos
        else:
            ref, alt, vpos = seq[pos], seq[pos] + kind[1], pos + 1
        lines.append(f"{contig}\t{vpos}\t.\t{ref}\t{alt}\t100\tPASS\t.")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


__all__ = [
    "flatten_haplotype", "read_from_flat", "sample_read_tuples",
    "write_reference", "write_sample_bam", "random_sequence",
    "random_variant", "apply_variant", "simulate_diploid",
    "simulate_diploid_reads", "simulate_tumour_normal", "simulate_polyclone",
    "simulate_cells", "truth_to_vcf", "write_reads_bam", "mixture_reads",
]
