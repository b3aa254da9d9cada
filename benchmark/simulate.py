"""The benchmark's input generator: a random contig, truth variants and reads.

One general generator for every configuration and traffic mix. The
configuration file gives the deployment (samples and depths, read length,
base quality, error rate, variant rates, somatic clone); the traffic file
gives the contig and its shards and may override the variant spacing.

The variant layout (the sites' positions, kinds, sizes, zygosities and
which haplotypes carry them, somatic sites included) and the reads'
draws (where each read starts, whether a tumour read is of the clone,
which of its bases are errors and to which other base each changes) come
from the traffic's fixed ``layout_seed``; the reference bases and the
inserted bases come from ``--seed``. So every seed calls the same
variation from the same reads at the same places of every shard, on
another sequence: the same work, so that the seed does not move a run's
time (errors drawn from the seed formed, on a few seeds, clusters of
candidates that cost a shard ten times its median), and a seed always
gives the same inputs.

A traffic that sets ``reads_from_seed`` (true) draws the reads from
``--seed`` instead, after the sites, with errors that draw a random base,
as this generator did before the reads were fixed. Some of those draws
run the card out of memory in one window of the tumour cell, a fault of
the program that the fixed reads do not reach: PERF.md's first open
question, and the card test ``test_window_of_seed_drawn_reads_on_the_card``
that holds the program to such a draw.

The model is that of the port's ``bench_e2e.simulate`` and
``utils.synthetic.simulate_tumour_normal``: substitution errors that draw a
random base, every third read (in coordinate order) reverse, reads placed
uniformly on their haplotype, alternating haplotypes, a tumour read taken
from the clone with the sample's clone fraction; the per-read loops are
vectorised here, so the draws differ from those functions' for a seed. An
error draws a random base, which changes the base three times in four: it
is drawn here as a change to one of the three other bases at three
quarters of the error rate, the same distribution, so that which bases an
error changes does not depend on the sequence.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)

# CIGAR operation codes (SAM): M, I, D, S
OP_M, OP_I, OP_D, OP_S = 0, 1, 2, 4
CHUNK = 100_000             # reads a block of the vectorised draws


@dataclass
class Site:
    """One truth variant. pos is 0-based; kind "snv" (alt a base code),
    "del" (size bases from pos deleted) or "ins" (alt bases inserted after
    pos); members the haplotypes that carry it."""

    pos: int
    kind: str
    alt: object
    members: tuple
    somatic: bool = False

    @property
    def zygosity(self) -> str:
        return "hom" if len(self.members) == 2 else "het"


@dataclass
class SampleReads:
    """Reads of one sample in coordinate order. Simple reads (all M) are
    rows of seq; the rest carry their own CIGAR in `cigars` (index ->
    list of (length, op))."""

    name: str
    begins: np.ndarray          # int64 (n,), 0-based reference begin
    ends: np.ndarray            # int64 (n,), exclusive reference end
    seq: np.ndarray             # uint8 (n, read_len), codes 0-3
    flags: np.ndarray           # uint16 (n,)
    cigars: dict


@dataclass
class Inputs:
    reference: np.ndarray       # uint8 codes 0-3
    sites: list                 # list[Site], germline then somatic
    samples: list               # list[SampleReads]
    read_len: int
    base_qual: int
    mapq: int


def _layout(rng_layout, n: int, germline: dict):
    """The multiset of germline sites: (gaps, kinds, sizes, hom, member,
    alt shift) drawn from the layout stream alone."""
    lo, hi = germline["spacing"]
    start, margin = germline.get("start", 1000), germline.get("margin", 1000)
    cap = int((n - start - margin) / lo) + 2
    gaps = rng_layout.integers(lo, hi, cap)
    # the count is fixed by the layout stream: sites while the sum fits
    ends = start + np.cumsum(gaps)
    count = int(np.searchsorted(ends, n - margin, side="left"))
    gaps = gaps[:count]
    indel = rng_layout.random(count) < germline["indel_fraction"]
    size_lo, size_hi = germline["indel_sizes"]
    sizes = rng_layout.integers(size_lo, size_hi + 1, count)
    is_del = rng_layout.random(count) < 0.5
    hom = rng_layout.random(count) < germline["hom_fraction"]
    member = rng_layout.integers(0, 2, count)
    shift = rng_layout.integers(1, 4, count)
    return gaps, indel, sizes, is_del, hom, member, shift


def make_sites(rng, rng_layout, reference: np.ndarray, germline: dict,
               somatic: dict | None) -> list:
    n = len(reference)
    gaps, indel, sizes, is_del, hom, member, shift = _layout(
        rng_layout, n, germline)
    positions = germline.get("start", 1000) + np.cumsum(gaps)
    sites = []
    for k, pos in enumerate(positions):
        pos = int(pos)
        members = (0, 1) if hom[k] else (int(member[k]),)
        if indel[k] and is_del[k]:
            sites.append(Site(pos, "del", int(sizes[k]), members))
        elif indel[k]:
            sites.append(Site(pos, "ins",
                              rng.integers(0, 4, int(sizes[k])).astype(np.uint8),
                              members))
        else:
            sites.append(Site(pos, "snv",
                              int((reference[pos] + shift[k]) % 4), members))
    if somatic:
        count = int(round(somatic["per_100kb"] * n / 100_000))
        taken = np.asarray(sorted(s.pos for s in sites), np.int64)
        gap = somatic["min_gap"]
        edge = somatic.get("margin", 2000)
        chosen: list[int] = []
        while len(chosen) < count:
            pos = int(rng_layout.integers(edge, n - edge))
            j = np.searchsorted(taken, pos)
            near = [taken[i] for i in (j - 1, j) if 0 <= i < len(taken)]
            if any(abs(pos - int(t)) < gap for t in near) or any(
                    abs(pos - c) < gap for c in chosen):
                continue
            chosen.append(pos)
        for pos in chosen:
            sites.append(Site(pos, "snv", int((reference[pos] + 2) % 4),
                              (somatic.get("hap", 0),), somatic=True))
    return sites


def haplotype(reference: np.ndarray, sites: list, hap: int, with_somatic: bool):
    """(sequence codes, reference coordinate of each base; -1 inserted) of
    one haplotype carrying `sites` whose members include `hap`."""
    seq_parts, ref_parts = [], []
    cursor = 0
    for s in sorted(sites, key=lambda s: s.pos):
        if hap not in s.members or (s.somatic and not with_somatic):
            continue
        if s.pos < cursor:
            continue
        seq_parts.append(reference[cursor:s.pos])
        ref_parts.append(np.arange(cursor, s.pos, dtype=np.int64))
        if s.kind == "snv":
            seq_parts.append(np.asarray([s.alt], np.uint8))
            ref_parts.append(np.asarray([s.pos], np.int64))
            cursor = s.pos + 1
        elif s.kind == "del":
            cursor = s.pos + s.alt
        else:
            seq_parts.append(np.concatenate(([reference[s.pos]], s.alt)).astype(np.uint8))
            ref_parts.append(np.concatenate(([s.pos], np.full(len(s.alt), -1))).astype(np.int64))
            cursor = s.pos + 1
    seq_parts.append(reference[cursor:])
    ref_parts.append(np.arange(cursor, len(reference), dtype=np.int64))
    return np.concatenate(seq_parts), np.concatenate(ref_parts)


def _cigar(rc: np.ndarray) -> tuple[int, list] | None:
    """(reference begin, [(length, op)]) of a read whose bases sit at
    reference coordinates rc (-1 inserted), as bench_e2e.simulate builds
    it: leading inserted bases soft-clipped, a trailing insertion too."""
    aligned = np.flatnonzero(rc >= 0)
    if not len(aligned):
        return None
    ops: list = []

    def push(length, op):
        if ops and ops[-1][1] == op:
            ops[-1] = (ops[-1][0] + length, op)
        else:
            ops.append((length, op))

    lead = int(aligned[0])
    if lead:
        push(lead, OP_S)
    last = None
    for j in range(lead, len(rc)):
        r = int(rc[j])
        if r < 0:
            push(1, OP_I)
        else:
            if last is not None and r > last + 1:
                push(r - last - 1, OP_D)
            push(1, OP_M)
            last = r
    if ops[-1][1] == OP_I:
        ops[-1] = (ops[-1][0], OP_S)
    return int(rc[aligned[0]]), ops


def _span(ops: list) -> int:
    return sum(length for length, op in ops if op in (OP_M, OP_D))


def sample_reads(rng, name: str, haps: list, n_ref: int, depth: float,
                 read_len: int, err: float, clone_haps: list | None,
                 clone_fraction: float, reverse_every: int,
                 shift_errors: bool = True) -> SampleReads:
    """Reads of one sample: read i from haplotype i % 2, of the clone with
    probability clone_fraction, at a uniform begin. An error changes its
    base to one of the other three at 3/4 of `err` (`shift_errors`), or
    draws a random base at `err`: the same distribution."""
    n_reads = int(n_ref * depth / read_len)
    which = np.arange(n_reads) % 2
    from_clone = (rng.random(n_reads) < clone_fraction) if clone_haps else \
        np.zeros(n_reads, bool)
    sources = [haps[0], haps[1]] + (list(clone_haps) if clone_haps else [])
    src = which + 2 * from_clone
    begins_hap = np.zeros(n_reads, np.int64)
    for k, (hseq, _) in enumerate(sources):
        sel = np.flatnonzero(src == k)
        begins_hap[sel] = rng.integers(0, len(hseq) - read_len, len(sel))
    seq = np.empty((n_reads, read_len), np.uint8)
    ref_begin = np.empty(n_reads, np.int64)
    ref_end = np.empty(n_reads, np.int64)
    cigars_by_read: dict = {}
    cols = np.arange(read_len)
    for k, (hseq, href) in enumerate(sources):
        # in blocks, so that the (reads, read_len) index arrays stay small
        for sel in np.array_split(np.flatnonzero(src == k),
                                  max(1, int(np.sum(src == k)) // CHUNK)):
            if not len(sel):
                continue
            idx = begins_hap[sel, None] + cols[None, :]
            seq[sel] = hseq[idx]
            rc = href[idx]
            simple = (rc.min(axis=1) >= 0) & (rc[:, -1] - rc[:, 0] == read_len - 1)
            ref_begin[sel] = rc[:, 0]
            ref_end[sel] = rc[:, 0] + read_len
            for j in np.flatnonzero(~simple):
                got = _cigar(rc[j])
                if got is None:
                    ref_begin[sel[j]] = -1
                    continue
                begin, ops = got
                ref_begin[sel[j]] = begin
                ref_end[sel[j]] = begin + _span(ops)
                cigars_by_read[int(sel[j])] = ops
    for lo in range(0, n_reads, CHUNK):
        block = seq[lo:lo + CHUNK]
        if shift_errors:
            errors = rng.random(block.shape, dtype=np.float32) < 0.75 * err
            shift = rng.integers(1, 4, int(errors.sum())).astype(np.uint8)
            block[errors] = (block[errors] + shift) % 4
        else:
            errors = rng.random(block.shape, dtype=np.float32) < err
            block[errors] = rng.integers(0, 4, int(errors.sum())).astype(np.uint8)
    keep = np.flatnonzero(ref_begin >= 0)
    order = keep[np.argsort(ref_begin[keep], kind="stable")]
    rank = np.full(n_reads, -1, np.int64)
    rank[order] = np.arange(len(order))
    flags = np.where(np.arange(len(order)) % reverse_every == 0, 16, 0
                     ).astype(np.uint16)
    return SampleReads(name=name, begins=ref_begin[order], ends=ref_end[order],
                       seq=seq[order], flags=flags,
                       cigars={int(rank[old]): ops for old, ops in
                               cigars_by_read.items() if rank[old] >= 0})


def simulate(config: dict, traffic: dict, seed: int) -> Inputs:
    """The cell's inputs for `seed`: the contig of traffic["contig_kb"], the
    configuration's variation and one read set a sample."""
    rng = np.random.default_rng(seed)
    rng_layout = np.random.default_rng(traffic["layout_seed"])
    reads_cfg = config["reads"]
    n = int(traffic["contig_kb"]) * 1000
    reference = rng.integers(0, 4, n).astype(np.uint8)
    germline = config["germline"]
    somatic = config.get("somatic")
    sites = make_sites(rng, rng_layout, reference, germline, somatic)
    normal = [haplotype(reference, sites, h, False) for h in (0, 1)]
    clone = ([haplotype(reference, sites, h, True) for h in (0, 1)]
             if somatic else None)
    from_seed = bool(traffic.get("reads_from_seed", False))
    samples = []
    for k, sample in enumerate(config["samples"]):
        fraction = float(sample.get("clone_fraction", 0.0))
        rng_reads = (rng if from_seed else
                     np.random.default_rng([traffic["layout_seed"], k + 1]))
        samples.append(sample_reads(
            rng_reads, sample["name"], normal, n, float(sample["depth"]),
            int(reads_cfg["length"]), float(reads_cfg["error_rate"]),
            clone if fraction > 0 else None, fraction,
            int(reads_cfg["reverse_every"]), shift_errors=not from_seed))
    return Inputs(reference=reference, sites=sites, samples=samples,
                  read_len=int(reads_cfg["length"]),
                  base_qual=int(reads_cfg["base_qual"]),
                  mapq=int(reads_cfg["mapq"]))


__all__ = ["Inputs", "SampleReads", "Site", "simulate", "haplotype",
           "make_sites", "sample_reads", "ACGT"]
