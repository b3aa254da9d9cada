#!/usr/bin/env python3
"""Keep only reads uniquely assigned to one haplotype in an evidence BAM.

Capability-equivalent to the reference's scripts/filter_assigned_reads.py:
a read is "assigned" when its HP tag names exactly one haplotype id;
ambiguous (multi-id) and unannotated reads are dropped. Optionally restrict
to a region ("chr1" or "chr1:1,000-2,000").

Uses the port's own htslib-free BAM reader/writer (no pysam needed).

    python -m octopus_tpu_torch.scripts.filter_assigned_reads
        -I evidence.bam -O assigned.bam [-T region]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io.bam import BamFile
from ..io.bam_writer import BamWriter, build_bai
from .split_realigned_bam import aux_tags


def parse_region(region: str) -> tuple[str, int | None, int | None]:
    if ":" not in region:
        return region, None, None
    contig, _, rest = region.partition(":")
    begin, _, end = rest.partition("-")
    return contig, int(begin.replace(",", "")), int(end.replace(",", ""))


def is_assigned(batch, i) -> bool:
    v = batch.tag(i, "HP")
    return v is not None and "," not in str(v)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-I", "--in-bam", required=True)
    p.add_argument("-O", "--out-bam", required=True)
    p.add_argument("-T", "--region", default=None,
                   help='e.g. "chr1" or "chr1:1,000-2,000"')
    args = p.parse_args(argv)
    if args.in_bam == args.out_bam:
        p.error("--in-bam and --out-bam must differ")

    src = BamFile(args.in_bam)
    ref_names = src.header.ref_names
    ref_lengths = src.header.ref_lengths
    if args.region:
        contig, begin, end = parse_region(args.region)
        spans = [(contig, begin or 0,
                  end if end is not None else ref_lengths[ref_names.index(contig)])]
    else:
        spans = [(c, 0, ln) for c, ln in zip(ref_names, ref_lengths)]

    kept = total = 0
    with BamWriter(args.out_bam, ref_names, ref_lengths,
                   samples=src.samples()) as w:
        for contig, begin, end in spans:
            for batch in src.fetch(contig, begin, end, keep_names=True,
                                   keep_aux=True).values():
                total += len(batch)
                rows = [i for i in range(len(batch)) if is_assigned(batch, i)]
                if not rows:
                    continue
                sub = batch.take(np.asarray(rows))
                w.write_batch(sub, tags=aux_tags(sub))
                kept += len(rows)
    build_bai(args.out_bam)
    print(f"kept {kept}/{total} uniquely-assigned reads", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
