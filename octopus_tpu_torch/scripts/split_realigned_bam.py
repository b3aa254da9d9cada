#!/usr/bin/env python3
"""Split an evidence BAM (--bamout) into per-haplotype BAMs.

Capability-equivalent to the reference's scripts/split_realigned_bam.py:
reads annotated with an HP tag (comma-joined haplotype ids, written by the
bamout realigner) go to <prefix>_<id[_id...]>.bam keyed by the exact id
tuple; reads without HP go to <prefix>_R.bam unless --assigned-only.

Uses the port's own htslib-free BAM reader/writer (no pysam needed).

    python -m octopus_tpu_torch.scripts.split_realigned_bam -b evidence.bam
        -o prefix [-A]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io.bam import BamFile
from ..io.bam_writer import BamWriter, build_bai


def hp_ids(batch, i) -> tuple[int, ...] | None:
    v = batch.tag(i, "HP")
    if v is None:
        return None
    try:
        return tuple(int(x) for x in str(v).split(","))
    except ValueError:
        return None


def aux_tags(sub) -> list[bytes] | None:
    """Each read's raw aux bytes, for BamWriter.write_batch(tags=...)."""
    if sub.aux is None:
        return None
    return [sub.aux[sub.aux_offsets[j]:sub.aux_offsets[j + 1]].tobytes()
            for j in range(len(sub))]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-b", "--bam", required=True,
                   help="evidence BAM (--bamout) to split")
    p.add_argument("-o", "--output", required=True, help="output prefix")
    p.add_argument("-A", "--assigned-only", action="store_true",
                   help="do not output unassigned (no-HP) reads")
    args = p.parse_args(argv)

    src = BamFile(args.bam)
    ref_names = src.header.ref_names
    ref_lengths = src.header.ref_lengths
    samples = src.samples()

    writers: dict[tuple, BamWriter] = {}
    paths: dict[tuple, str] = {}

    def writer_for(ids: tuple) -> BamWriter:
        if ids not in writers:
            suffix = "R" if ids == ("R",) else "_".join(str(i) for i in ids)
            path = f"{args.output}_{suffix}.bam"
            writers[ids] = BamWriter(path, ref_names, ref_lengths,
                                     samples=samples)
            paths[ids] = path
        return writers[ids]

    n = 0
    for contig, length in zip(ref_names, ref_lengths):
        per_sample = src.fetch(contig, 0, length, keep_names=True,
                               keep_aux=True)
        for batch in per_sample.values():
            groups: dict[tuple, list[int]] = {}
            for i in range(len(batch)):
                ids = hp_ids(batch, i)
                if ids is None:
                    if args.assigned_only:
                        continue
                    ids = ("R",)
                groups.setdefault(ids, []).append(i)
            for ids, rows in groups.items():
                sub = batch.take(np.asarray(rows))
                writer_for(ids).write_batch(sub, tags=aux_tags(sub))
                n += len(rows)
    for ids, w in writers.items():
        w.close()
        build_bai(paths[ids])
    print(f"split {n} reads into {len(writers)} BAMs", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
