"""Multi-file, multi-sample read management.

Capability-equivalent to the reference's ReadManager
(src/io/read/read_manager.{hpp,cpp}): owns the input alignment files with an
open-file limit (LRU pooling), routes fetches by sample across files, and
provides find_covered_subregion-style read budgeting for dynamic task sizing
(read_manager.hpp:90-94).  BAM and CRAM containers are supported (CRAM via
io/cram.py; pass `reference=` — CRAM slices normally require it to decode).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from ..basics.reads import ReadBatch
from .bam import BamFile


class ReadManager:
    def __init__(self, paths: list[str], max_open_files: int = 32,
                 reference=None):
        self.paths = [str(p) for p in paths]
        self.reference = reference
        self.max_open_files = max_open_files
        self._open: "OrderedDict[str, object]" = OrderedDict()
        # samples discovered once (headers only)
        self._samples: list[str] = []
        self._samples_of: dict[str, list[str]] = {}
        for p in self.paths:
            bam = self._get(p)
            self._samples_of[p] = bam.samples()
        self._samples = sorted({s for ss in self._samples_of.values() for s in ss})

    def _open_file(self, path: str):
        if path.endswith(".cram"):
            from .cram import CramFile
            return CramFile(path, reference=self.reference)
        return BamFile(path)

    @staticmethod
    def _close_file(f) -> None:
        if hasattr(f, "close"):
            f.close()
        elif hasattr(f, "_bgzf"):
            f._bgzf.close()

    def _get(self, path: str):
        bam = self._open.get(path)
        if bam is not None:
            self._open.move_to_end(path)
            return bam
        bam = self._open_file(path)
        self._open[path] = bam
        if len(self._open) > self.max_open_files:
            old_path, old = self._open.popitem(last=False)
            self._close_file(old)
        return bam

    def samples(self) -> list[str]:
        return self._samples

    def contig_names(self) -> list[str]:
        return self._get(self.paths[0]).header.ref_names

    def fetch(self, contig: str, begin: int, end: int) -> dict[str, ReadBatch]:
        """Merged per-sample batches across all files."""
        per_sample: dict[str, list[ReadBatch]] = {s: [] for s in self._samples}
        for p in self.paths:
            got = self._get(p).fetch(contig, begin, end)
            for s, batch in got.items():
                if len(batch):
                    per_sample[s].append(batch)
        out = {}
        for s in self._samples:
            if per_sample[s]:
                out[s] = ReadBatch.concatenate(per_sample[s]).sorted_by_begin()
            else:
                out[s] = ReadBatch.empty(contig)
        return out

    def find_covered_subregion(self, contig: str, begin: int, end: int,
                               max_reads: int) -> tuple[int, int]:
        """Largest [begin, x) whose approximate read count stays under budget
        (BAI linear-index density; read_manager.hpp:90-94 role)."""
        total = np.zeros(0)
        for p in self.paths:
            bam = self._get(p)
            if bam.index is None or contig not in bam.header.ref_names:
                return begin, end
            rid = bam.header.ref_names.index(contig)
            linear = bam.index.linear[rid]
            coffs = (np.asarray(linear) >> 16).astype(np.float64)
            d = np.maximum(np.diff(np.concatenate([coffs, coffs[-1:]])), 0) / 100.0
            if len(d) > len(total):
                t = np.zeros(len(d))
                t[:len(total)] = total
                total = t
            total[:len(d)] += d
        acc = 0.0
        pos = begin
        while pos < end:
            b = pos >> 14
            acc += total[b] if b < len(total) else 0.0
            if acc > max_reads:
                return begin, max(min((b + 1) << 14, end), begin + 1)
            pos = (b + 1) << 14
        return begin, end

    def close(self) -> None:
        for bam in self._open.values():
            self._close_file(bam)
        self._open.clear()


__all__ = ["ReadManager"]
