"""Batch-prefetching read pipe.

Capability-equivalent to the reference's BufferedReadPipe
(src/readpipe/buffered_read_pipe.{hpp,cpp}): given hint regions (the call
blocks a CSR pass will visit, src/core/octopus.cpp:1446-1453), fetch and
preprocess reads for a whole run of nearby hints at once, bounded by a
max-fetch-size budget, and serve per-region slices from the buffer.
"""

from __future__ import annotations

from ..basics.reads import ReadBatch
from .pipe import ReadPipe


class BufferedReadPipe:
    def __init__(self, read_manager, pipe: ReadPipe | None = None,
                 max_fetch_size: int = 1_000_000, pad: int = 500):
        self.read_manager = read_manager
        self.pipe = pipe or ReadPipe()
        self.max_fetch_size = max_fetch_size
        self.pad = pad
        self._hints: dict[str, list[tuple[int, int]]] = {}
        # one buffered block per contig: (begin, end, {sample: batch})
        self._buffer: tuple[str, int, int, dict[str, ReadBatch]] | None = None

    def hint(self, regions: list[tuple[str, int, int]]) -> None:
        """Register the regions future fetches will cover (merged per contig)."""
        self._hints.clear()
        for contig, b, e in sorted(regions):
            runs = self._hints.setdefault(contig, [])
            if runs and b <= runs[-1][1] + self.pad:
                runs[-1] = (runs[-1][0], max(runs[-1][1], e))
            else:
                runs.append((b, e))

    def fetch(self, contig: str, begin: int, end: int) -> dict[str, ReadBatch]:
        """Processed per-sample reads overlapping [begin, end)."""
        buf = self._buffer
        if buf is None or buf[0] != contig or begin < buf[1] or end > buf[2]:
            self._fill(contig, begin, end)
            buf = self._buffer
        assert buf is not None
        return {s: b.overlapping(begin, end) for s, b in buf[3].items()}

    def _fill(self, contig: str, begin: int, end: int) -> None:
        lo = max(begin - self.pad, 0)
        hi = end + self.pad
        # extend through upcoming hinted runs while the budget allows
        budget = self.max_fetch_size
        for b, e in self._hints.get(contig, []):
            if e <= lo or b >= hi + budget:
                continue
            if (max(e, hi) + self.pad) - lo <= self.max_fetch_size:
                hi = max(hi, e + self.pad)
        raw = self.read_manager.fetch(contig, lo, hi)
        processed = {}
        for sample, batch in raw.items():
            if len(batch):
                batch, _ = self.pipe.process(batch)
            processed[sample] = batch
        self._buffer = (contig, lo, hi, processed)


__all__ = ["BufferedReadPipe"]
