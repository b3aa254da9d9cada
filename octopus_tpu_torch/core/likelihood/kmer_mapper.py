"""Vectorised k-mer anchor mapping of reads onto haplotypes.

Capability-equivalent to the reference's kmer mapper
(src/utils/kmer_mapper.hpp:19-60 and haplotype_likelihood_array.cpp usage):
6-mers of each read vote for candidate mapping offsets on the haplotype, and
the offsets with the maximum vote count (up to 10, ascending) become the
pair-HMM anchor candidates.

Hash parity detail: the reference's perfect_hash maps A->0/C->1/G->2/T->3 and
every other character (including N) to 0, i.e. N collides with A; we
reproduce that so anchor sets match.

Everything here is batch numpy: one call processes all reads of a sample
against one haplotype with bincount joins — no per-read python loops over
haplotype positions.
"""

from __future__ import annotations

import numpy as np

K = 6
NUM_KMERS = 4 ** K
MAX_MAPPING_POSITIONS = 10

_POW4 = (4 ** np.arange(K)).astype(np.int64)


def kmer_hashes(codes: np.ndarray) -> np.ndarray:
    """Rolling K-mer perfect hashes of a base-code array (N folded to A)."""
    folded = np.where(codes >= 4, 0, codes).astype(np.int64)
    n = len(folded)
    if n < K:
        return np.zeros(0, dtype=np.int64)
    # windows (n-K+1, K) via stride trick on a contiguous copy
    win = np.lib.stride_tricks.sliding_window_view(folded, K)
    return win @ _POW4


class HaplotypeKmerIndex:
    """CSR index of one haplotype's K-mer positions."""

    def __init__(self, hap_codes: np.ndarray):
        hashes = kmer_hashes(hap_codes)
        self.n_kmers = len(hashes)
        order = np.argsort(hashes, kind="stable")
        self.positions = order.astype(np.int64)        # hap positions sorted by hash
        counts = np.bincount(hashes, minlength=NUM_KMERS)
        self.starts = np.zeros(NUM_KMERS + 1, dtype=np.int64)
        np.cumsum(counts, out=self.starts[1:])

    def map_reads(
        self,
        read_hashes_flat: np.ndarray,
        read_offsets: np.ndarray,
        max_positions: int = MAX_MAPPING_POSITIONS,
    ) -> list[np.ndarray]:
        """Anchor offsets per read.

        read_hashes_flat: concatenated K-mer hashes of all reads;
        read_offsets: (n_reads+1,) into it.  Returns a list of int arrays of
        best mapping begin positions (may be empty)."""
        n_reads = len(read_offsets) - 1
        read_of, begin = self.map_reads_flat(read_hashes_flat, read_offsets,
                                             max_positions)
        counts = np.bincount(read_of, minlength=n_reads)
        offs = np.zeros(n_reads + 1, np.int64)
        np.cumsum(counts, out=offs[1:])
        return [begin[offs[r]:offs[r + 1]] for r in range(n_reads)]

    def map_reads_flat(
        self,
        read_hashes_flat: np.ndarray,
        read_offsets: np.ndarray,
        max_positions: int = MAX_MAPPING_POSITIONS,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Flat (read_index, begin) anchor pairs, grouped by read with
        begins ascending within each read — the loop-free form that
        `likelihood_array._gather_jobs` consumes where the host extension
        (whose `gather_anchor_jobs` computes the same anchors) is
        missing."""
        n_reads = len(read_offsets) - 1
        empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
        if self.n_kmers == 0 or len(read_hashes_flat) == 0:
            return empty
        q = read_hashes_flat
        # per query kmer: matching slice of self.positions
        lo = self.starts[q]
        hi = self.starts[q + 1]
        cnt = hi - lo
        total = int(cnt.sum())
        if total == 0:
            return empty
        # expand matches: for each query index i, positions[lo[i]:hi[i]]
        rep = np.repeat(np.arange(len(q)), cnt)
        intra = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        hap_pos = self.positions[np.repeat(lo, cnt) + intra]
        # read id and in-read kmer index per match
        read_of = np.searchsorted(read_offsets, rep, side="right") - 1
        j = rep - read_offsets[read_of]
        begin = hap_pos - j
        valid = begin >= 0
        read_of, begin = read_of[valid], begin[valid]
        if len(begin) == 0:
            return empty
        # vote histogram per (read, begin)
        max_begin = int(begin.max()) + 1
        key = read_of * max_begin + begin
        if n_reads * max_begin > (1 << 21):
            # sparse path: the dense (n_reads, hap_len) histogram is O(R*L)
            # memory+time and dominates long-haplotype populates (500 bp
            # fragment batches against multi-kb haplotypes); run-length
            # encode the sorted keys instead — O(matches log matches)
            sk = np.sort(key, kind="stable")
            starts_ = np.concatenate(
                ([0], np.flatnonzero(np.diff(sk)) + 1))
            uniq = sk[starts_]
            counts_k = np.diff(np.concatenate((starts_, [len(sk)])))
            r = uniq // max_begin
            b = uniq % max_begin
            best = np.zeros(n_reads, np.int64)
            np.maximum.at(best, r, counts_k)
            is_best = counts_k == best[r]
            rows, cols = r[is_best], b[is_best]
        else:
            votes = np.bincount(key, minlength=n_reads * max_begin).reshape(
                n_reads, max_begin)
            best = votes.max(axis=1)
            # all argmax positions at once (row-major nonzero is grouped by
            # read, begins ascending); best==0 rows would match every
            # column, so compare against -1 there
            tgt = np.where(best > 0, best, -1)
            rows, cols = np.nonzero(votes == tgt[:, None])
        # keep the first max_positions begins per read (ascending)
        counts = np.bincount(rows, minlength=n_reads)
        offs = np.zeros(n_reads + 1, np.int64)
        np.cumsum(counts, out=offs[1:])
        rank = np.arange(len(rows)) - offs[rows]
        keep = rank < max_positions
        return rows[keep].astype(np.int64), cols[keep].astype(np.int64)


def read_kmer_hashes(seq_flat: np.ndarray, seq_offsets: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """K-mer hashes for a ragged read batch.

    Returns (hashes_flat, hash_offsets) with one rolling-hash row per read.
    """
    n = len(seq_offsets) - 1
    lens = np.diff(seq_offsets)
    out_lens = np.maximum(lens - K + 1, 0)
    hash_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(out_lens, out=hash_offsets[1:])
    total = int(hash_offsets[-1])
    if total == 0 or len(seq_flat) < K:
        return np.zeros(0, np.int64), hash_offsets
    # one rolling-hash pass over the whole flat buffer; each read's hashes
    # are the contiguous slice starting at its seq offset (windows that span
    # a read boundary are simply not selected)
    folded = np.where(seq_flat >= 4, 0, seq_flat).astype(np.int64)
    all_hashes = np.lib.stride_tricks.sliding_window_view(folded, K) @ _POW4
    idx = (np.repeat(seq_offsets[:-1], out_lens)
           + np.arange(total)
           - np.repeat(hash_offsets[:-1], out_lens))
    return all_hashes[idx], hash_offsets


__all__ = [
    "K",
    "MAX_MAPPING_POSITIONS",
    "kmer_hashes",
    "read_kmer_hashes",
    "HaplotypeKmerIndex",
]
