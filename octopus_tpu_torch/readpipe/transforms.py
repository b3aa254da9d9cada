"""Read transforms — the full reference inventory
(src/readpipe/transformers/read_transform.hpp:15-182).

Each transform mutates the batch's quality array in place.  Vectorised where
the access pattern allows; clip-aware ones loop over the (few) clipped reads.
Sequences are stored as base codes, so CapitaliseBases (case normalisation)
is inherently satisfied at decode time and kept as a documented no-op.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..basics import cigar as cg
from ..basics.reads import (
    FLAG_MATE_UNMAPPED,
    FLAG_PAIRED,
    FLAG_PROPER_PAIR,
    FLAG_REVERSE,
    ReadBatch,
)

_COMPLEMENT = np.array([3, 2, 1, 0, 4, 5], dtype=np.uint8)


def _zero_front(quals, o, L, n):
    if n > 0:
        quals[o:o + min(int(n), L)] = 0


def _zero_back(quals, o, L, n):
    if n > 0:
        quals[o + max(L - int(n), 0):o + L] = 0


def _soft_clip_sizes(batch: ReadBatch, i: int) -> tuple[int, int]:
    cigar = batch.cigar(i)
    if len(cigar) == 0:
        return 0, 0
    return cg.soft_clip_sizes(cigar)


def capitalise_bases(batch: ReadBatch, quals: np.ndarray) -> None:
    """CapitaliseBases: base codes are case-free by construction."""


def cap_base_qualities(batch: ReadBatch, quals: np.ndarray, max_quality: int) -> None:
    np.minimum(quals, max_quality, out=quals)


def mask_overlapped_segment(batch: ReadBatch, quals: np.ndarray) -> None:
    """Zero the forward read's qualities past its mate's begin
    (MaskOverlappedSegment; only forward reads masked to avoid doubling)."""
    if batch.mate_begins is None:
        return
    paired = (batch.flags & FLAG_PAIRED) != 0
    mate_mapped = (batch.flags & FLAG_MATE_UNMAPPED) == 0
    same = batch.mate_same_contig if batch.mate_same_contig is not None else np.zeros(len(batch), bool)
    fwd = ~batch.is_reverse()
    overlap = batch.ends - batch.mate_begins
    rows = np.flatnonzero(paired & mate_mapped & same & fwd & (overlap > 0))
    for i in rows:
        o = int(batch.seq_offsets[i])
        L = int(batch.seq_offsets[i + 1] - o)
        _zero_back(quals, o, L, int(overlap[i]))


def mask_adapters(batch: ReadBatch, quals: np.ndarray) -> None:
    """Zero 3' bases read past the inferred template (MaskAdapters)."""
    if batch.template_lengths is None:
        return
    paired = (batch.flags & FLAG_PAIRED) != 0
    proper = (batch.flags & FLAG_PROPER_PAIR) != 0
    same = batch.mate_same_contig if batch.mate_same_contig is not None else np.zeros(len(batch), bool)
    insert = np.abs(batch.template_lengths.astype(np.int64))
    lens = batch.lengths()
    n_adapter = lens - insert
    rows = np.flatnonzero(paired & proper & same & (n_adapter > 0))
    rev = batch.is_reverse()
    for i in rows:
        o = int(batch.seq_offsets[i])
        L = int(lens[i])
        if rev[i]:
            _zero_front(quals, o, L, int(n_adapter[i]))
        else:
            _zero_back(quals, o, L, int(n_adapter[i]))


def mask_tail(batch: ReadBatch, quals: np.ndarray, num_bases: int) -> None:
    rev = batch.is_reverse()
    for i in range(len(batch)):
        o = int(batch.seq_offsets[i])
        L = int(batch.seq_offsets[i + 1] - o)
        if rev[i]:
            _zero_front(quals, o, L, num_bases)
        else:
            _zero_back(quals, o, L, num_bases)


def mask_low_quality_tails(batch: ReadBatch, quals: np.ndarray, threshold: int) -> None:
    """Zero the 3' run of qualities below threshold (MaskLowQualityTails)."""
    rev = batch.is_reverse()
    for i in range(len(batch)):
        o = int(batch.seq_offsets[i])
        L = int(batch.seq_offsets[i + 1] - o)
        q = quals[o:o + L]
        if rev[i]:
            k = 0
            while k < L and q[k] < threshold:
                k += 1
            q[:k] = 0
        else:
            k = L
            while k > 0 and q[k - 1] < threshold:
                k -= 1
            q[k:] = 0


def _clipped_rows(batch: ReadBatch) -> np.ndarray:
    has_clip = np.zeros(len(batch), bool)
    ops = batch.cigar_ops[:, 1]
    read_of_op = np.repeat(np.arange(len(batch)), np.diff(batch.cigar_offsets))
    np.logical_or.at(has_clip, read_of_op, ops == cg.S)
    return np.flatnonzero(has_clip)


def mask_soft_clipped(batch: ReadBatch, quals: np.ndarray) -> None:
    for i in _clipped_rows(batch):
        front, back = _soft_clip_sizes(batch, i)
        o = int(batch.seq_offsets[i])
        L = int(batch.seq_offsets[i + 1] - o)
        _zero_front(quals, o, L, front)
        _zero_back(quals, o, L, back)


def mask_soft_clipped_boundary_bases(batch: ReadBatch, quals: np.ndarray,
                                     num_bases: int) -> None:
    for i in _clipped_rows(batch):
        front, back = _soft_clip_sizes(batch, i)
        o = int(batch.seq_offsets[i])
        L = int(batch.seq_offsets[i + 1] - o)
        if front:
            _zero_front(quals, o, L, front + num_bases)
        if back:
            _zero_back(quals, o, L, back + num_bases)


def _mask_low_front(quals, o, L, n, max_q):
    n = min(int(n), L)
    seg = quals[o:o + n]
    seg[seg < max_q] = 0


def _mask_low_back(quals, o, L, n, max_q):
    n = min(int(n), L)
    seg = quals[o + L - n:o + L]
    seg[seg < max_q] = 0


def mask_low_quality_soft_clipped_bases(batch: ReadBatch, quals: np.ndarray,
                                        max_quality: int) -> None:
    for i in _clipped_rows(batch):
        front, back = _soft_clip_sizes(batch, i)
        o = int(batch.seq_offsets[i])
        L = int(batch.seq_offsets[i + 1] - o)
        _mask_low_front(quals, o, L, front, max_quality)
        _mask_low_back(quals, o, L, back, max_quality)


def mask_low_quality_soft_clipped_boundary_bases(batch: ReadBatch, quals: np.ndarray,
                                                 num_bases: int, max_quality: int) -> None:
    for i in _clipped_rows(batch):
        front, back = _soft_clip_sizes(batch, i)
        o = int(batch.seq_offsets[i])
        L = int(batch.seq_offsets[i + 1] - o)
        if front:
            _mask_low_front(quals, o, L, front + num_bases, max_quality)
        if back:
            _mask_low_back(quals, o, L, back + num_bases, max_quality)


def mask_low_average_quality_soft_clipped_tails(batch: ReadBatch, quals: np.ndarray,
                                                threshold: int,
                                                min_tail_length: int) -> None:
    rev = batch.is_reverse()
    for i in _clipped_rows(batch):
        front, back = _soft_clip_sizes(batch, i)
        tail = front if rev[i] else back
        if tail < min_tail_length:
            continue
        o = int(batch.seq_offsets[i])
        L = int(batch.seq_offsets[i + 1] - o)
        seg = quals[o:o + tail] if rev[i] else quals[o + L - tail:o + L]
        if seg.size and seg.mean() < threshold:
            seg[:] = 0


def _search(haystack: np.ndarray, needle: np.ndarray) -> int:
    if len(needle) == 0 or len(needle) > len(haystack):
        return -1
    return bytes(haystack).find(bytes(needle))


def _match_run(a: np.ndarray, b: np.ndarray) -> int:
    n = min(len(a), len(b))
    if n == 0:
        return 0
    neq = np.flatnonzero(a[:n] != b[:n])
    return int(neq[0]) if len(neq) else n


def mask_inverted_soft_clipped_read_ends(batch: ReadBatch, quals: np.ndarray,
                                         reference, contig: str,
                                         min_clip_length: int = 10,
                                         max_flank_search: int = 100) -> None:
    """Zero clipped head/tail (plus any inverted aligned extension) when the
    clip matches the local reference reverse-complemented
    (MaskInvertedSoftClippedReadEnds, read_transform.cpp:286-338)."""
    rev = batch.is_reverse()
    for i in _clipped_rows(batch):
        front, back = _soft_clip_sizes(batch, i)
        head = front if not rev[i] else back
        tail = back if not rev[i] else front
        o = int(batch.seq_offsets[i])
        L = int(batch.seq_offsets[i + 1] - o)
        seq = batch.seq[o:o + L]
        lo = max(int(batch.begins[i]) - max_flank_search, 0)
        hi = int(batch.ends[i]) + max_flank_search
        target = reference.fetch_codes(contig, lo, hi)
        if head >= min_clip_length:
            clip = seq[:head] if not rev[i] else seq[L - head:]
            query = _COMPLEMENT[clip][::-1]
            if _search(target, query) >= 0:
                if not rev[i]:
                    _zero_front(quals, o, L, head)
                else:
                    _zero_back(quals, o, L, head)
        if tail >= min_clip_length:
            clip = seq[L - tail:] if not rev[i] else seq[:tail]
            query = _COMPLEMENT[clip][::-1]
            if _search(target, query) >= 0:
                if not rev[i]:
                    _zero_back(quals, o, L, tail)
                else:
                    _zero_front(quals, o, L, tail)


def mask_3prime_shifted_soft_clipped_heads(batch: ReadBatch, quals: np.ndarray,
                                           reference, contig: str,
                                           min_clip_length: int = 10,
                                           max_flank_search: int = 500) -> None:
    """Zero clipped heads (plus shifted aligned extension) that re-occur in
    the 3'-flank reference context (Mask3PrimeShiftedSoftClippedHeads)."""
    rev = batch.is_reverse()
    for i in _clipped_rows(batch):
        front, back = _soft_clip_sizes(batch, i)
        head = front if not rev[i] else back
        if head < min_clip_length:
            continue
        o = int(batch.seq_offsets[i])
        L = int(batch.seq_offsets[i + 1] - o)
        seq = batch.seq[o:o + L]
        if not rev[i]:
            lo, hi = int(batch.begins[i]), int(batch.ends[i]) + max_flank_search
            clip = seq[:head]
        else:
            lo = max(int(batch.begins[i]) - max_flank_search, 0)
            hi = int(batch.ends[i])
            clip = seq[L - head:]
        context = reference.fetch_codes(contig, lo, hi)
        pos = _search(context, clip)
        if pos < 0:
            continue
        if not rev[i]:
            ext = _match_run(seq[head:], context[pos + head:])
            _zero_front(quals, o, L, head + ext)
        else:
            aligned = seq[:L - head][::-1]
            ctx = context[:pos][::-1]
            ext = _match_run(aligned, ctx)
            _zero_back(quals, o, L, head + ext)


def clear_annotations(batch: ReadBatch, quals: np.ndarray) -> None:
    """ClearAnnotations: drop retained aux/tag data."""
    if getattr(batch, "aux", None) is not None:
        batch.aux = None
        batch.aux_offsets = None


# -- template (read-pair) transforms ----------------------------------------

def _paired_rows(batch: ReadBatch):
    """(fwd_idx, rev_idx) index arrays of FR mate pairs matched by name."""
    if batch.name_hashes is None:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    order = np.argsort(batch.name_hashes, kind="stable")
    h = batch.name_hashes[order]
    rev = batch.is_reverse()
    fwd_rows, rev_rows = [], []
    k = 0
    while k + 1 < len(order):
        if h[k] == h[k + 1] and (k + 2 >= len(order) or h[k + 2] != h[k]):
            a, b = int(order[k]), int(order[k + 1])
            if rev[a] != rev[b]:
                f, r = (a, b) if not rev[a] else (b, a)
                fwd_rows.append(f)
                rev_rows.append(r)
            k += 2
        else:
            k += 1
    return np.asarray(fwd_rows, np.int64), np.asarray(rev_rows, np.int64)


def mask_template_adapters(batch: ReadBatch, quals: np.ndarray) -> None:
    """Zero overhangs past the mate on both template ends
    (MaskTemplateAdapters, read_transform.cpp:395-426)."""
    fwd_rows, rev_rows = _paired_rows(batch)
    for f, r in zip(fwd_rows, rev_rows):
        fo, fL = int(batch.seq_offsets[f]), int(batch.seq_offsets[f + 1] - batch.seq_offsets[f])
        ro, rL = int(batch.seq_offsets[r]), int(batch.seq_offsets[r + 1] - batch.seq_offsets[r])
        if batch.begins[r] < batch.begins[f]:
            _zero_front(quals, ro, rL, int(batch.begins[f] - batch.begins[r]))
        if batch.ends[r] < batch.ends[f]:
            _zero_back(quals, fo, fL, int(batch.ends[f] - batch.ends[r]))


def mask_strand_of_duplicated_bases(batch: ReadBatch, quals: np.ndarray) -> None:
    """Zero ONE strand of template-duplicated (mate-overlapped) bases
    (MaskStrandOfDuplicatedBases): the reverse read keeps its 3' context, the
    duplicated overlap is masked on the reverse read's 5' side."""
    fwd_rows, rev_rows = _paired_rows(batch)
    for f, r in zip(fwd_rows, rev_rows):
        lo = max(int(batch.begins[f]), int(batch.begins[r]))
        hi = min(int(batch.ends[f]), int(batch.ends[r]))
        if hi <= lo:
            continue
        ro = int(batch.seq_offsets[r])
        rL = int(batch.seq_offsets[r + 1] - batch.seq_offsets[r])
        skip = max(int(batch.begins[f]) - int(batch.begins[r]), 0)
        quals[ro + min(skip, rL):ro + min(skip + (hi - lo), rL)] = 0


def mask_clipped_duplicated_bases(batch: ReadBatch, quals: np.ndarray) -> None:
    """Zero soft-clipped bases duplicated on both segments of a template
    (MaskClippedDuplicatedBases)."""
    fwd_rows, rev_rows = _paired_rows(batch)
    for f, r in zip(fwd_rows, rev_rows):
        ff, fb = _soft_clip_sizes(batch, f)
        rf, rb = _soft_clip_sizes(batch, r)
        if not ((ff or fb) and (rf or rb)):
            continue
        lo = max(int(batch.begins[f]), int(batch.begins[r]))
        hi = min(int(batch.ends[f]), int(batch.ends[r]))
        if hi <= lo:
            continue
        for i, front, back in ((f, ff, fb), (r, rf, rb)):
            o = int(batch.seq_offsets[i])
            L = int(batch.seq_offsets[i + 1] - o)
            if front and int(batch.begins[i]) >= lo:
                _zero_front(quals, o, L, min(front, rf if i == f else ff))
            if back and int(batch.ends[i]) <= hi:
                _zero_back(quals, o, L, min(back, rb if i == f else fb))


def split_long_reads(batch: ReadBatch, max_length: int) -> ReadBatch:
    """--split-long-reads: reads longer than max_length become several
    linked fragments instead of being filtered (cli.md:504-510; fragments
    share the read's name hash, so AlignedTemplate linkage re-joins their
    likelihoods under --read-linkage LINKED)."""
    lens = batch.lengths()
    long_idx = np.flatnonzero(lens > max_length)
    if len(long_idx) == 0:
        return batch
    if batch.name_hashes is None:
        # fragments must stay linkable: synthesise one hash per source read
        batch.name_hashes = np.arange(1, len(batch) + 1, dtype=np.uint64)
    keep = batch.take(np.flatnonzero(lens <= max_length))
    READ_OPS = {cg.M, cg.I, cg.S, cg.EQ, cg.X}
    REF_OPS = {cg.M, cg.D, cg.NSKIP, cg.EQ, cg.X}
    frags = []   # rows of (begin, cigar_ops, seq, quals) + per-read carry
    for i in long_idx.tolist():
        seq = batch.sequence(i)
        quals = batch.qualities(i)
        cigar = [(int(l), int(op)) for l, op in batch.cigar(i)]
        ref_pos = int(batch.begins[i])
        read_pos = 0
        ci = 0
        cur_len = None   # remaining length of the op being consumed
        while ci < len(cigar):
            # start a fragment at the current (ref, read) position,
            # skipping leading ref-only ops
            while ci < len(cigar) and cigar[ci][1] not in READ_OPS:
                if cigar[ci][1] in REF_OPS:
                    ref_pos += cigar[ci][0] if cur_len is None else cur_len
                cur_len = None
                ci += 1
            if ci >= len(cigar):
                break
            frag_begin = ref_pos
            frag_read0 = read_pos
            frag_ops: list[tuple[int, int]] = []
            taken = 0
            while ci < len(cigar) and taken < max_length:
                length, op = cigar[ci]
                if cur_len is not None:
                    length = cur_len
                if op in READ_OPS:
                    use = min(length, max_length - taken)
                    frag_ops.append((use, op))
                    taken += use
                    read_pos += use
                    if op in REF_OPS:
                        ref_pos += use
                    if use < length:
                        cur_len = length - use
                        break
                else:
                    # ref-only op inside a fragment
                    frag_ops.append((length, op))
                    if op in REF_OPS:
                        ref_pos += length
                cur_len = None
                ci += 1
            # drop a trailing ref-only op (it belongs between fragments)
            while frag_ops and frag_ops[-1][1] not in READ_OPS:
                last = frag_ops.pop()
                if last[1] in REF_OPS:
                    pass   # ref_pos already advanced; next fragment starts after it
            if not frag_ops:
                continue
            frags.append((i, frag_begin,
                          np.asarray(frag_ops, np.int32),
                          seq[frag_read0:frag_read0 + taken].copy(),
                          quals[frag_read0:frag_read0 + taken].copy()))
    if not frags:
        return keep
    n = len(frags)
    seq_offsets = np.zeros(n + 1, np.int64)
    cig_offsets = np.zeros(n + 1, np.int64)
    np.cumsum([len(f[3]) for f in frags], out=seq_offsets[1:])
    np.cumsum([len(f[2]) for f in frags], out=cig_offsets[1:])
    src = np.asarray([f[0] for f in frags])
    begins = np.asarray([f[1] for f in frags], np.int64)
    cigar_ops = np.concatenate([f[2] for f in frags])
    ref_span = np.asarray([int(np.sum(np.where(
        np.isin(f[2][:, 1], (cg.M, cg.D, cg.NSKIP, cg.EQ, cg.X)),
        f[2][:, 0], 0))) for f in frags], np.int64)
    frag_batch = ReadBatch(
        contig=batch.contig,
        begins=begins,
        ends=begins + ref_span,
        mapq=batch.mapq[src],
        flags=batch.flags[src],
        seq=np.concatenate([f[3] for f in frags]),
        quals=np.concatenate([f[4] for f in frags]),
        seq_offsets=seq_offsets,
        cigar_ops=cigar_ops,
        cigar_offsets=cig_offsets,
        mate_begins=None if batch.mate_begins is None else batch.mate_begins[src],
        mate_same_contig=(None if batch.mate_same_contig is None
                          else batch.mate_same_contig[src]),
        template_lengths=(None if batch.template_lengths is None
                          else batch.template_lengths[src]),
        names=None if batch.names is None else [batch.names[k] for k in src],
        name_hashes=(None if batch.name_hashes is None
                     else batch.name_hashes[src]),
    )
    if len(keep) == 0:
        return frag_batch.sorted_by_begin()
    # optional columns must agree for concatenate; drop aux on the kept side
    keep.aux = keep.aux_offsets = None
    return ReadBatch.concatenate([keep, frag_batch]).sorted_by_begin()


__all__ = [
    "split_long_reads",
    "capitalise_bases", "cap_base_qualities", "mask_overlapped_segment",
    "mask_adapters", "mask_tail", "mask_low_quality_tails",
    "mask_soft_clipped", "mask_soft_clipped_boundary_bases",
    "mask_low_quality_soft_clipped_bases",
    "mask_low_quality_soft_clipped_boundary_bases",
    "mask_low_average_quality_soft_clipped_tails",
    "mask_inverted_soft_clipped_read_ends",
    "mask_3prime_shifted_soft_clipped_heads",
    "clear_annotations", "mask_template_adapters",
    "mask_strand_of_duplicated_bases", "mask_clipped_duplicated_bases",
]
