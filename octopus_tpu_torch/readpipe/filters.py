"""Read filters — the full reference inventory
(src/readpipe/filtering/read_filter.hpp:61-330).

Each filter returns a boolean keep-mask over the batch.  Vectorised over
flag/length columns; tag- and SA-dependent filters parse the retained aux
bytes (BamFile.fetch(..., keep_aux=True)).
"""

from __future__ import annotations

import numpy as np

from ..basics import cigar as cg
from ..basics.reads import (
    FLAG_DUPLICATE,
    FLAG_MATE_UNMAPPED,
    FLAG_PAIRED,
    FLAG_PROPER_PAIR,
    FLAG_QC_FAIL,
    FLAG_SECONDARY,
    FLAG_SUPPLEMENTARY,
    FLAG_UNMAPPED,
    ReadBatch,
)


def is_mapped(batch: ReadBatch) -> np.ndarray:
    return (batch.flags & FLAG_UNMAPPED) == 0


def has_well_formed_cigar(batch: ReadBatch) -> np.ndarray:
    """Valid (query span == sequence length), minimal (no zero-length ops),
    not all clipped."""
    n = len(batch)
    lens = batch.lengths()
    n_ops = np.diff(batch.cigar_offsets)
    op_read = np.repeat(np.arange(n), n_ops)
    ops = batch.cigar_ops[:, 1]
    sizes = batch.cigar_ops[:, 0]
    qspans = np.zeros(n, np.int64)
    consumes = cg.CONSUMES_QUERY[ops]
    np.add.at(qspans, op_read, np.where(consumes, sizes, 0))
    minimal = np.ones(n, bool)
    np.logical_and.at(minimal, op_read, sizes > 0)
    non_clip = np.zeros(n, np.int64)
    np.add.at(non_clip, op_read, ((ops != cg.S) & (ops != cg.H)).astype(np.int64))
    return (qspans == lens) & (n_ops > 0) & minimal & (non_clip > 0)


def has_valid_base_qualities(batch: ReadBatch) -> np.ndarray:
    """Sequence and quality lengths always match in the SoA layout; reject
    reads whose qualities carry the 0xFF missing marker pattern only."""
    return np.ones(len(batch), bool)


def is_not_secondary_alignment(batch: ReadBatch) -> np.ndarray:
    return (batch.flags & FLAG_SECONDARY) == 0


def is_not_supplementary_alignment(batch: ReadBatch) -> np.ndarray:
    return (batch.flags & FLAG_SUPPLEMENTARY) == 0


def is_good_mapping_quality(batch: ReadBatch, min_mapping_quality: int) -> np.ndarray:
    return batch.mapq >= min_mapping_quality


def _good_base_counts(batch: ReadBatch, good_base_quality: int) -> np.ndarray:
    n = len(batch)
    read_of_base = np.repeat(np.arange(n), batch.lengths())
    good = np.zeros(n, np.int64)
    np.add.at(good, read_of_base, (batch.quals >= good_base_quality).astype(np.int64))
    return good


def has_sufficient_good_quality_bases(batch: ReadBatch, good_base_quality: int,
                                      min_good_bases: int) -> np.ndarray:
    return _good_base_counts(batch, good_base_quality) >= min_good_bases


def has_sufficient_good_base_fraction(batch: ReadBatch, good_base_quality: int,
                                      min_good_base_fraction: float) -> np.ndarray:
    lens = np.maximum(batch.lengths(), 1)
    return _good_base_counts(batch, good_base_quality) / lens >= min_good_base_fraction


def is_not_chimeric(batch: ReadBatch) -> np.ndarray:
    return (batch.flags & FLAG_PAIRED) == 0


def is_next_segment_mapped(batch: ReadBatch) -> np.ndarray:
    unpaired = (batch.flags & FLAG_PAIRED) == 0
    return unpaired | ((batch.flags & FLAG_MATE_UNMAPPED) == 0)


def is_not_marked_duplicate(batch: ReadBatch) -> np.ndarray:
    return (batch.flags & FLAG_DUPLICATE) == 0


def is_not_marked_qc_fail(batch: ReadBatch) -> np.ndarray:
    return (batch.flags & FLAG_QC_FAIL) == 0


def is_short(batch: ReadBatch, max_length: int) -> np.ndarray:
    return batch.lengths() <= max_length


def is_long(batch: ReadBatch, min_length: int) -> np.ndarray:
    return batch.lengths() >= min_length


def is_not_contaminated(batch: ReadBatch) -> np.ndarray:
    """Passes unless the inferred template is shorter than the read span
    (read_filter.cpp:175-182)."""
    unpaired = (batch.flags & FLAG_PAIRED) == 0
    mate_unmapped = (batch.flags & FLAG_MATE_UNMAPPED) != 0
    if batch.template_lengths is None:
        return np.ones(len(batch), bool)
    tl = np.abs(batch.template_lengths.astype(np.int64))
    return unpaired | mate_unmapped | (tl > (batch.ends - batch.begins))


def is_proper_template(batch: ReadBatch) -> np.ndarray:
    unpaired = (batch.flags & FLAG_PAIRED) == 0
    return unpaired | ((batch.flags & FLAG_PROPER_PAIR) != 0)


def is_local_template(batch: ReadBatch) -> np.ndarray:
    unpaired = (batch.flags & FLAG_PAIRED) == 0
    if batch.mate_same_contig is None:
        return np.ones(len(batch), bool)
    return unpaired | batch.mate_same_contig


def _sa_entries(batch: ReadBatch, i: int) -> list[tuple[str, int, int]]:
    """(contig, pos, mapq) per SA-tag supplementary alignment."""
    sa = batch.tag(i, "SA")
    if not sa:
        return []
    out = []
    for part in str(sa).rstrip(";").split(";"):
        fields = part.split(",")
        if len(fields) >= 5:
            out.append((fields[0], int(fields[1]), int(fields[4])))
    return out


def _is_unlocalized(contig: str) -> bool:
    # e.g. GL000220.1 / chr1_KI270706v1_random: placed on no chromosome
    return contig.endswith("_random") or (
        not contig.startswith("chr") and contig.startswith(("GL", "KI", "JH")))


def _is_unplaced(contig: str) -> bool:
    return contig.startswith("chrUn") or "Un_" in contig


def _is_decoy(contig: str) -> bool:
    return "decoy" in contig or contig.endswith("_decoy") or contig == "hs37d5"


def _no_sa_matching(batch: ReadBatch, pred, min_mapping_quality) -> np.ndarray:
    keep = np.ones(len(batch), bool)
    if getattr(batch, "aux", None) is None:
        return keep
    for i in range(len(batch)):
        for contig, _pos, mq in _sa_entries(batch, i):
            if min_mapping_quality is not None and mq < min_mapping_quality:
                continue
            if pred(contig):
                keep[i] = False
                break
    return keep


def no_unlocalized_supplementary_alignments(batch: ReadBatch,
                                            min_mapping_quality: int | None = None) -> np.ndarray:
    return _no_sa_matching(batch, _is_unlocalized, min_mapping_quality)


def no_unplaced_supplementary_alignments(batch: ReadBatch,
                                         min_mapping_quality: int | None = None) -> np.ndarray:
    return _no_sa_matching(batch, _is_unplaced, min_mapping_quality)


def no_decoy_supplementary_alignments(batch: ReadBatch,
                                      min_mapping_quality: int | None = None) -> np.ndarray:
    return _no_sa_matching(batch, _is_decoy, min_mapping_quality)


def has_tag(batch: ReadBatch, tag: str, annotation: str | None = None) -> np.ndarray:
    out = np.zeros(len(batch), bool)
    if getattr(batch, "aux", None) is None:
        return out
    for i in range(len(batch)):
        v = batch.tag(i, tag)
        out[i] = v is not None and (annotation is None or str(v) == annotation)
    return out


def not_has_tag(batch: ReadBatch, tag: str, annotation: str | None = None) -> np.ndarray:
    out = np.ones(len(batch), bool)
    if getattr(batch, "aux", None) is None:
        return out
    for i in range(len(batch)):
        v = batch.tag(i, tag)
        if v is None:
            continue
        out[i] = annotation is not None and str(v) != annotation
    return out


def is_not_duplicate(batch: ReadBatch, candidate: np.ndarray | None = None) -> np.ndarray:
    """Context filter: among reads with identical (5' position, strand,
    cigar, mate begin), keep the highest base-quality sum
    (IsNotDuplicate, read_filter.hpp:330)."""
    n = len(batch)
    if candidate is None:
        candidate = np.ones(n, bool)
    keep = np.ones(n, bool)
    cand_idx = np.flatnonzero(candidate)
    if len(cand_idx) < 2:
        return keep
    is_rev = batch.is_reverse()
    five_prime = np.where(is_rev, batch.ends, batch.begins)
    mate = (batch.mate_begins if batch.mate_begins is not None
            else np.zeros(n, np.int64))
    # cheap vectorised pre-group on (5' position, strand, mate begin);
    # the exact (cigar-comparing) python pass only visits reads whose
    # pre-group actually collides — the large majority never do
    cols = np.stack([five_prime[cand_idx].astype(np.int64),
                     is_rev[cand_idx].astype(np.int64),
                     np.asarray(mate)[cand_idx].astype(np.int64)], axis=1)
    _, inverse, counts = np.unique(cols, axis=0, return_inverse=True,
                                   return_counts=True)
    collided = cand_idx[counts[inverse] > 1]
    if not len(collided):
        return keep
    quals64 = batch.quals.astype(np.int64)
    keys = {}
    for i in collided:
        i = int(i)
        s0, s1 = batch.seq_offsets[i], batch.seq_offsets[i + 1]
        key = (int(five_prime[i]), bool(is_rev[i]),
               batch.cigar(i).tobytes(), int(mate[i]))
        best = keys.get(key)
        # exact quality-sum ties keep the FIRST read in input order — the
        # reference's rule (read_filter.hpp:330 IsNotDuplicate). A round-5
        # probe showed this makes BAM- vs CRAM-sourced runs of identical
        # read content differ at 2/1679 records (CRAM decode re-orders
        # ties); content-based tie-breaks were tried and rejected — they
        # measurably shifted duplicate selection in tie-saturated data
        # (byte-max is also allele-biased), and the reference shares the
        # order sensitivity
        qsum = int(quals64[s0:s1].sum())
        if best is None:
            keys[key] = (i, qsum)
            continue
        if qsum > best[1]:
            keep[best[0]] = False
            keys[key] = (i, qsum)
        else:
            keep[i] = False
    return keep


__all__ = [
    "is_mapped", "has_well_formed_cigar", "has_valid_base_qualities",
    "is_not_secondary_alignment", "is_not_supplementary_alignment",
    "is_good_mapping_quality", "has_sufficient_good_quality_bases",
    "has_sufficient_good_base_fraction", "is_not_chimeric",
    "is_next_segment_mapped", "is_not_marked_duplicate",
    "is_not_marked_qc_fail", "is_short", "is_long", "is_not_contaminated",
    "is_proper_template", "is_local_template",
    "no_unlocalized_supplementary_alignments",
    "no_unplaced_supplementary_alignments",
    "no_decoy_supplementary_alignments", "has_tag", "not_has_tag",
    "is_not_duplicate",
]
