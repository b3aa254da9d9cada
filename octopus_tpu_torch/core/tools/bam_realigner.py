"""Evidence BAM output (--bamout).

Capability-equivalent to the reference's BamRealigner
(src/core/tools/bam_realigner.{hpp,cpp}, driven by octopus.cpp:1671-1708):
streams the final calls and the input reads, assigns reads to called
haplotypes, realigns them with the HMM traceback, annotates haplotype id
(HP), phase region (PS) and alignment likelihood (LK) tags as the
reference's realign_and_annotate does (bam_realigner.cpp:167-196), and
writes a coordinate-sorted BAM.
"""

from __future__ import annotations

import numpy as np

from ...basics.phred import LN10_DIV_10
from ...basics.reads import ReadBatch
from ...basics.sequence import encode_sequence
from ...io.bam_writer import BamWriter, build_bai, encode_tag
from ..types.haplotypes import Haplotype
from ..types.variants import Variant
from .read_assigner import (assign_reads, haplotype_penalties,
                            realign_read_to_haplotype)


def realign_region(
    batch: ReadBatch,
    haplotypes: list[Haplotype],
    genotype: list[int],
    hap_begin: int,
    scoring=None,
) -> tuple[ReadBatch, list[bytes], dict]:
    """Assign+realign one region's reads; no file I/O.

    Returns (realigned batch, per-read aux tag bytes, support counts).
    Reads keep input order; the caller sorts before writing. `scoring` is
    the run's LikelihoodConfig: assignment scores on its device with its
    host-DP gate."""
    assignment = assign_reads(batch, haplotypes, genotype, hap_begin,
                              scoring=scoring)
    unique_haps = sorted(set(genotype))
    new_begins = batch.begins.copy()
    new_cigars = []
    tags: list[bytes] = []
    penalties: dict[int, object] = {}     # per haplotype, made once
    for i in range(len(batch)):
        h = assignment.hap_of_read[i]
        if h >= 0:
            if h not in penalties:
                penalties[h] = haplotype_penalties(haplotypes[h])
            nb, cig = realign_read_to_haplotype(batch, i, haplotypes[h],
                                                penalties=penalties[h])
            new_begins[i] = nb
            new_cigars.append(cig)
            hp = str(int(h))
        else:
            new_cigars.append(batch.cigar(i))
            # ambiguous: all haplotype ids the read could support
            # (bam_realigner.cpp realign_and_annotate haplotype_ids)
            hp = ",".join(str(int(u)) for u in unique_haps)
        hap0 = haplotypes[unique_haps[0]]
        t = encode_tag("HP", hp)
        t += encode_tag("PS", f"{batch.contig}:{hap0.begin}-{hap0.begin + len(hap0.sequence)}")
        if assignment.log_likelihoods is not None:
            lk = abs(float(assignment.log_likelihoods[i])) / LN10_DIV_10
            t += encode_tag("LK", str(int(round(lk))))
        tags.append(t)
    cigar_offsets = np.zeros(len(batch) + 1, np.int64)
    np.cumsum([len(c) for c in new_cigars], out=cigar_offsets[1:])
    realigned = ReadBatch(
        contig=batch.contig,
        begins=new_begins,
        ends=new_begins + np.asarray(
            [int(c[(c[:, 1] != 1) & (c[:, 1] != 4) & (c[:, 1] != 5), 0].sum()) for c in new_cigars]),
        mapq=batch.mapq,
        flags=batch.flags,
        seq=batch.seq,
        quals=batch.quals,
        seq_offsets=batch.seq_offsets,
        cigar_ops=np.concatenate(new_cigars) if new_cigars else np.zeros((0, 2), np.int32),
        cigar_offsets=cigar_offsets,
        mate_begins=batch.mate_begins,
        mate_same_contig=batch.mate_same_contig,
        template_lengths=batch.template_lengths,
        names=batch.names,
        name_hashes=batch.name_hashes,
    )
    support = {int(h): len(idx) for h, idx in assignment.support.items()}
    return realigned, tags, support


def realign_evidence(
    batch: ReadBatch,
    haplotypes: list[Haplotype],
    genotype: list[int],
    hap_begin: int,
    out_path: str,
    ref_names: list[str],
    ref_lengths: list[int],
    sample: str = "SAMPLE",
    scoring=None,
) -> dict:
    """Assign+realign one region's reads and write the evidence BAM.

    Returns summary counts per haplotype."""
    realigned, tags, support = realign_region(batch, haplotypes, genotype,
                                              hap_begin, scoring)
    order = np.lexsort((realigned.ends, realigned.begins))
    realigned = realigned.take(order)
    tags = [tags[j] for j in order]
    with BamWriter(out_path, ref_names, ref_lengths, samples=[sample]) as w:
        w.write_batch(realigned, sample=sample, tags=tags)
    build_bai(out_path)
    return support


# -- the whole-run pass (octopus.cpp:1671-1708 run_bam_realign) -------------


def _phase_blocks(records: list, max_gap: int = 1000) -> list[list]:
    """Group one contig's records into realignment blocks.

    Records sharing a PS phase-set id always co-block; otherwise proximity
    (gap <= max_gap) merges adjacent records, approximating the reference's
    call-block batching (bam_realigner.cpp read_next_batch)."""
    blocks: list[list] = []
    ps_of_block: dict[str, int] = {}
    for rec in sorted(records, key=lambda r: r.pos):
        ps = None
        if rec.sample_values:
            ps = rec.sample_values[0].get("PS")
        if ps is not None and str(ps) in ps_of_block:
            blocks[ps_of_block[str(ps)]].append(rec)
            continue
        if blocks and rec.pos - 1 - max(r.pos - 1 + len(r.ref) for r in blocks[-1]) <= max_gap:
            blocks[-1].append(rec)
        else:
            blocks.append([rec])
        if ps is not None:
            ps_of_block[str(ps)] = len(blocks) - 1
    return blocks


def _gt_indices(rec, sample_idx: int) -> list[int] | None:
    sv = rec.sample_values[sample_idx] if sample_idx < len(rec.sample_values) else {}
    gt = sv.get("GT")
    if not gt or gt.startswith("."):
        return None
    try:
        return [int(x) for x in gt.replace("|", "/").split("/")]
    except ValueError:
        return None


def _block_haplotypes(block: list, sample_idx: int, contig: str, reference,
                      pad: int = 200):
    """(haplotypes, genotype list) for one sample over one block, rebuilt
    from the called GTs; None when the sample has no called alt here."""
    gts = [_gt_indices(r, sample_idx) for r in block]
    ploidy = max((len(g) for g in gts if g), default=0)
    if ploidy == 0 or not any(g and any(a > 0 for a in g) for g in gts):
        return None
    begin = max(0, min(r.pos - 1 for r in block) - pad)
    end = min(reference.contig_size(contig),
              max(r.pos - 1 + len(r.ref) for r in block) + pad)
    variants_by_hap: list[list[Variant]] = [[] for _ in range(ploidy)]
    for rec, gt in zip(block, gts):
        if gt is None:
            continue
        for k, allele in enumerate(gt[:ploidy]):
            if allele > 0 and allele <= len(rec.alts or []):
                alt = rec.alts[allele - 1]
                if alt in ("*", "<NON_REF>") or "<" in alt:
                    continue
                v = Variant.make(rec.pos - 1, encode_sequence(rec.ref),
                                 encode_sequence(alt))
                last = variants_by_hap[k][-1] if variants_by_hap[k] else None
                if last is not None and v.begin < last.end:
                    continue      # overlapping calls: keep the first
                variants_by_hap[k].append(v)
    def fetch(b, e):
        return reference.fetch_codes(contig, b, e)
    uniq: dict[tuple, int] = {}
    haplotypes: list[Haplotype] = []
    genotype: list[int] = []
    for k in range(ploidy):
        key = tuple((v.begin, v.ref, v.alt) for v in variants_by_hap[k])
        if key not in uniq:
            uniq[key] = len(haplotypes)
            haplotypes.append(Haplotype.build(begin, end, variants_by_hap[k],
                                              fetch))
        genotype.append(uniq[key])
    return haplotypes, genotype, begin, end


def run_bamout(vcf_path: str, reference, bams: list, samples: list[str],
               out_path: str, bamout_type: str = "MINI",
               scoring=None) -> dict:
    """Realign evidence for every called block of a finished run.

    bamout_type FULL also passes through reads outside call blocks
    unmodified (option --bamout-type, option_parser.cpp). `scoring` is the
    run's LikelihoodConfig, as realign_region's."""
    from ...io.vcf import VcfReader

    by_contig: dict[str, list] = {}
    for rec in VcfReader(vcf_path):
        if rec.alts and (not rec.filters or rec.filters == ["PASS"]):
            by_contig.setdefault(rec.chrom, []).append(rec)

    ref_names = list(reference.contig_names())
    ref_lengths = [reference.contig_size(c) for c in ref_names]
    n_realigned = n_passthrough = 0
    with BamWriter(out_path, ref_names, ref_lengths, samples=samples) as w:
        for contig in ref_names:
            records = by_contig.get(contig, [])
            if not records and bamout_type != "FULL":
                continue
            pieces: list[tuple[ReadBatch, list[bytes], str]] = []
            claimed: dict[str, set] = {s: set() for s in samples}
            for block in _phase_blocks(records):
                for si, sample in enumerate(samples):
                    built = _block_haplotypes(block, si, contig, reference)
                    if built is None:
                        continue
                    haplotypes, genotype, begin, end = built
                    for bam in bams:
                        got = bam.fetch(contig, begin, end, keep_names=True)
                        batch = got.get(sample)
                        if batch is None or not len(batch):
                            continue
                        # skip reads already realigned by an earlier block
                        keys = [(int(batch.begins[i]),
                                 batch.names[i] if batch.names is not None else i)
                                for i in range(len(batch))]
                        fresh = [i for i, key in enumerate(keys)
                                 if key not in claimed[sample]]
                        claimed[sample].update(keys[i] for i in fresh)
                        if not fresh:
                            continue
                        batch = batch.take(np.asarray(fresh))
                        realigned, tags, _ = realign_region(
                            batch, haplotypes, genotype, haplotypes[0].begin,
                            scoring)
                        pieces.append((realigned, tags, sample))
                        n_realigned += len(realigned)
            if bamout_type == "FULL":
                for bam in bams:
                    got = bam.fetch(contig, 0, reference.contig_size(contig),
                                    keep_names=True)
                    for sample, batch in got.items():
                        keys = [(int(batch.begins[i]),
                                 batch.names[i] if batch.names is not None else i)
                                for i in range(len(batch))]
                        rest = [i for i, key in enumerate(keys)
                                if key not in claimed.get(sample, set())]
                        if rest:
                            sub = batch.take(np.asarray(rest))
                            pieces.append((sub, [b""] * len(sub), sample))
                            n_passthrough += len(sub)
            # global coordinate order across pieces
            rows = []
            for pi, (batch, tags, sample) in enumerate(pieces):
                for i in range(len(batch)):
                    rows.append((int(batch.begins[i]), int(batch.ends[i]), pi, i))
            rows.sort()
            for _, _, pi, i in rows:
                batch, tags, sample = pieces[pi]
                one = batch.take(np.asarray([i]))
                w.write_batch(one, sample=sample, tags=[tags[i]])
    build_bai(out_path)
    return {"realigned": n_realigned, "passthrough": n_passthrough}


__all__ = ["realign_evidence", "realign_region", "run_bamout"]
