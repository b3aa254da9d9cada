"""Standalone call-set-refinement pass (--filter-vcf).

Capability-equivalent to the reference's filter-request mode
(octopus.cpp:1432-1471 run_csr with --filter-vcf): annotate and re-filter an
existing VCF against the read data without re-calling.  Per-sample genotypes
are reconstructed for ALL samples and ALL ALTs from each record (the
reference's genotype_reader.cpp path, driven via facet_factory.hpp:28-79),
and facet blocks are grouped by phase set so the support/bias measures see
the same per-carrier evaluation as the inline CSR pass. Their lazy read
assignment scores on --device with the run's host-DP gate
(config.options.scoring_config), as the inline pass's does.
"""

from __future__ import annotations

import sys

import numpy as np

from .basics.reads import ReadBatch
from .basics.sequence import encode_sequence
from .core.callers.base import SiteCall
from .core.csr.measures import compute_measures
from .core.csr.threshold import ThresholdFilter
from .core.types.variants import Variant
from .io.fasta import IndexedFasta, ReferenceGenome
from .io.read_manager import ReadManager
from .io.vcf import VcfReader, VcfWriter
from .readpipe.buffered import BufferedReadPipe
from .readpipe.pipe import ReadPipe


def run_filter_vcf(args) -> int:
    from .config.options import scoring_config
    scoring = scoring_config(args)
    reference = ReferenceGenome(IndexedFasta(args.reference))
    manager = ReadManager(args.reads, reference=reference)
    reader = VcfReader(args.filter_vcf)
    header = reader.header
    samples = list(header.samples) or ["unknown"]
    threshold = ThresholdFilter(args.filter_expression) if args.filter_expression \
        else ThresholdFilter()
    forest = None
    if getattr(args, "forest_model", None):
        from .core.csr.random_forest import ForestCsr
        forest = ForestCsr(
            args.forest_model, getattr(args, "somatic_forest_model", None),
            getattr(args, "min_forest_quality", 3.0),
            use_somatic_forest_for_refcalls=not getattr(
                args, "use_germline_forest_for_somatic_normals", False))
        if not any(f.get("ID") == "RF" for f in header.filters):
            header.add_filter("RF", "Random forest filtered")
        header.add_format("RFGQ", "1", "Float", "Random forest call quality")
    for fid in threshold.filter_ids():
        if not any(f.get("ID") == fid for f in header.filters):
            header.add_filter(fid, f"Threshold filter {fid}")
    annotations = tuple(getattr(args, "annotations", ()) or ())
    if "all" in annotations:
        from .core.csr.measures import ALL_MEASURES
        annotations = tuple(ALL_MEASURES)
    for name in annotations:
        if not any(i.get("ID") == name for i in header.infos):
            header.add_info(name, ".", "String", f"CSR measure {name}")
    writer = VcfWriter(args.output, header)
    # buffered pipe with call-region hints (octopus.cpp:1446-1453 run_csr).
    # The reference filters with ALL well-formed reads by default
    # (cli.md:1543-1549); --use-preprocessed-reads-for-filtering opts into
    # the calling pipeline's preprocessed set — match the inline pass.
    if getattr(args, "use_preprocessed_reads_for_filtering", False):
        from .config.options import collate
        pipe = ReadPipe(collate(args).read_pipe)
    else:
        pipe = _RawPipe()
    buffered = BufferedReadPipe(manager, pipe, max_fetch_size=200_000)
    records = list(reader)
    buffered.hint([(r.chrom, max(r.pos - 501, 0), r.pos + 500)
                   for r in records])
    n = 0
    for block in _phase_blocks(records):
        calls = [_record_to_call(r) for r in block]
        bundle, per_sample, merged, span = _block_facets(
            block, calls, buffered, samples, reference, scoring)
        for rec, call in zip(block, calls):
            # symbolic-ALT records (<DEL>, breakends...) have no literal
            # allele sequence to score against reads; re-classifying them
            # from ref-allele pileups would mislabel every one (AF=1) —
            # pass through with their original FILTER
            if rec.alts and all(a.startswith("<") and a != "<NON_REF>"
                                for a in rec.alts):
                writer.write(rec)
                n += 1
                continue
            pln = rec.info.get("PLN")
            ref_lo = max(call.begin - 120, 0)
            ref_hi = min(call.end + 120, reference.contig_size(rec.chrom))
            measures = compute_measures(
                call, merged, facets=bundle,
                ref_codes=reference.fetch_codes(rec.chrom, ref_lo, ref_hi),
                ref_begin=ref_lo,
                reads_by_sample=per_sample,
                phase_length=int(pln) if pln else span)
            somatic = bool(rec.info.get("SOMATIC"))
            # refcall records: no real ALT (is_refcall.cpp semantics)
            refcall = not rec.alts or all(a in (".", "<NON_REF>")
                                          for a in rec.alts)
            failed = threshold.classify(measures, somatic=somatic,
                                        refcall=refcall)
            if forest is not None:
                rf_fails, rfgq = forest.classify_q(measures, somatic=somatic,
                                                   refcall=refcall)
                failed.extend(rf_fails)
                for sv in rec.sample_values:
                    sv["RFGQ"] = round(float(rfgq), 2)
                if "RFGQ" not in rec.format_keys:
                    rec.format_keys.append("RFGQ")
            rec.filters = failed if failed else ["PASS"]
            for name in annotations:
                if name in measures and name not in rec.info:
                    v = measures[name]
                    if v is None:
                        rec.info[name] = "."   # missing measure (VCF spec)
                    else:
                        rec.info[name] = round(v, 4) if isinstance(v, float) else v
            writer.write(rec)
            n += 1
    writer.close()
    print(f"octopus-tpu-torch: filtered {n} records", file=sys.stderr)
    return 0


class _RawPipe:
    """Identity pipe: the facet read set is the raw well-formed fetch, as
    the inline pass's raw_by_sample (run.py) and the reference's default."""

    def process(self, batch):
        return batch, None


def _phase_blocks(records):
    """Group records into facet blocks by phase set (chrom + PS), matching
    the inline pass's per-phase-set FacetBlock grouping (run.py
    _make_facet_bundles); records without PS are their own block."""
    block: list = []
    key = None
    for rec in records:
        ps = None
        for sv in rec.sample_values:
            if sv.get("PS") not in (None, "."):
                ps = sv["PS"]
                break
        this = (rec.chrom, ps) if ps is not None else None
        if block and (this is None or this != key):
            yield block
            block = []
        block.append(rec)
        key = this
        if this is None:
            yield block
            block = []
    if block:
        yield block


def _block_facets(block, calls, buffered, samples, reference, scoring):
    """Reconstruct the inline pass's FacetBlock from VCF records: ALL
    samples (reads fetched per sample), ALL ALTs (site_alts), per-sample
    genotypes as allele indices (genotype_reader.cpp equivalent). `scoring`
    is the run's LikelihoodConfig, which the block's read assignment uses."""
    contig = block[0].chrom
    begin = min(c.begin for c in calls)
    end = max(max(c.end, c.begin + 1) for c in calls)
    span = end - begin
    got = buffered.fetch(contig, max(begin - 500, 0), end + 500)
    per_sample = [got.get(s) if got.get(s) is not None
                  else ReadBatch.empty(contig) for s in samples]
    if all(len(b) == 0 for b in per_sample) and got:
        if len(samples) == 1:
            # single-sample VCF whose column name differs from the BAM's
            # @RG sample: pool (name mismatch, but unambiguous)
            parts = [b for b in got.values() if len(b)]
            if parts:
                per_sample = [ReadBatch.concatenate(parts).sorted_by_begin()]
    merged = (ReadBatch.concatenate([b for b in per_sample if len(b)])
              .sorted_by_begin()
              if any(len(b) for b in per_sample) else ReadBatch.empty(contig))
    if not len(merged):
        return None, per_sample, merged, span
    sites = [c for c in calls if c.alts]
    variants = [c.alts[0] for c in sites]
    site_alts = [list(c.alts) for c in sites]
    ploidy = 2
    for c in sites:
        for gt in c.genotypes:
            ploidy = max(ploidy, len(gt))
    genotypes = []
    for s in range(len(samples)):
        genotypes.append([
            (c.genotypes[s] if s < len(c.genotypes) else [0] * ploidy)
            for c in sites])
    from .core.csr.facets import FacetBlock, FacetBundle
    bundle = FacetBundle(FacetBlock(
        contig=contig, begin=begin, end=end,
        variants=variants, genotypes=genotypes,
        reads_by_sample=per_sample, samples=list(samples),
        reference=reference, ploidy=ploidy, site_alts=site_alts,
        scoring=scoring))
    return bundle, per_sample, merged, span


def _record_to_call(rec) -> SiteCall:
    pos0 = rec.pos - 1
    ref_codes = encode_sequence(rec.ref)
    alts = []
    for alt in rec.alts or ["."]:
        if alt in (".", "*") or alt.startswith("<"):
            alts.append(Variant.make(pos0, ref_codes, ref_codes))
            continue
        alt_codes = encode_sequence(alt)
        b = pos0
        r, a = ref_codes, alt_codes
        while len(r) and len(a) and r[0] == a[0] and (len(r) > 1 or len(a) > 1):
            r, a = r[1:], a[1:]
            b += 1
        alts.append(Variant.make(b, r, a))
    # per-sample genotypes as raw allele indices: index a > 0 selects the
    # record's ALT a (kept, NOT binarised — multi-allelic carriers must
    # evaluate their own allele; genotype_reader.cpp)
    gts, gqs = [], []
    for sv in rec.sample_values:
        gt_str = sv.get("GT", "./.").replace("|", "/")
        try:
            gt = [int(x) for x in gt_str.split("/") if x not in (".", "")]
        except ValueError:
            gt = []
        gts.append(gt or [0, 0])
        try:
            gqs.append(float(sv.get("GQ", 0) or 0))
        except (TypeError, ValueError):
            gqs.append(0.0)
    if not gts:
        gts, gqs = [[0, 0]], [0.0]
    info = dict(rec.info)
    for key in ("MP", "PP"):           # numeric INFO fields used in measures
        if key in info:
            try:
                info[key] = float(info[key])
            except (TypeError, ValueError):
                del info[key]
    mps = None
    if rec.sample_values:              # FORMAT MP (per-sample model posterior)
        try:
            mps = [float(sv["MP"]) for sv in rec.sample_values if "MP" in sv]
        except (TypeError, ValueError):
            mps = None
        if not mps:
            mps = None
    return SiteCall(
        begin=min(v.begin for v in alts),
        end=max(v.end for v in alts),
        alts=alts,
        quality=rec.qual if rec.qual is not None else 0.0,
        genotypes=gts,
        genotype_qualities=gqs,
        phase_set=pos0,
        alt_qualities=[rec.qual or 0.0] * len(alts),
        info=info,
        model_posteriors=mps,
    )


__all__ = ["run_filter_vcf"]
