"""Composite candidate variant generation.

Capability-equivalent to the reference's VariantGenerator composite
(src/core/tools/vargen/variant_generator.{hpp,cpp}) aggregating CigarScanner,
LocalReassembler, RepeatScanner and VcfExtractor proposals with merge+dedup.

The CIGAR scanner and the reassembler run in one call of the host extension
a window (generate_candidates, its `vargen_native` phase), over every
sample's reads; the repeat scanner, the randomiser and the source VCF run
here and merge after it.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

from ..._build import NATIVE as _native
from ...basics.reads import ReadBatch
from ...utils import timers
from ..types.variants import Variant, left_align
from .assembler import AssemblerOptions
from .repeat_scanner import RepeatScanner, RepeatScannerOptions
from .cigar_scanner import ScannerOptions, included_by_caller
from .randomiser import Randomiser, RandomiserOptions

_log = logging.getLogger("octopus_tpu_torch")

# reference bases held left of the window's reads and bins for the left
# alignment of indels; one that runs past them finishes in Python
LEFT_CONTEXT = 4096


@dataclass
class VariantGeneratorConfig:
    scanner: ScannerOptions = field(default_factory=ScannerOptions)
    use_pileup_scanner: bool = True       # --disable-pileup-candidate-generator
    use_assembler: bool = False
    assembler: AssemblerOptions = field(default_factory=AssemblerOptions)
    use_repeat_scanner: bool = True
    repeat_scanner: RepeatScannerOptions = field(default_factory=RepeatScannerOptions)
    use_randomiser: bool = False          # test/stress candidate injection
    randomiser: RandomiserOptions = field(default_factory=RandomiserOptions)
    source_vcf: str | None = None         # --source-candidates
    min_source_quality: float | None = None   # --min-source-candidate-quality
    # --use-filtered-source-candidates: keep FILTER-failed source records
    # (vcf_extractor.hpp Options::extract_filtered; default drops them)
    use_filtered_source: bool = False
    max_variant_size: int = 2000


class VariantGenerator:
    def __init__(self, reference, contig: str,
                 config: VariantGeneratorConfig | None = None):
        self.reference = reference
        self.contig = contig
        self.config = config or VariantGeneratorConfig()
        self._repeat_scanner = (RepeatScanner(reference, contig, self.config.repeat_scanner)
                                if self.config.use_repeat_scanner else None)
        self._randomiser = (Randomiser(reference, contig, self.config.randomiser)
                            if self.config.use_randomiser else None)
        self._batches: list[tuple[int, ReadBatch]] = []

    def add_reads(self, sample: int, batch: ReadBatch) -> None:
        if self._randomiser is not None:
            self._randomiser.add_reads(sample, batch)
        self._batches.append((sample, batch))

    def generate(self, begin: int, end: int) -> list[Variant]:
        # all indels are left-aligned before dedup: generators observe the
        # same event at different anchors inside repeats (CIGAR placement vs
        # assembly alignment), and two representations of one haplotype must
        # not both reach the model (they would split posterior mass; the
        # reference dedups by haplotype sequence, haplotype.cpp operator==)
        fetch = lambda b, e: self.reference.fetch_codes(self.contig, b, e)

        def norm(v: Variant) -> Variant:
            return left_align(v, fetch) if v.is_indel() else v

        out: dict[Variant, None] = dict.fromkeys(self._native(begin, end, fetch))
        if self._repeat_scanner is not None:
            for sample, batch in self._batches:
                for v in self._repeat_scanner.generate(batch, begin, end):
                    out.setdefault(norm(v))
        if self._randomiser is not None:
            for v in self._randomiser.generate(begin, end):
                out.setdefault(norm(v))
        if self.config.source_vcf:
            for v in self._from_source_vcf(begin, end):
                out.setdefault(norm(v))
        return sorted(out, key=lambda v: (v.begin, v.end, v.alt))

    def _native(self, begin: int, end: int, fetch) -> list[Variant]:
        """The CIGAR scanner's and the reassembler's candidates, in one call
        of the host extension: distinct, indels left-aligned."""
        cfg = self.config
        batches = [(s, b) for s, b in self._batches if len(b)]
        if not batches or not (cfg.use_pileup_scanner or cfg.use_assembler):
            return []
        pad = max(cfg.assembler.kmer_sizes) if cfg.use_assembler else 0
        lo = max(min(begin - pad, *(int(b.begins.min()) for _, b in batches))
                 - LEFT_CONTEXT, 0)
        size = self.reference.contig_size(self.contig)
        hi = min(max(end + pad, *(int(b.ends.max()) for _, b in batches)), size)
        reads = [(s, np.ascontiguousarray(b.begins, np.int64),
                  np.ascontiguousarray(b.ends, np.int64),
                  np.ascontiguousarray(b.mapq, np.uint8),
                  np.ascontiguousarray(b.flags, np.uint16),
                  np.ascontiguousarray(b.seq, np.uint8),
                  np.ascontiguousarray(b.quals, np.uint8),
                  np.ascontiguousarray(b.seq_offsets, np.int64),
                  np.ascontiguousarray(b.cigar_ops, np.int32),
                  np.ascontiguousarray(b.cigar_offsets, np.int64))
                 for s, b in batches]
        assembler = (cfg.assembler.native_args(
            max(cfg.max_variant_size, cfg.assembler.max_variant_size))
            if cfg.use_assembler else None)
        with timers.phase("vargen_native"):
            (records, seqs), groups, group_seqs, rows, quals, suppressed = (
                _native.generate_candidates(
                    np.ascontiguousarray(self.reference.fetch_codes(self.contig, lo, hi)),
                    lo, size, reads, begin, end,
                    cfg.scanner.native_args(cfg.use_pileup_scanner), assembler))
        out = []
        off = 0
        for b, e, n_ref, n_alt, edge in (
                np.frombuffer(records, np.int64).reshape(-1, 5).tolist()):
            v = Variant(b, e, seqs[off:off + n_ref], seqs[off + n_ref:off + n_ref + n_alt])
            off += n_ref + n_alt
            out.append(left_align(v, fetch) if edge else v)
        if groups:
            out.extend(left_align(v, fetch) if v.is_indel() else v
                       for v in included_by_caller(groups, group_seqs, rows, quals,
                                                   cfg.scanner))
        for i, n_dense, n in np.frombuffer(suppressed, np.int64).reshape(-1, 3).tolist():
            # most reads of a whole region disagree with the reference:
            # assembling every bin would manufacture noise bubbles
            _log.warning(
                "assembler: %d/%d reads of sample %d in %s:%d-%d are "
                "mismatch-dense against the reference — suppressing the "
                "clustered assembly trigger (wrong reference or unalignable "
                "region?)", n_dense, n, batches[i][0], self.contig, begin, end)
        return out

    def _from_source_vcf(self, begin: int, end: int) -> list[Variant]:
        """VcfExtractor equivalent (--source-candidates)."""
        from ...io.vcf import VcfReader
        from ...basics.sequence import encode_sequence
        out = []
        for rec in VcfReader(self.config.source_vcf):
            if rec.chrom != self.contig:
                continue
            if (not self.config.use_filtered_source
                    and rec.filters and rec.filters not in (["PASS"], ["."])):
                continue
            if (self.config.min_source_quality is not None
                    and (rec.qual is None or rec.qual < self.config.min_source_quality)):
                continue
            pos0 = rec.pos - 1
            if pos0 >= end or pos0 + len(rec.ref) <= begin:
                continue
            for alt in rec.alts:
                if alt.startswith("<") or alt == "*":
                    continue
                ref_codes = encode_sequence(rec.ref)
                alt_codes = encode_sequence(alt)
                # trim shared prefix (VCF anchors)
                b = pos0
                while len(ref_codes) and len(alt_codes) and ref_codes[0] == alt_codes[0] \
                        and (len(ref_codes) > 1 or len(alt_codes) > 1):
                    ref_codes, alt_codes = ref_codes[1:], alt_codes[1:]
                    b += 1
                out.append(Variant.make(b, ref_codes, alt_codes))
        return out

    def clear(self) -> None:
        self._batches.clear()


__all__ = ["VariantGenerator", "VariantGeneratorConfig"]
