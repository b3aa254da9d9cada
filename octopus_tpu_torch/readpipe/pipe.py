"""Read preprocessing: prefilter transforms -> filters -> postfilter
transforms -> downsampling.

Capability-equivalent to the reference's ReadPipe
(src/readpipe/read_pipe.{hpp,cpp}); the chains are composed exactly as
option_collation.cpp make_read_transformers (:803-862) and
make_read_filterer (:903-1009) do, driven by the same option names.

Everything operates on ReadBatch columns; the only per-read python is in the
clip-aware transforms and duplicate grouping.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..basics.reads import ReadBatch
from . import filters as rf
from . import transforms as rt


@dataclass
class ReadPipeConfig:
    # transforms
    max_base_quality: int | None = None            # --max-base-quality
    mask_tails: int | None = None                  # --mask-tails
    mask_low_quality_tails: int | None = None      # --mask-low-quality-tails
    mask_soft_clipped_bases: bool = False          # soft-clip full masking
    mask_soft_clipped_boundary_bases: int = 2      # --mask-soft-clipped-boundary-bases
    soft_clip_mask_threshold: int | None = None    # --soft-clip-mask-threshold
    soft_clip_masking: bool = True                 # --disable-soft-clip-masking
    assembler_enabled: bool = False                # picks the low-quality clip chain
    adapter_masking: bool = True                   # --disable-adapter-masking
    overlap_masking: bool = True                   # --disable-overlap-masking
    mask_inverted_soft_clipping: bool = False      # --mask-inverted-soft-clipping
    mask_3prime_shifted_soft_clipped_heads: bool = False
    # filters
    consider_unmapped_reads: bool = False
    min_mapping_quality: int = 5
    good_base_quality: int = 20
    min_good_bases: int = 20
    min_good_base_fraction: float | None = None
    min_read_length: int | None = None
    max_read_length: int | None = None
    split_long_reads: bool = False       # --split-long-reads (cli.md:504-510)
    allow_marked_duplicates: bool = False
    allow_octopus_duplicates: bool = False
    duplicate_read_detection_policy: str = "relaxed"   # relaxed | aggressive
    allow_qc_fails: bool = False
    no_reads_with_tag: list[tuple[str, str | None]] = field(default_factory=list)
    allow_secondary: bool = False
    allow_supplementary: bool = False
    no_reads_with_unmapped_segments: bool = False
    no_reads_with_distant_segments: bool = False
    no_adapter_contaminated_reads: bool = False
    max_decoy_supplementary_mq: int | None = None
    max_unplaced_supplementary_mq: int | None = None
    max_unlocalized_supplementary_mq: int | None = None
    # downsampling
    downsample_above: int = 1000
    downsample_target: int = 500
    disable_downsampling: bool = False
    disable_preprocessing: bool = False
    # reference context for the inversion/shift masks
    reference: object | None = None


@dataclass
class ReadPipeReport:
    """Mirrors ReadPipe::Report (read_pipe.hpp:42-48)."""

    raw_depth: int = 0
    filtered_depth: int = 0
    downsampled_depth: int = 0
    n_raw: int = 0
    n_filtered: int = 0
    n_downsampled: int = 0


class ReadPipe:
    def __init__(self, config: ReadPipeConfig | None = None, seed: int = 42):
        self.config = config or ReadPipeConfig()
        self._rng = np.random.default_rng(seed)

    def process(self, batch: ReadBatch) -> tuple[ReadBatch, ReadPipeReport]:
        report = ReadPipeReport(n_raw=len(batch))
        if len(batch) == 0:
            return batch, report
        if (self.config.split_long_reads
                and self.config.max_read_length is not None):
            # --split-long-reads: fragment instead of filtering
            # (cli.md:504-510)
            batch = rt.split_long_reads(batch, self.config.max_read_length)
        if not self.config.disable_preprocessing:
            batch = self._prefilter_transform(batch)
        batch = batch.take(self._filter_mask(batch))
        report.n_filtered = len(batch)
        if not self.config.disable_preprocessing:
            batch = self._postfilter_transform(batch)
            batch = self._downsample(batch)
        report.n_downsampled = len(batch)
        return batch, report

    # -- transform chains (option_collation.cpp:803-862) --------------------

    def _prefilter_transform(self, batch: ReadBatch) -> ReadBatch:
        cfg = self.config
        quals = batch.quals.copy()
        rt.capitalise_bases(batch, quals)
        if cfg.max_base_quality is not None:
            rt.cap_base_qualities(batch, quals, cfg.max_base_quality)
        if cfg.mask_tails:
            rt.mask_tail(batch, quals, cfg.mask_tails)
        if cfg.mask_low_quality_tails is not None:
            rt.mask_low_quality_tails(batch, quals, cfg.mask_low_quality_tails)
        if cfg.soft_clip_masking:
            boundary = cfg.mask_soft_clipped_boundary_bases
            if boundary > 0:
                if cfg.soft_clip_mask_threshold is not None:
                    rt.mask_low_quality_soft_clipped_boundary_bases(
                        batch, quals, boundary, cfg.soft_clip_mask_threshold)
                elif cfg.assembler_enabled:
                    rt.mask_low_quality_soft_clipped_boundary_bases(batch, quals, boundary, 3)
                    rt.mask_low_average_quality_soft_clipped_tails(batch, quals, 10, 5)
                    rt.mask_clipped_duplicated_bases(batch, quals)
                else:
                    rt.mask_soft_clipped_boundary_bases(batch, quals, boundary)
            else:
                if cfg.soft_clip_mask_threshold is not None:
                    rt.mask_low_quality_soft_clipped_bases(batch, quals, cfg.soft_clip_mask_threshold)
                elif cfg.assembler_enabled:
                    rt.mask_low_quality_soft_clipped_bases(batch, quals, 3)
                    rt.mask_low_average_quality_soft_clipped_tails(batch, quals, 10, 5)
                    rt.mask_clipped_duplicated_bases(batch, quals)
                else:
                    rt.mask_soft_clipped(batch, quals)
        if cfg.adapter_masking:
            rt.mask_adapters(batch, quals)
        if cfg.mask_inverted_soft_clipping and cfg.reference is not None:
            rt.mask_inverted_soft_clipped_read_ends(batch, quals, cfg.reference,
                                                    batch.contig, 10, 500)
        if cfg.mask_3prime_shifted_soft_clipped_heads and cfg.reference is not None:
            rt.mask_3prime_shifted_soft_clipped_heads(batch, quals, cfg.reference,
                                                      batch.contig, 10, 500)
        batch.quals = quals
        return batch

    def _postfilter_transform(self, batch: ReadBatch) -> ReadBatch:
        cfg = self.config
        quals = batch.quals
        if cfg.adapter_masking:
            rt.mask_template_adapters(batch, quals)
        if cfg.overlap_masking:
            rt.mask_strand_of_duplicated_bases(batch, quals)
        rt.clear_annotations(batch, quals)
        return batch

    # -- filter chain (option_collation.cpp:903-1009) -----------------------

    def _filter_mask(self, batch: ReadBatch) -> np.ndarray:
        cfg = self.config
        # mandatory
        keep = rf.has_valid_base_qualities(batch)
        keep &= rf.has_well_formed_cigar(batch)
        if cfg.disable_preprocessing:
            return keep
        if not cfg.consider_unmapped_reads:
            keep &= rf.is_mapped(batch)
        if cfg.min_mapping_quality > 0:
            keep &= rf.is_good_mapping_quality(batch, cfg.min_mapping_quality)
        if cfg.good_base_quality > 0 and cfg.min_good_bases > 0:
            keep &= rf.has_sufficient_good_quality_bases(
                batch, cfg.good_base_quality, cfg.min_good_bases)
        if cfg.good_base_quality > 0 and cfg.min_good_base_fraction is not None:
            keep &= rf.has_sufficient_good_base_fraction(
                batch, cfg.good_base_quality, cfg.min_good_base_fraction)
        if cfg.min_read_length is not None:
            keep &= rf.is_long(batch, cfg.min_read_length)
        if cfg.max_read_length is not None:
            keep &= rf.is_short(batch, cfg.max_read_length)
        if not cfg.allow_marked_duplicates:
            keep &= rf.is_not_marked_duplicate(batch)
        if not cfg.allow_qc_fails:
            keep &= rf.is_not_marked_qc_fail(batch)
        for tag, annotation in cfg.no_reads_with_tag:
            keep &= rf.not_has_tag(batch, tag, annotation)
        if not cfg.allow_secondary:
            keep &= rf.is_not_secondary_alignment(batch)
        if not cfg.allow_supplementary:
            keep &= rf.is_not_supplementary_alignment(batch)
        if cfg.no_reads_with_unmapped_segments:
            keep &= rf.is_next_segment_mapped(batch)
            keep &= rf.is_proper_template(batch)
        if cfg.no_reads_with_distant_segments:
            keep &= rf.is_local_template(batch)
        if cfg.no_adapter_contaminated_reads:
            keep &= rf.is_not_contaminated(batch)
        keep &= rf.no_decoy_supplementary_alignments(batch, cfg.max_decoy_supplementary_mq)
        keep &= rf.no_unplaced_supplementary_alignments(batch, cfg.max_unplaced_supplementary_mq)
        keep &= rf.no_unlocalized_supplementary_alignments(batch, cfg.max_unlocalized_supplementary_mq)
        if not cfg.allow_octopus_duplicates:
            keep &= rf.is_not_duplicate(batch, keep)
        return keep

    # -- downsampling ------------------------------------------------------

    def _downsample(self, batch: ReadBatch) -> ReadBatch:
        """Coverage-targeted random downsampling (src/readpipe/downsampling):
        while any position exceeds `downsample_above`, remove random reads
        covering the deepest positions until max depth <= target."""
        cfg = self.config
        if cfg.disable_downsampling or len(batch) == 0:
            return batch
        lo = int(batch.begins.min())
        hi = int(batch.ends.max())
        cov = np.zeros(hi - lo + 1, np.int64)
        np.add.at(cov, batch.begins - lo, 1)
        np.add.at(cov, batch.ends - lo, -1)
        cov = np.cumsum(cov)
        if cov.max() <= cfg.downsample_above:
            return batch
        keep = np.ones(len(batch), bool)
        order = self._rng.permutation(len(batch))
        for i in order:
            peak = cov.max()
            if peak <= cfg.downsample_target:
                break
            b, e = int(batch.begins[i]) - lo, int(batch.ends[i]) - lo
            if cov[b:e].max() >= cfg.downsample_target:
                keep[i] = False
                cov[b:e] -= 1
        return batch.take(keep)


__all__ = ["ReadPipe", "ReadPipeConfig", "ReadPipeReport"]
