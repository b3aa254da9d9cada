"""Two-stage option system: declaration + collation.

Capability-equivalent to the reference's option_parser.cpp (~170 flags in
groups, --config file layering, --fast/--very-fast presets) and
option_collation.cpp (flat options -> constructed components).  Flag names,
groups, and defaults follow the reference CLI (src/config/option_parser.cpp,
website/docs/cli.md) so users can carry commands across.

A handful of reference options have no backend; they are declared (so
command lines parse) and refused at collation (`check_rejected`). Options
whose semantics the design satisfies by construction (e.g.
--use-wide-hmm-scores: the kernels always carry 32-bit scores) are accepted
silently.

`--device` picks where the pair-HMM, the genotype reductions and the VB
engines run (the port's counterpart of JAX_PLATFORMS for the reference CLI);
the host-DP gate of the likelihood array comes from OCTOPUS_TPU_HOST_HMM_MAX,
and the VB size gate from OCTOPUS_TPU_VB_DEVICE_MIN, when the user sets
them.
"""

from __future__ import annotations

import argparse
import os
import shlex
import sys
from dataclasses import dataclass

from ..core.callers.base import BaseCallerConfig
from ..core.likelihood.likelihood_array import LikelihoodConfig
from ..core.vargen.assembler import AssemblerOptions
from ..core.vargen.cigar_scanner import ScannerOptions
from ..readpipe.pipe import ReadPipeConfig


def _mem(text: str) -> int:
    """'500MB' / '6GB' -> bytes (reference MemoryFootprint parsing)."""
    t = text.strip().upper().replace(" ", "")
    for suffix, mult in (("GB", 1 << 30), ("G", 1 << 30), ("MB", 1 << 20),
                         ("M", 1 << 20), ("KB", 1 << 10), ("K", 1 << 10),
                         ("B", 1)):
        if t.endswith(suffix):
            return int(float(t[:-len(suffix)]) * mult)
    return int(t)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="octopus-tpu-torch",
        description="haplotype-aware variant caller (PyTorch/CUDA port)",
        fromfile_prefix_chars="@",
    )
    g = p.add_argument_group("general")
    g.add_argument("--version", action="store_true")
    g.add_argument("--config", help="config file with one option per line")
    g.add_argument("--debug", nargs="?", const="octopus_debug.log", default=None)
    g.add_argument("--trace", nargs="?", const="octopus_trace.log", default=None)
    g.add_argument("-w", "--working-directory")
    g.add_argument("--resolve-symlinks", action="store_true")
    g.add_argument("--threads", type=int, nargs="?", const=0, default=0)
    # workers default to processes (the python host pipeline is GIL-bound);
    # --thread-workers restores the in-process pool (reference analog:
    # octopus.cpp:1226-1342 thread scheduler)
    g.add_argument("--thread-workers", action="store_true")
    g.add_argument("-X", "--max-reference-cache-memory", type=_mem,
                   default=_mem("500MB"))
    g.add_argument("-B", "--target-read-buffer-memory", type=_mem,
                   default=_mem("6GB"))
    g.add_argument("--target-working-memory", type=_mem, default=None)
    g.add_argument("--max-open-read-files", type=int, default=250)
    g.add_argument("--temp-directory-prefix", default="octopus-temp")
    g.add_argument("--keep-temporary-files", action="store_true")
    g.add_argument("--fast", action="store_true",
                   help="preset: no assembler, smaller haplotype limits")
    g.add_argument("--very-fast", action="store_true")
    g.add_argument("--benchmark", action="store_true",
                   help="print phase timers at exit, self and total "
                        "seconds (reference BENCHMARK build)")
    g.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler trace of the run to "
                        "DIR/trace.json (chrome://tracing): the host "
                        "phases beside the kernels and copies they issue, "
                        "on one clock")
    g.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the pair-HMM, the genotype reductions and "
                        "the VB engines run (cuda needs a card and raises "
                        "without one)")
    # TPU-build extras: multi-host work sharing + resumable shards
    g.add_argument("--shard-index", type=int, default=None,
                   help="this host's shard (multi-host static striping)")
    g.add_argument("--num-shards", type=int, default=None)
    g.add_argument("--work-queue", action="store_true",
                   help="coordinate windows through the shared-FS work queue")
    g.add_argument("--no-resume", dest="resume", action="store_false",
                   help="ignore the window-completion journal")

    io = p.add_argument_group("io")
    io.add_argument("-R", "--reference", required=False)
    io.add_argument("-I", "--reads", nargs="+", default=None)
    io.add_argument("-i", "--reads-file", nargs="+", default=None,
                    help="files listing one BAM path per line")
    io.add_argument("-o", "--output")
    io.add_argument("--contig-output-order", default="REFERENCE_INDEX",
                    choices=["LEXICOGRAPHICAL_ASCENDING", "LEXICOGRAPHICAL_DESCENDING",
                             "CONTIG_SIZE_ASCENDING", "CONTIG_SIZE_DESCENDING",
                             "AS_IN_REFERENCE", "REFERENCE_INDEX", "UNSPECIFIED"])
    io.add_argument("--sites-only", action="store_true",
                    help="omit genotype (FORMAT/sample) columns")
    io.add_argument("-T", "--regions", nargs="*")
    io.add_argument("-t", "--regions-file")
    io.add_argument("-K", "--skip-regions", nargs="*")
    io.add_argument("-k", "--skip-regions-file")
    io.add_argument("--one-based-indexing", action="store_true")
    io.add_argument("--ignore-unmapped-contigs", action="store_true")
    io.add_argument("-S", "--samples", nargs="*",
                    help="restrict calling to these samples")
    io.add_argument("--bamout", help="evidence BAM output path")
    io.add_argument("--bamout-type", default="MINI", choices=["FULL", "MINI"])
    io.add_argument("--pedigree", help="PED file for trio resolution")
    io.add_argument("-c", "--source-candidates", nargs="*", default=None,
                    help="VCF of candidate variants")
    io.add_argument("--source-candidates-file", nargs="*", default=None)
    io.add_argument("--min-source-candidate-quality", type=float, default=None)
    io.add_argument("--use-filtered-source-candidates", action="store_true")
    io.add_argument("--data-profile", help="write an indel-error profile CSV")

    rp = p.add_argument_group("read preprocessing")
    rp.add_argument("--disable-read-preprocessing", action="store_true")
    rp.add_argument("--max-base-quality", type=int, default=None)
    rp.add_argument("--mask-tails", type=int, default=None)
    rp.add_argument("--mask-low-quality-tails", type=int, nargs="?", const=10,
                    default=None)
    rp.add_argument("--mask-soft-clipped-bases", action="store_true")
    rp.add_argument("--mask-soft-clipped-boundary-bases", type=int, default=2)
    rp.add_argument("--soft-clip-mask-threshold", type=int, default=None)
    rp.add_argument("--disable-soft-clip-masking", action="store_true")
    rp.add_argument("--mask-inverted-soft-clipping", action="store_true")
    rp.add_argument("--mask-3prime-shifted-soft-clipped-heads", action="store_true")
    rp.add_argument("--disable-adapter-masking", action="store_true")
    rp.add_argument("--disable-overlap-masking", action="store_true")
    rp.add_argument("--split-long-reads", action="store_true")
    rp.add_argument("--consider-unmapped-reads", action="store_true")
    rp.add_argument("--min-mapping-quality", type=int, default=5)
    rp.add_argument("--good-base-quality", type=int, default=20)
    rp.add_argument("--min-good-base-fraction", type=float, default=None)
    rp.add_argument("--min-good-bases", type=int, default=20)
    rp.add_argument("--min-read-length", type=int, default=None)
    rp.add_argument("--max-read-length", type=int, default=10000)
    rp.add_argument("--allow-marked-duplicates", action="store_true")
    rp.add_argument("--allow-octopus-duplicates", action="store_true")
    rp.add_argument("--duplicate-read-detection-policy", default="RELAXED",
                    choices=["RELAXED", "AGGRESSIVE"])
    rp.add_argument("--allow-qc-fails", action="store_true")
    rp.add_argument("--no-reads-with-tag", nargs="*", default=[],
                    help="tag or tag=value; reads carrying it are removed")
    rp.add_argument("--allow-secondary-alignments", action="store_true")
    rp.add_argument("--allow-supplementary-alignments", action="store_true")
    rp.add_argument("--no-reads-with-unmapped-segments", action="store_true")
    rp.add_argument("--no-reads-with-distant-segments", action="store_true")
    rp.add_argument("--no-adapter-contaminated-reads", action="store_true")
    rp.add_argument("--max-decoy-supplementary-alignment-mapping-quality",
                    type=int, default=5)
    rp.add_argument("--max-unplaced-supplementary-alignment-mapping-quality",
                    type=int, default=5)
    rp.add_argument("--max-unlocalized-supplementary-alignment-mapping-quality",
                    type=int, default=5)
    rp.add_argument("--disable-downsampling", action="store_true")
    rp.add_argument("--downsample-above", type=int, default=1000)
    rp.add_argument("--downsample-target", type=int, default=500)
    rp.add_argument("--use-same-read-profile-for-all-samples", action="store_true")

    cand = p.add_argument_group("candidate variant discovery")
    cand.add_argument("--variant-discovery-mode", default="ILLUMINA",
                      choices=["ILLUMINA", "PACBIO"])
    cand.add_argument("--disable-denovo-variant-discovery", action="store_true")
    cand.add_argument("--disable-pileup-candidate-generator", action="store_true")
    cand.add_argument("--disable-repeat-candidate-generator", action="store_true")
    cand.add_argument("--disable-assembly-candidate-generator", action="store_true")
    cand.add_argument("--min-pileup-base-quality", type=int, default=20)
    cand.add_argument("--min-supporting-reads", type=int, default=None)
    cand.add_argument("--allow-strand-biased-candidates", action="store_true")
    cand.add_argument("--min-credible-somatic-frequency", type=float, default=0.005)
    cand.add_argument("--min-expected-somatic-frequency", type=float, default=0.01)
    cand.add_argument("--min-candidate-credible-vaf-probability", type=float,
                      default=0.75)
    cand.add_argument("--max-variant-size", type=int, default=2000)
    cand.add_argument("--kmer-sizes", type=int, nargs="+", default=[10, 15, 20])
    cand.add_argument("--max-fallback-kmers", type=int, default=10)
    cand.add_argument("--fallback-kmer-gap", type=int, default=10)
    cand.add_argument("--max-assembly-region-size", type=int, default=600)
    cand.add_argument("--max-assembly-region-overlap", type=int, default=200)
    cand.add_argument("--assemble-all", action="store_true")
    cand.add_argument("--assembler-mask-base-quality", type=int, default=10)
    cand.add_argument("--min-kmer-prune", type=int, default=2)
    cand.add_argument("--max-bubbles", type=int, default=30)
    cand.add_argument("--min-bubble-score", type=float, default=2.0)
    cand.add_argument("--force-pileup-candidates", action="store_true")

    hap = p.add_argument_group("haplotype generation")
    hap.add_argument("--max-haplotypes", type=int, default=200)
    hap.add_argument("--haplotype-holdout-threshold", type=int, default=2500)
    hap.add_argument("--haplotype-overflow", type=int, default=200000)
    hap.add_argument("--max-holdout-depth", type=int, default=20)
    hap.add_argument("--extension-level", default="MODERATE",
                     choices=["MINIMAL", "CONSERVATIVE", "MODERATE",
                              "AGGRESSIVE", "UNLIMITED"])
    hap.add_argument("--lagging-level", default="MODERATE",
                     choices=["NONE", "CONSERVATIVE", "MODERATE",
                              "OPTIMISTIC", "AGGRESSIVE"])
    hap.add_argument("--backtrack-level", default="NONE",
                     choices=["NONE", "MODERATE", "AGGRESSIVE"])
    hap.add_argument("--min-protected-haplotype-posterior", type=float,
                     default=1e-10)
    hap.add_argument("--dont-protect-reference-haplotype", action="store_true")

    caller = p.add_argument_group("calling (general)")
    caller.add_argument("-C", "--caller", default="auto",
                        choices=["auto", "individual", "population", "trio",
                                 "cancer", "polyclone", "cell"])
    caller.add_argument("-P", "--organism-ploidy", type=int, default=2)
    caller.add_argument("-p", "--contig-ploidies", nargs="*",
                        help="per-contig overrides, e.g. chrY=1")
    caller.add_argument("--contig-ploidies-file")
    caller.add_argument("--min-variant-posterior", type=float, default=0.1)
    caller.add_argument("--refcall", nargs="?", const="BLOCKED", default=None,
                        choices=["BLOCKED", "POSITIONAL"],
                        help="emit reference confidence calls (gVCF)")
    caller.add_argument("--refcall-block-merge-quality", type=float, default=10.0)
    caller.add_argument("--max-refcall-posterior", type=float, default=None)
    caller.add_argument("--snp-heterozygosity", type=float, default=0.001)
    caller.add_argument("--snp-heterozygosity-stdev", type=float, default=0.01)
    caller.add_argument("--indel-heterozygosity", type=float, default=0.0001)
    caller.add_argument("--use-uniform-genotype-priors", action="store_true")
    caller.add_argument("--max-genotypes", type=int, default=None)
    caller.add_argument("--max-genotype-combinations", type=int, default=None)
    caller.add_argument("--use-independent-genotype-priors", action="store_true")
    caller.add_argument("--model-posterior", default="ALL",
                        choices=["ALL", "OFF", "SPECIAL"])
    caller.add_argument("--disable-inactive-flank-scoring", action="store_true")
    caller.add_argument("--dont-model-mapping-quality", action="store_true")
    caller.add_argument("--sequence-error-model", default="PCR-FREE.HISEQ-2500")
    caller.add_argument("--max-vb-seeds", type=int, default=12)
    caller.add_argument("--max-indel-errors", type=int, default=16,
                        help="pair-HMM band-size ceiling (reference default "
                             "16); each calling context selects the smallest "
                             "band {8,16,32} covering its candidate indels")
    caller.add_argument("--use-wide-hmm-scores", action="store_true",
                        help="accepted; the kernels always carry 32-bit scores")
    caller.add_argument("--read-linkage", default="PAIRED",
                        choices=["NONE", "PAIRED", "LINKED"])
    caller.add_argument("--min-phase-score", type=float, default=5.0)
    caller.add_argument("--phasing-policy", default="AUTO",
                        choices=["AUTO", "CONSERVATIVE", "AGGRESSIVE"])
    caller.add_argument("--bad-region-tolerance", default="NORMAL",
                        choices=["LOW", "NORMAL", "HIGH", "UNLIMITED"])
    caller.add_argument("--use-preprocessed-reads-for-filtering", action="store_true")
    caller.add_argument("--regenotype", default=None,
                        help="NOT SUPPORTED (a stub in the reference too, "
                             "caller.cpp:211-214); errors if set")

    cancer = p.add_argument_group("cancer calling")
    cancer.add_argument("-N", "--normal-samples", nargs="*")
    cancer.add_argument("--max-somatic-haplotypes", type=int, default=2)
    cancer.add_argument("--somatic-snv-prior", type=float, default=1e-4)
    cancer.add_argument("--somatic-indel-prior", type=float, default=1e-6)
    cancer.add_argument("--tumour-germline-concentration", type=float, default=1.5)
    cancer.add_argument("--somatic-credible-mass", type=float, default=0.9)
    cancer.add_argument("--min-somatic-posterior", type=float, default=0.5)
    cancer.add_argument("--normal-contamination-risk", default="LOW",
                        choices=["LOW", "HIGH"])
    cancer.add_argument("--somatics-only", action="store_true")
    cancer.add_argument("--somatic-cnv-prior", type=float, default=1e-5)

    trio = p.add_argument_group("trio calling")
    trio.add_argument("-M", "--maternal-sample")
    trio.add_argument("-F", "--paternal-sample")
    trio.add_argument("--denovo-snv-prior", type=float, default=1.3e-8)
    trio.add_argument("--denovo-indel-prior", type=float, default=1e-9)
    trio.add_argument("--min-denovo-posterior", type=float, default=3.0)
    trio.add_argument("--denovos-only", action="store_true")

    poly = p.add_argument_group("polyclone calling")
    poly.add_argument("--max-clones", type=int, default=3)
    poly.add_argument("--min-clone-frequency", type=float, default=0.01)
    poly.add_argument("--clone-prior", type=float, default=0.1)
    poly.add_argument("--clone-concentration", type=float, default=1.0)

    cell = p.add_argument_group("cell calling")
    cell.add_argument("--max-copy-loss", type=int, default=0)
    cell.add_argument("--max-copy-gain", type=int, default=0)
    cell.add_argument("--dropout-concentration", type=float, default=5.0)
    cell.add_argument("--sample-dropout-concentrations", nargs="*", default=[],
                      help="NOT SUPPORTED in this build; errors if set "
                           "(use --dropout-concentration)")
    cell.add_argument("--phylogeny-concentration", type=float, default=20.0)
    cell.add_argument("--max-phylogeny-size", type=int, default=3)

    filt = p.add_argument_group("call filtering and annotation")
    filt.add_argument("--disable-call-filtering", action="store_true")
    filt.add_argument("--filter-expression", default=None,
                      help="boolean measure expression (default: reference germline)")
    filt.add_argument("--somatic-filter-expression", default=None)
    filt.add_argument("--denovo-filter-expression", default=None)
    filt.add_argument("--refcall-filter-expression", default=None)
    filt.add_argument("--keep-unfiltered-calls", action="store_true",
                      help="accepted; failing calls are annotated, never dropped")
    filt.add_argument("--annotations", nargs="*", default=[],
                      help="extra measure names to emit as INFO fields")
    filt.add_argument("--aggregate-annotations", action="store_true")
    filt.add_argument("--filter-vcf",
                      help="filter an existing VCF instead of calling")
    filt.add_argument("--forest-model",
                      help="random forest .npz for RF filtering")
    filt.add_argument("--somatic-forest-model")
    filt.add_argument("--use-germline-forest-for-somatic-normals", action="store_true")
    filt.add_argument("--min-forest-quality", type=float, default=3.0)

    return p


# Flags that are declared for command-line parity but REJECTED when set,
# because no backend exists (value = the why/help pointer).  The reference's
# --regenotype is itself a stub (caller.cpp:211-214); the per-cell dropout
# concentration has no seat in this build's two-level VB factorisation
# (mixture_mixture_vb.py shares clone haplotype weights across cells).
#
# Note on a deliberate near-no-op: --aggregate-annotations is accepted
# silently because measure values are already emitted ALT-aggregated
# (min-tail over alleles), which equals the flag's ON behaviour
# (variant_call_filter.hpp:47).
REJECTED = {
    "regenotype": (
        "regenotyping is not implemented (it is also an unfinished stub in "
        "upstream octopus, caller.cpp:211-214)",
        "re-call with --source-candidates your.vcf to restrict candidates "
        "to known sites, which covers the common regenotyping use"),
    "sample_dropout_concentrations": (
        "per-sample dropout concentrations have no seat in this build's "
        "single-cell VB factorisation",
        "use --dropout-concentration to set one concentration for all "
        "cells"),
}


def check_rejected(args) -> None:
    """Hard-error on flags with no backend (do_help-style pointer)."""
    parser = build_parser()
    defaults = vars(parser.parse_args([]))
    for k, (why, help_) in sorted(REJECTED.items()):
        if getattr(args, k, None) not in (defaults.get(k), None, False, []):
            from ..errors import UserError
            raise UserError(
                f"the option --{k.replace('_', '-')} is not supported: {why}",
                where="options", help=help_)


def scoring_config(args, **fields) -> LikelihoodConfig:
    """The run's LikelihoodConfig: on --device, with the host-DP gate of
    OCTOPUS_TPU_HOST_HMM_MAX when the user sets it. Read assignment outside
    the callers (--filter-vcf, --bamout) scores with it."""
    host_hmm_max = os.environ.get("OCTOPUS_TPU_HOST_HMM_MAX")
    if host_hmm_max is not None:
        fields["host_hmm_max"] = int(host_hmm_max)
    return LikelihoodConfig(device=args.device, **fields)


def parse_args_with_config(argv=None):
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    if args.config:
        file_args = []
        with open(args.config) as fh:
            for line in fh:
                line = line.split("#")[0].strip()
                if not line:
                    continue
                if "=" in line and not line.startswith("-"):
                    k, _, v = line.partition("=")
                    k, v = k.strip(), v.strip()
                    # reference config style: boolean flags as key=true/false
                    # (resources/configs/PacBioCCS.config split-long-reads=true)
                    if v.lower() in ("true", "yes"):
                        file_args.append(f"--{k}")
                    elif v.lower() in ("false", "no"):
                        pass
                    else:
                        file_args.extend([f"--{k}", *shlex.split(v)])
                elif not line.startswith("-"):
                    file_args.append(f"--{line}")    # bare flag
                else:
                    file_args.extend(shlex.split(line))
        # command line wins over config file: parse file first, then overlay
        args = parser.parse_args(file_args + (argv or []))
    if extra:
        parser.error(f"unrecognised arguments: {' '.join(extra)}")
    return args


@dataclass
class CollatedComponents:
    read_pipe: ReadPipeConfig
    caller: BaseCallerConfig
    caller_kind: str
    filter_expression: str | None
    somatic_filter_expression: str | None = None
    denovo_filter_expression: str | None = None
    refcall_filter_expression: str | None = None
    annotations: tuple[str, ...] = ()


def _parse_tag_filters(items: list[str]) -> list[tuple[str, str | None]]:
    out = []
    for item in items:
        tag, _, value = item.partition("=")
        out.append((tag, value or None))
    return out


def collate(args) -> CollatedComponents:
    """Options -> component configs (option_collation.cpp equivalent)."""
    check_rejected(args)
    use_assembler = not (args.disable_assembly_candidate_generator
                         or args.fast or args.very_fast)
    rp = ReadPipeConfig(
        max_base_quality=args.max_base_quality,
        mask_tails=args.mask_tails,
        mask_low_quality_tails=args.mask_low_quality_tails,
        mask_soft_clipped_boundary_bases=args.mask_soft_clipped_boundary_bases,
        soft_clip_mask_threshold=args.soft_clip_mask_threshold,
        soft_clip_masking=not args.disable_soft_clip_masking,
        assembler_enabled=use_assembler,
        adapter_masking=not args.disable_adapter_masking,
        overlap_masking=not args.disable_overlap_masking,
        mask_inverted_soft_clipping=args.mask_inverted_soft_clipping,
        mask_3prime_shifted_soft_clipped_heads=args.mask_3prime_shifted_soft_clipped_heads,
        consider_unmapped_reads=args.consider_unmapped_reads,
        min_mapping_quality=args.min_mapping_quality,
        good_base_quality=args.good_base_quality,
        min_good_bases=args.min_good_bases,
        min_good_base_fraction=args.min_good_base_fraction,
        min_read_length=args.min_read_length,
        max_read_length=args.max_read_length,
        split_long_reads=args.split_long_reads,
        allow_marked_duplicates=args.allow_marked_duplicates,
        allow_octopus_duplicates=args.allow_octopus_duplicates,
        duplicate_read_detection_policy=args.duplicate_read_detection_policy.lower(),
        allow_qc_fails=args.allow_qc_fails,
        no_reads_with_tag=_parse_tag_filters(args.no_reads_with_tag),
        allow_secondary=args.allow_secondary_alignments,
        allow_supplementary=args.allow_supplementary_alignments,
        no_reads_with_unmapped_segments=args.no_reads_with_unmapped_segments,
        no_reads_with_distant_segments=args.no_reads_with_distant_segments,
        no_adapter_contaminated_reads=args.no_adapter_contaminated_reads,
        max_decoy_supplementary_mq=args.max_decoy_supplementary_alignment_mapping_quality,
        max_unplaced_supplementary_mq=args.max_unplaced_supplementary_alignment_mapping_quality,
        max_unlocalized_supplementary_mq=args.max_unlocalized_supplementary_alignment_mapping_quality,
        downsample_above=args.downsample_above,
        downsample_target=args.downsample_target,
        disable_downsampling=args.disable_downsampling,
        disable_preprocessing=args.disable_read_preprocessing,
    )
    scanner = ScannerOptions(
        snv_threshold=args.min_pileup_base_quality,
        max_variant_size=args.max_variant_size,
        use_misalignment_filter=not args.force_pileup_candidates,
        copy_number=args.organism_ploidy,
        # --allow-strand-biased-candidates: skip the strand-bias rejection
        # clauses of the inclusion predicates (option_parser.cpp:439-441)
        allow_strand_bias=args.allow_strand_biased_candidates,
    )
    if args.min_supporting_reads is not None:
        scanner.inclusion = "threshold"
        scanner.min_observations = args.min_supporting_reads
    if args.variant_discovery_mode == "PACBIO":
        scanner.inclusion = "pacbio"
    caller_kind = args.caller
    if caller_kind in ("auto",):
        if (args.maternal_sample and args.paternal_sample) or args.pedigree:
            caller_kind = "trio"
        elif args.normal_samples:
            caller_kind = "cancer"
    if caller_kind == "cancer":
        scanner.inclusion = "somatic"
        scanner.min_vaf = args.min_credible_somatic_frequency
        scanner.min_probability = args.min_candidate_credible_vaf_probability
    elif caller_kind == "polyclone":
        # polyclone uses the same unknown-copy-number inclusion predicate
        # with min VAF = --min-clone-frequency / 2
        # (option_collation.cpp:1089-1095)
        scanner.inclusion = "somatic"
        scanner.min_vaf = args.min_clone_frequency / 2
        scanner.min_probability = args.min_candidate_credible_vaf_probability
    elif caller_kind == "cell":
        scanner.inclusion = "cell"
    assembler = AssemblerOptions(
        kmer_sizes=tuple(args.kmer_sizes),
        bin_size=args.max_assembly_region_size,
        bin_overlap=args.max_assembly_region_overlap,
        # --min-kmer-prune maps 1:1 (option_collation.cpp:1319); the
        # round-1 "- 1" kept single-read noise k-mer paths alive, whose
        # junk bubbles formed the dense candidate clusters behind the
        # 10 Mb heavy tail (BASELINE.md round 4)
        min_kmer_observations=args.min_kmer_prune,
        max_bubbles=args.max_bubbles,
        min_bubble_score=args.min_bubble_score,
        mask_threshold=args.assembler_mask_base_quality,
        max_variant_size=max(args.max_variant_size, 5000),
        num_fallbacks=args.max_fallback_kmers,
        fallback_interval_size=max(args.fallback_kmer_gap, 1),
        assemble_all=args.assemble_all,
    )
    likelihood = scoring_config(
        args,
        max_indel_error=args.max_indel_errors,
        error_model=args.sequence_error_model,
        use_mapping_quality=not args.dont_model_mapping_quality,
        use_flank_state=not args.disable_inactive_flank_scoring,
        # --use-same-read-profile-for-all-samples: derive one pooled
        # MQ-cap/trigger profile per window instead of per sample
        # (option_collation.cpp:1624-1659 make_unique ReadSetProfile path)
        shared_read_profile=args.use_same_read_profile_for_all_samples,
    )
    sources = list(args.source_candidates or [])
    for listing in args.source_candidates_file or []:
        with open(listing) as fh:
            sources.extend(l.strip() for l in fh if l.strip())
    caller = BaseCallerConfig(
        ploidy=args.organism_ploidy,
        min_variant_posterior_phred=args.min_variant_posterior,
        max_haplotypes=args.max_haplotypes if not args.very_fast else 50,
        haplotype_holdout_threshold=args.haplotype_holdout_threshold,
        haplotype_overflow=args.haplotype_overflow,
        max_holdout_depth=args.max_holdout_depth,
        lagging_level=args.lagging_level.lower(),
        extension_level=args.extension_level.lower(),
        backtrack_level=args.backtrack_level.lower(),
        protect_reference_haplotype=not args.dont_protect_reference_haplotype,
        min_protected_haplotype_posterior=args.min_protected_haplotype_posterior,
        snp_heterozygosity=args.snp_heterozygosity,
        snp_heterozygosity_stdev=args.snp_heterozygosity_stdev,
        indel_heterozygosity=args.indel_heterozygosity,
        use_uniform_genotype_priors=args.use_uniform_genotype_priors,
        max_genotypes=args.max_genotypes,
        max_genotype_combinations=args.max_genotype_combinations,
        min_phase_score=args.min_phase_score,
        read_linkage=args.read_linkage.lower() if args.read_linkage != "NONE" else "none",
        max_vb_seeds=args.max_vb_seeds,
        bad_region_tolerance=args.bad_region_tolerance.lower(),
        model_posterior_policy=args.model_posterior.lower(),
        likelihood=likelihood,
        scanner=scanner,
        use_assembler=use_assembler,
        # --disable-denovo-variant-discovery is the reference's alias for
        # turning off the pileup generator (option_collation.cpp:751)
        use_pileup_scanner=not (args.disable_pileup_candidate_generator
                                or args.disable_denovo_variant_discovery),
        use_repeat_scanner=not args.disable_repeat_candidate_generator,
        assembler=assembler,
        source_vcf=sources[0] if sources else None,
        min_source_candidate_quality=args.min_source_candidate_quality,
        phasing_policy=args.phasing_policy.lower(),
        use_independent_genotype_priors=args.use_independent_genotype_priors,
        use_filtered_source_candidates=args.use_filtered_source_candidates,
        target_working_memory=args.target_working_memory,
        device=args.device,
        # set only in a process-pool worker's arguments (run.py)
        defer_heavy=getattr(args, "defer_heavy", 0),
    )
    return CollatedComponents(
        read_pipe=rp,
        caller=caller,
        caller_kind=caller_kind,
        filter_expression=(None if args.disable_call_filtering
                           else args.filter_expression),
        somatic_filter_expression=args.somatic_filter_expression,
        denovo_filter_expression=args.denovo_filter_expression,
        refcall_filter_expression=args.refcall_filter_expression,
        annotations=tuple(args.annotations),
    )
