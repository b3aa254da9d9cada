"""Calling orchestration: the equivalent of run_octopus
(src/core/octopus.cpp:1738) for the CLI.

Orchestration design (octopus.cpp:467-529 and :1226-1342):
* windows sized dynamically by read budget (propose_call_subregion,
  octopus.cpp:340-395) via the BAI linear index;
* per-window VCF shards in a temp directory + a completion journal give
  region-granular checkpoint/resume (an addition over the reference, which
  has no resume; SURVEY.md section 5) — rerunning with the same output path
  skips completed windows;
* shards merge into the final sorted VCF (vcf_utils::merge equivalent).

This port runs all six callers: individual, population (the default for
several samples), trio, cancer (tumour with or without a normal),
polyclone and cell, from BAM or CRAM input, with inline threshold, forest
or training CSR, and the evidence BAM (--bamout) after the merge; its
pair-HMM, genotype reductions and VB engines run on `--device` (default
cuda). Windows run serially, on a process pool (`--threads N`: CPU-only
workers, the parent keeps the card and runs the dense windows they hand
back), or on a thread pool (`--threads N --thread-workers`). Several processes or hosts share a
run through `--shard-index/--num-shards` and `--work-queue`; the
multi-host environment (OCTOPUS_TPU_COORDINATOR, OCTOPUS_TPU_DISTRIBUTED)
starts torch.distributed.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time
from dataclasses import dataclass

import numpy as np

from .basics.reads import ReadBatch
from .core.callers.individual import CallerConfig, IndividualCaller
from .core.csr.measures import compute_measures
from .core.csr.threshold import ThresholdFilter
from .core.tools.refcall import RefcallConfig, make_refcall_blocks
from .core.tools.vcf_record_factory import (apply_spanning_alleles,
                                            make_vcf_header,
                                            site_call_to_record)
from .io.bam import BamFile
from .io.read_manager import ReadManager
from .io.fasta import IndexedFasta, ReferenceGenome
from .io.vcf import VcfWriter, VcfReader, merge_sorted
from .logging_.progress import ProgressMeter
from .readpipe.pipe import ReadPipe, ReadPipeConfig


@dataclass
class Window:
    contig: str
    begin: int
    end: int

    @property
    def key(self) -> str:
        return f"{self.contig}_{self.begin}_{self.end}"


def propose_windows(reference: ReferenceGenome, regions: list[tuple[str, int, int]],
                    bams: list[BamFile] | None = None,
                    target_reads: int = 5000,
                    min_size: int = 5_000, max_size: int = 25_000_000,
                    default_size: int = 50_000) -> list[Window]:
    """Dynamic call windows budgeted by approximate read count.

    Approximates the reference's find_covered_subregion-driven task sizing
    using the BAI linear index (16 kb bins with file-offset deltas as a read
    density proxy)."""
    out = []
    for contig, begin, end in regions:
        sizes = None
        if bams:
            density = _density_profile(bams, contig, begin, end)
            if density is not None:
                out.extend(_windows_from_density(contig, begin, end, density,
                                                 target_reads, min_size, max_size))
                continue
        pos = begin
        while pos < end:
            out.append(Window(contig, pos, min(pos + default_size, end)))
            pos += default_size
    return out


def _density_profile(bams, contig, begin, end):
    """Approximate reads per 16 kb bin from BAI linear indices."""
    bins = None
    for bam in bams:
        if bam.index is None or contig not in bam.header.ref_names:
            return None
        rid = bam.header.ref_names.index(contig)
        linear = bam.index.linear[rid]
        if len(linear) == 0:
            continue
        # compressed-offset deltas between bins ~ bytes ~ reads
        coffs = (linear >> 16).astype(np.float64)
        deltas = np.diff(np.concatenate([coffs, [coffs[-1]]]))
        deltas = np.maximum(deltas, 0)
        # calibrate bytes/read against the BAI pseudo-bin mapped count when
        # present (samtools metadata); fall back to ~100 compressed bytes/read
        n_mapped = bam.index.mapped[rid] if rid < len(bam.index.mapped) else None
        total = float(deltas.sum())
        if n_mapped and total > 0:
            deltas = deltas * (n_mapped / total)
        else:
            deltas = deltas / 100.0
        if bins is None:
            bins = deltas
        else:
            n = max(len(bins), len(deltas))
            a = np.zeros(n)
            a[:len(bins)] += bins
            a[:len(deltas)] += deltas
            bins = a
    return bins


def _windows_from_density(contig, begin, end, density, target_reads,
                          min_size, max_size):
    out = []
    pos = begin
    while pos < end:
        acc = 0.0
        cur = pos
        while cur < end and acc < target_reads and cur - pos < max_size:
            b = cur >> 14
            acc += density[b] if b < len(density) else 0.0
            cur = min((b + 1) << 14, end)
        cur = max(cur, pos + min_size)
        out.append(Window(contig, pos, min(cur, end)))
        pos = min(cur, end)
    return out


def _contig_order(reference, order: str) -> list[str]:
    """--contig-output-order (option_parser.cpp ContigOutputOrder)."""
    names = list(reference.contig_names())
    if order == "LEXICOGRAPHICAL_ASCENDING":
        return sorted(names)
    if order == "LEXICOGRAPHICAL_DESCENDING":
        return sorted(names, reverse=True)
    if order == "CONTIG_SIZE_ASCENDING":
        return sorted(names, key=reference.contig_size)
    if order == "CONTIG_SIZE_DESCENDING":
        return sorted(names, key=reference.contig_size, reverse=True)
    return names   # REFERENCE_INDEX / AS_IN_REFERENCE / UNSPECIFIED


def _subtract_regions(regions, skip):
    """Remove skip intervals from the search regions (--skip-regions)."""
    out = []
    for contig, begin, end in regions:
        pieces = [(begin, end)]
        for sc, sb, se in skip:
            if sc != contig:
                continue
            nxt = []
            for b, e in pieces:
                if se <= b or sb >= e:
                    nxt.append((b, e))
                    continue
                if b < sb:
                    nxt.append((b, sb))
                if se < e:
                    nxt.append((se, e))
            pieces = nxt
        out.extend((contig, b, e) for b, e in pieces if e > b)
    return out


def parse_region(text: str, reference: ReferenceGenome,
                 one_based: bool = False) -> tuple[str, int, int]:
    """'chr1:100-200' / 'chr1:100' / 'chr1:100-' / 'chr1'.

    Reference semantics (io/region/region_parser.cpp:96-140): zero-based
    half-open by default; 'contig:pos' is the point region [pos, pos+1);
    'contig:begin-' runs to the contig end; begin/end clamp to the contig.
    --one-based-indexing shifts the whole region left by one
    (option_collation.cpp:489-510 transform_to_zero_based).

    Malformed syntax or an unknown contig raises
    :class:`~octopus_tpu_torch.errors.BadRegionError`."""
    from .errors import BadRegionError

    def contig_size(contig):
        try:
            return reference.contig_size(contig)
        except KeyError:
            raise BadRegionError(
                text, reason=f"contig {contig!r} is not in the reference",
                known_contigs=reference.contig_names()) from None

    # a full contig name wins before any colon-splitting — GRCh38 ALT/HLA
    # contigs legitimately contain colons ("HLA-A*01:01:01:01"); the
    # reference checks has_contig(region) first (region_parser.cpp:94-97)
    if ":" not in text or text in reference.contig_names():
        return text, 0, contig_size(text)
    contig, _, rng = text.rpartition(":")
    rng = rng.replace(",", "")
    size = contig_size(contig)
    try:
        if "-" in rng:
            b_str, _, e_str = rng.partition("-")
            b = min(int(b_str), max(size - 1, 0))
            if e_str == "":
                e = size
            else:
                e = min(int(e_str), size)
                if b > e:
                    raise BadRegionError(text,
                                         reason="begin is greater than end")
        else:
            b = min(int(rng), max(size - 1, 0))
            e = min(b + 1, size)
    except ValueError:
        raise BadRegionError(
            text, reason="positions must be integers") from None
    if one_based and b > 0:
        b, e = b - 1, e - 1
    return contig, b, e


def _make_caller(kind: str, reference, contig: str, samples: list[str],
                 base_config=None, cli_args=None):
    """Caller selection mirroring the reference's auto resolution
    (option_collation.cpp:1845-1860): several samples without a caller
    take the population caller."""
    import dataclasses

    def specialise(cls, **extra):
        if base_config is None:
            return cls(**extra)
        fields = {f.name: getattr(base_config, f.name)
                  for f in dataclasses.fields(type(base_config))}
        fields.update(extra)
        # optional CLI ints arrive as None (the reference leaves them
        # unset, option_parser.cpp:546): keep the caller's own default
        # rather than overriding it with None
        defaults = {f.name: f.default for f in dataclasses.fields(cls)
                    if f.default is not dataclasses.MISSING}
        for name, val in list(fields.items()):
            if val is None and defaults.get(name) is not None:
                fields[name] = defaults[name]
        return cls(**fields)

    def arg(name, default=None):
        return getattr(cli_args, name, default) if cli_args is not None else default

    if kind in ("auto", "population") and len(samples) > 1:
        from .core.callers.population import PopulationCaller, PopulationCallerConfig
        extra = {}
        if arg("max_genotype_combinations"):
            extra["max_genotype_combinations"] = arg("max_genotype_combinations")
        return PopulationCaller(reference, contig,
                                specialise(PopulationCallerConfig, **extra))
    if kind == "trio":
        from .core.callers.trio import TrioCaller, TrioCallerConfig
        extra = {}
        if cli_args is not None:
            extra = dict(
                min_denovo_posterior_phred=arg("min_denovo_posterior", 3.0),
                denovo_snv_prior=arg("denovo_snv_prior", 1.3e-8),
                denovo_indel_prior=arg("denovo_indel_prior", 1e-9),
            )
            if arg("max_genotype_combinations"):
                extra["max_joint_combinations"] = arg("max_genotype_combinations")
        return TrioCaller(reference, contig, specialise(TrioCallerConfig, **extra))
    if kind == "cancer":
        from .core.callers.cancer import CancerCaller, CancerCallerConfig
        extra = {}
        if cli_args is not None:
            names = arg("normal_samples") or []
            normal = samples.index(names[0]) if names and names[0] in samples else None
            extra = dict(
                normal_sample=normal,
                max_somatic_haplotypes=arg("max_somatic_haplotypes", 2),
                min_somatic_posterior_phred=arg("min_somatic_posterior", 0.5),
                somatic_snv_prior=arg("somatic_snv_prior", 1e-4),
                somatic_indel_prior=arg("somatic_indel_prior", 1e-6),
                tumour_germline_concentration=arg("tumour_germline_concentration", 1.5),
                min_expected_somatic_frequency=arg("min_expected_somatic_frequency", 0.01),
                somatic_credible_mass=arg("somatic_credible_mass", 0.9),
                min_credible_somatic_frequency=arg("min_credible_somatic_frequency", 0.005),
                normal_contamination_risk=str(arg("normal_contamination_risk", "LOW") or "LOW"),
            )
        return CancerCaller(reference, contig,
                            specialise(CancerCallerConfig, **extra))
    if kind == "polyclone":
        from .core.callers.polyclone import PolycloneCaller, PolycloneCallerConfig
        extra = {}
        if cli_args is not None:
            extra = dict(max_clones=arg("max_clones", 3),
                         clonality_prior_decay=arg("clone_prior", 0.1) or 0.1)
        return PolycloneCaller(reference, contig,
                               specialise(PolycloneCallerConfig, **extra))
    if kind == "cell":
        from .core.callers.cell import CellCaller, CellCallerConfig
        extra = {}
        if cli_args is not None:
            extra = dict(
                max_phylogeny_size=arg("max_phylogeny_size", 3),
                dropout_concentration=arg("dropout_concentration", 5.0),
                phylogeny_concentration=arg("phylogeny_concentration", 20.0),
                max_copy_loss=arg("max_copy_loss", 0) or 0,
                max_copy_gain=arg("max_copy_gain", 0) or 0,
                somatic_cnv_prior=arg("somatic_cnv_prior", 1e-5) or 1e-5,
            )
        return CellCaller(reference, contig, specialise(CellCallerConfig, **extra))
    if base_config is not None:
        return IndividualCaller(reference, contig, base_config)
    return IndividualCaller(reference, contig, CallerConfig())


def _maybe_init_distributed() -> bool:
    """Start torch.distributed when launched as one process of a multi-host
    job; True when this call started it. Two activation paths:

    * explicit: OCTOPUS_TPU_COORDINATOR=<host:port> plus
      OCTOPUS_TPU_NUM_PROCESSES / OCTOPUS_TPU_PROCESS_ID, a gloo group
      rendezvousing at tcp://<host:port>;
    * OCTOPUS_TPU_DISTRIBUTED=1: init_method="env://", the MASTER_ADDR,
      MASTER_PORT, RANK and WORLD_SIZE that torchrun sets.

    Either way each process then calls its own striped or queued windows
    (--shard-index / --work-queue) and the shard merge remains the
    cross-host gather; device sharding stays on each host's local cards.
    No collective runs over the group: it is the job's start-up barrier,
    so a process with a wrong world size, rank or address fails at start
    rather than after its windows, as the reference's
    jax.distributed.initialize does."""
    coord = os.environ.get("OCTOPUS_TPU_COORDINATOR")
    auto = os.environ.get("OCTOPUS_TPU_DISTRIBUTED")
    if not coord and not auto:
        return False
    import torch.distributed as dist
    if dist.is_initialized():
        return False
    if coord:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coord}",
            world_size=int(os.environ["OCTOPUS_TPU_NUM_PROCESSES"]),
            rank=int(os.environ["OCTOPUS_TPU_PROCESS_ID"]))
    else:
        dist.init_process_group("gloo", init_method="env://")
    print(f"octopus-tpu-torch: torch.distributed initialised "
          f"(process {dist.get_rank()}/{dist.get_world_size()})",
          file=sys.stderr)
    return True


def run_calling(args) -> int:
    if getattr(args, "bamout", None) and str(args.bamout).endswith(".cram"):
        # fail BEFORE calling: the evidence realigner writes BAM + BAI, and
        # BAM bytes behind a .cram name would corrupt downstream tooling
        from .errors import UserError
        raise UserError(
            "--bamout CRAM output is not supported (the realigner's HP/PS/LK "
            "evidence tags have no CRAM aux encoding in this build)",
            where="bamout",
            help="use a .bam path for --bamout; CRAM is supported for "
                 "read INPUT (-I reads.cram)")
    started = _maybe_init_distributed()
    try:
        return _run_calling(args)
    finally:
        if started:
            import torch.distributed as dist
            dist.destroy_process_group()


def _run_calling(args) -> int:
    if getattr(args, "profile", None):
        # torch.profiler trace of the whole run (host and, on a card, CUDA
        # kernels); the reference's analog is its BENCHMARK phase-timer
        # build
        import torch
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        from .utils import timers
        profile_dir, args.profile = args.profile, None
        # each timers.phase opens a record_function range, so the trace
        # shows the host phases beside the kernels on the profiler's clock
        timers.annotate = True
        try:
            with profile(activities=activities) as prof:
                code = _run_calling(args)
        finally:
            timers.annotate = False
        os.makedirs(profile_dir, exist_ok=True)
        trace = os.path.join(profile_dir, "trace.json")
        prof.export_chrome_trace(trace)
        print(f"octopus-tpu-torch: profiler trace written to {trace}",
              file=sys.stderr)
        return code
    t0 = time.time()
    from .utils import timers
    timers.enabled = bool(getattr(args, "benchmark", False))
    setup = _setup_components(args)
    if isinstance(setup, int):
        return setup
    (components, reference, bams, samples, regions, pipe, csr, annotations,
     header, refcall_mode) = setup
    return _run_calling_main(args, components, reference, bams, samples,
                             regions, pipe, csr, annotations, header,
                             refcall_mode, t0)


def _setup_components(args):
    """Build the shared calling components from parsed options.

    Returns the component tuple, or an int exit code on a user error.  Also
    used by process workers to rebuild identical state in their own address
    space (the reference's per-thread components are shared-memory;
    calling_components.hpp:35-175)."""
    # -w/--working-directory: outputs and temp files become relative to it
    # (cli.md:66-71); --resolve-symlinks replaces symlinked input paths with
    # their targets at initialisation (cli.md:80-86)
    wd = getattr(args, "working_directory", None)
    if wd:
        os.makedirs(wd, exist_ok=True)
        os.chdir(wd)
    if getattr(args, "resolve_symlinks", False):
        for attr in ("reference", "output", "bamout", "forest_model",
                     "somatic_forest_model"):
            v = getattr(args, attr, None)
            if isinstance(v, str) and os.path.islink(v):
                setattr(args, attr, os.path.realpath(v))
        if getattr(args, "reads", None):
            args.reads = [os.path.realpath(p) if os.path.islink(p) else p
                          for p in args.reads]
    from .config.options import collate
    try:
        components = collate(args)
    except AttributeError:
        components = None
    twm = getattr(args, "target_working_memory", None)
    if twm:
        # --target-working-memory: cap the VB genotype-chunk working set
        # (float32 elements; /16 leaves headroom for the live intermediates)
        os.environ["OCTOPUS_TPU_VB_BUDGET_ELEMS"] = str(
            max(1_000_000, int(twm) // 16))
    from .errors import MissingFileError
    if not os.path.exists(args.reference):
        raise MissingFileError(args.reference, "reference FASTA",
                               where="_setup_components", option="--reference")
    reference = ReferenceGenome(
        IndexedFasta(args.reference),
        max_cache_bytes=getattr(args, "max_reference_cache_memory", 256 << 20))
    read_paths = list(args.reads or [])
    for listing in getattr(args, "reads_file", None) or []:
        if not os.path.exists(listing):
            raise MissingFileError(listing, "read-path list",
                                   where="_setup_components",
                                   option="--reads-file")
        with open(listing) as fh:
            read_paths.extend(l.strip() for l in fh if l.strip())
    for p in read_paths:
        if not os.path.exists(p):
            raise MissingFileError(p, "read", where="_setup_components",
                                   option="--reads")
    manager = ReadManager(read_paths,
                          max_open_files=getattr(args, "max_open_read_files", 250) or 250,
                          reference=reference)
    bams = [manager._get(p) for p in manager.paths]
    samples = manager.samples()
    if getattr(args, "samples", None):
        wanted = set(args.samples)
        missing = wanted - set(samples)
        if missing:
            from .errors import MissingSampleError
            raise MissingSampleError(sorted(missing), samples)
        samples = [s for s in samples if s in wanted]
    # the trio caller is defined over exactly (maternal, paternal, child);
    # a 4th sample would be silently dropped by the trio ordering otherwise
    # (the reference validates this at collation, option_collation.cpp)
    wants_trio = (getattr(args, "caller", "auto") == "trio"
                  or (getattr(args, "maternal_sample", None)
                      and getattr(args, "paternal_sample", None)))
    if wants_trio and len(samples) != 3:
        from .errors import UserError
        raise UserError(
            f"the trio caller needs exactly 3 samples "
            f"(maternal, paternal, child); got {len(samples)}: {samples}",
            where="_setup_components",
            help="restrict with --samples MOM DAD KID, or use "
                 "--caller population for larger pedigrees")
    one_based = getattr(args, "one_based_indexing", False)
    if args.regions:
        regions = [parse_region(r, reference, one_based) for r in args.regions]
    elif getattr(args, "regions_file", None):
        if not os.path.exists(args.regions_file):
            raise MissingFileError(args.regions_file, "regions",
                                   where="_setup_components",
                                   option="-t/--regions-file")
        with open(args.regions_file) as fh:
            regions = [parse_region(l.strip(), reference, one_based)
                       for l in fh if l.strip()]
    else:
        regions = [(c, 0, reference.contig_size(c)) for c in reference.contig_names()]
        # the reference refuses whole-genome runs when reference contigs are
        # absent from every read file unless --ignore-unmapped-contigs
        # (calling_components.cpp:248,755 all_reference_contigs_mapped)
        mapped = set()
        for b in bams:
            hdr = getattr(b, "header", None)
            mapped.update(getattr(hdr, "ref_names", None) or [])
        unmapped = [c for c, _, _ in regions if mapped and c not in mapped]
        if unmapped:
            if getattr(args, "ignore_unmapped_contigs", False):
                regions = [r for r in regions if r[0] not in unmapped]
            else:
                from .errors import UserError
                shown = unmapped[:5] + (["..."] if len(unmapped) > 5 else [])
                raise UserError(
                    "some reference contigs are missing from every read "
                    f"file: {shown} — the read files were probably mapped "
                    "to a different reference",
                    where="_setup_components",
                    help="pass --ignore-unmapped-contigs to call only the "
                         "mapped contigs, restrict with -T/--regions, or "
                         "use the reference the reads were aligned to")
    skip = [parse_region(r, reference, one_based)
            for r in getattr(args, "skip_regions", None) or []]
    if getattr(args, "skip_regions_file", None):
        if not os.path.exists(args.skip_regions_file):
            raise MissingFileError(args.skip_regions_file, "skip-regions",
                                   where="_setup_components",
                                   option="-k/--skip-regions-file")
        with open(args.skip_regions_file) as fh:
            skip.extend(parse_region(l.strip(), reference, one_based)
                        for l in fh if l.strip())
    if skip:
        regions = _subtract_regions(regions, skip)
    if components:
        components.read_pipe.reference = reference
        pipe = ReadPipe(components.read_pipe)
    else:
        pipe = ReadPipe()
    if getattr(args, "disable_call_filtering", False):
        # training mode (option_collation.cpp:2306-2309): with --annotations
        # a PassingVariantCallFilter still computes + emits the measures and
        # marks every call PASS; without annotations, no CSR work at all
        if components and components.annotations:
            from .core.csr.training import PassingFilter
            csr = PassingFilter(tuple(components.annotations))
        else:
            csr = None
    elif getattr(args, "forest_model", None):
        # forest CSR replaces threshold classification
        # (RandomForestFilterFactory, option_collation.cpp)
        from .core.csr.random_forest import ForestCsr
        csr = ForestCsr(args.forest_model,
                        getattr(args, "somatic_forest_model", None),
                        getattr(args, "min_forest_quality", 3.0),
                        use_somatic_forest_for_refcalls=not getattr(
                            args, "use_germline_forest_for_somatic_normals",
                            False))
    elif components:
        csr = ThresholdFilter(components.filter_expression,
                              components.somatic_filter_expression,
                              components.denovo_filter_expression,
                              components.refcall_filter_expression)
    else:
        csr = ThresholdFilter()
    annotations = tuple(components.annotations) if components else ()
    if "all" in annotations:   # --annotations all (cli.md)
        from .core.csr.measures import ALL_MEASURES
        annotations = tuple(ALL_MEASURES)
    header = make_vcf_header(reference, sorted({r[0] for r in regions}),
                             [] if getattr(args, "sites_only", False) else samples)
    if csr is not None:
        for fid in csr.filter_ids():
            header.add_filter(fid, f"Threshold filter {fid}")
        if hasattr(csr, "classify_q"):
            header.add_format("RFGQ", "1", "Float",
                              "Random forest call quality")
    for name in annotations:
        header.add_info(name, ".", "String", f"CSR measure {name}")
    refcall_mode = getattr(args, "refcall", None)
    if refcall_mode:
        header.add_info("END", "1", "Integer", "End position of reference block")
    return (components, reference, bams, samples, regions, pipe, csr,
            annotations, header, refcall_mode)


# -- process-pool workers ----------------------------------------------------
# Worker processes rebuild the (read-only) components from the parsed args in
# their own address space, then call windows independently: real parallelism
# for the numpy/python host pipeline, which the GIL serialises under the
# thread pool. Workers are CPU-only (device "cpu", no visible CUDA card), so
# only the parent process owns the card.

_WORKER_STATE = None


@dataclass
class PoolCounts:
    """What the process pool did: windows the workers called, windows they
    handed back to the parent (HeavyWindowDeferred), and pools that broke
    and fell back to the thread pool."""

    worker_windows: int = 0
    deferred_windows: int = 0
    fallbacks: int = 0

    def reset(self) -> None:
        self.worker_windows = self.deferred_windows = self.fallbacks = 0


POOL = PoolCounts()


def _process_worker_init(args_dict, env):
    os.environ.update(env)
    import argparse
    global _WORKER_STATE
    args = argparse.Namespace(**args_dict)
    from .utils import timers
    timers.enabled = bool(getattr(args, "benchmark", False))
    setup = _setup_components(args)
    if isinstance(setup, int):  # pragma: no cover - validated by parent
        raise RuntimeError(f"worker setup failed with exit code {setup}")
    (components, reference, bams, samples, regions, pipe, csr, annotations,
     header, refcall_mode) = setup
    _WORKER_STATE = dict(
        args=args, reference=reference, bams=bams, samples=samples,
        pipe=pipe, csr=csr, annotations=annotations, header=header,
        refcall_mode=refcall_mode, caller_cache={},
        caller_kind=(components.caller_kind if components
                     else getattr(args, "caller", "auto")),
        caller_config=components.caller if components else None)


def _process_worker_run(task):
    contig, begin, end, key, shard_dir = task
    st = _WORKER_STATE
    window = Window(contig, begin, end)
    from .utils import timers
    timers.reset()
    from .core.callers.base import HeavyWindowDeferred
    try:
        records = _call_window(window, st["reference"], st["bams"],
                               st["samples"], st["pipe"], st["csr"],
                               st["caller_cache"], st["caller_kind"],
                               st["caller_config"], st["args"],
                               st["refcall_mode"], st["annotations"])
    except HeavyWindowDeferred:
        # dense window: decline it so the card-owning parent runs it
        return key, None, {}
    records = _restrict_records(records, st["args"])
    shard_path = os.path.join(shard_dir, key + ".vcf")
    with VcfWriter(shard_path, st["header"]) as w:
        for r in records:
            w.write(r)
    # the window's phase timers: the parent merges these so --benchmark
    # shows the whole pool's phase breakdown, not just the parent process's
    delta = timers.snapshot() if timers.enabled else {}
    return key, shard_path, delta


def _restrict_records(records, args):
    """--somatics-only / --denovos-only / --sites-only record filtering
    (option_collation.cpp:2368-2396)."""
    if getattr(args, "somatics_only", False):
        records = [r for r in records if r.info.get("SOMATIC")]
    if getattr(args, "denovos_only", False):
        records = [r for r in records if r.info.get("DENOVO")]
    if getattr(args, "sites_only", False):
        for r in records:
            r.format_keys = []
            r.sample_values = []
    return records


def _write_journal(path: str, done: dict, key: str | None = None) -> None:
    """Append-only completion journal (journal.jsonl): one line per
    completed window.  Rewriting the whole dict per window was O(n^2)
    bytes over a run — ~180 MB of writes at chr20 window counts, and a
    genuine cliff at whole-genome scale.  Small single-line O_APPEND
    writes are atomic on POSIX, so multi-host sharers never interleave
    partial records; duplicate lines are harmless (last wins)."""
    if key is None:                     # legacy full rewrite (no key known)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            for k, v in done.items():
                fh.write(json.dumps({"key": k, "shard": v}) + "\n")
        os.replace(tmp, path)
        return
    with open(path, "a") as fh:
        fh.write(json.dumps({"key": key, "shard": done[key]}) + "\n")
        fh.flush()


def _load_journal(path: str) -> dict:
    """Read journal.jsonl (plus the pre-round-4 journal.json dict format
    for resume compatibility)."""
    done: dict[str, str] = {}
    legacy = os.path.join(os.path.dirname(path), "journal.json")
    if os.path.exists(legacy):
        try:
            done.update(json.load(open(legacy)))
        except Exception:
            pass
    if os.path.exists(path):
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                    done[rec["key"]] = rec["shard"]
                except Exception:
                    continue            # torn final line after a crash
    return done


def _run_calling_main(args, components, reference, bams, samples,
                      regions, pipe, csr, annotations, header,
                      refcall_mode, t0):
    from .utils import timers
    windows = propose_windows(reference, regions, bams)
    # checkpointed shard directory keyed by the output path
    out_path = args.output or "octopus-tpu-calls.vcf"
    # fail fast on an unwritable output target (UnwritableFileError role,
    # exceptions/unwritable_file_error.hpp) instead of after the calling loop
    out_dir = os.path.dirname(out_path) or "."
    if not os.path.isdir(out_dir) or not os.access(out_dir, os.W_OK):
        from .errors import UnwritableFileError
        raise UnwritableFileError(out_path, where="_run_calling_main")
    prefix = getattr(args, "temp_directory_prefix", None) or "octopus-temp"
    shard_dir = (out_path + ".shards" if prefix == "octopus-temp"
                 else os.path.join(os.path.dirname(out_path) or ".",
                                   prefix + ".shards"))
    journal_path = os.path.join(shard_dir, "journal.jsonl")
    os.makedirs(shard_dir, exist_ok=True)
    done: dict[str, str] = {}
    if getattr(args, "resume", True):
        done = _load_journal(journal_path)
    progress = ProgressMeter(sum(w.end - w.begin for w in windows))
    caller_cache: dict[str, object] = {}
    caller_kind = (components.caller_kind if components
                   else getattr(args, "caller", "auto"))
    caller_config = components.caller if components else None
    n_threads = max(int(getattr(args, "threads", 0) or 0), 1)
    pending = [w for w in windows if w.key not in done]
    shard_index = getattr(args, "shard_index", None)
    num_shards = getattr(args, "num_shards", None)
    if shard_index is not None and num_shards:
        # stripe over the stable full window list so every window belongs to
        # exactly one shard regardless of resume state
        from .parallel.work_queue import stripe
        keys = set(stripe([w.key for w in windows], shard_index, num_shards))
        pending = [w for w in pending if w.key in keys]
    queue = None
    if getattr(args, "work_queue", False):
        from .parallel.work_queue import RegionWorkQueue
        queue = RegionWorkQueue(os.path.join(shard_dir, "queue"))
        pending = [w for w in pending if queue.try_claim(w.key)]
    progress.advance(sum(w.end - w.begin for w in windows) -
                     sum(w.end - w.begin for w in pending))

    def run_one(window):
        records = _call_window(window, reference, bams, samples, pipe, csr,
                               caller_cache, caller_kind, caller_config, args,
                               refcall_mode, annotations)
        records = _restrict_records(records, args)
        shard_path = os.path.join(shard_dir, window.key + ".vcf")
        with VcfWriter(shard_path, header) as w:
            for r in records:
                w.write(r)
        return window, shard_path

    def finish(window, shard_path):
        done[window.key] = shard_path
        _write_journal(journal_path, done, window.key)
        if queue is not None:
            queue.mark_done(window.key, {"shard": shard_path})
        progress.advance(window.end - window.begin)

    # more workers than cores only adds spawn and import cost (each worker
    # is a whole python process importing torch)
    n_workers = max(1, min(n_threads, os.cpu_count() or 1))
    use_processes = (n_workers > 1 and len(pending) > 1
                     and not getattr(args, "thread_workers", False))
    if use_processes:
        from concurrent.futures.process import BrokenProcessPool
        try:
            _run_process_pool(args, pending, shard_dir, n_workers, run_one,
                              finish)
        except BrokenProcessPool:
            # spawn re-imports the caller's __main__; an unguarded calling
            # script kills its own workers. Fall back to the in-process
            # pool (the journal skips completed windows).
            POOL.fallbacks += 1
            print("octopus-tpu-torch: process workers failed (is the calling "
                  "script missing an `if __name__ == '__main__'` guard?); "
                  "falling back to threads", file=sys.stderr)
            use_processes = False
            pending = [w for w in pending if w.key not in done]
    if not use_processes and n_threads > 1 and len(pending) > 1:
        # thread pool over windows; journal written as futures complete in
        # submission order (octopus.cpp:1226-1342 holdback-and-order design)
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=n_threads) as ex:
            for window, shard_path in ex.map(run_one, pending):
                finish(window, shard_path)
    elif not use_processes:
        for window in pending:
            finish(*run_one(window))
    # under the work queue, the last finisher merges the full set once every
    # host's windows are done (composable per-window shards, octopus.cpp:
    # 573-588, generalised across hosts)
    if queue is not None:
        if not queue.wait_all([w.key for w in windows], timeout_s=0.0):
            print("octopus-tpu-torch: other hosts still working; shards left "
                  "for the final finisher", file=sys.stderr)
            return 0
        for w in windows:
            if w.key not in done:
                res = queue.result(w.key)
                if res and res.get("result", {}).get("shard"):
                    done[w.key] = res["result"]["shard"]
    shard_paths = [done[w.key] for w in windows if w.key in done
                   and os.path.exists(done[w.key])]
    _reconcile_shards(windows, done, reference, header)
    merge_sorted(shard_paths, out_path, header,
                 _contig_order(reference, getattr(args, "contig_output_order",
                                                  "REFERENCE_INDEX")))
    if getattr(args, "keep_unfiltered_calls", False) and args.output:
        # copy of the calls with CSR FILTER decisions cleared
        # (option_collation.cpp:2431 keep-unfiltered-calls)
        unf_path = str(args.output) + ".unfiltered.vcf"
        reader = VcfReader(out_path)
        with VcfWriter(unf_path, reader.header) as w:
            for rec in reader:
                rec.filters = []
                w.write(rec)
        print(f"octopus-tpu-torch: unfiltered calls kept at {unf_path}",
              file=sys.stderr)
    if str(out_path).endswith(".gz"):
        # index the final bgzipped output, as the reference does
        # (vcf_utils::index_vcf on every written VCF, octopus.cpp)
        from .io.tabix import index_vcf
        index_vcf(out_path)
    if getattr(args, "data_profile", None):
        _run_data_profile(args, reference, bams, regions, out_path)
    if getattr(args, "bamout", None):
        # evidence-BAM pass over the final calls (octopus.cpp:1671-1708);
        # its read assignment scores on --device with the run's gate
        from .config.options import scoring_config
        from .core.tools.bam_realigner import run_bamout
        stats = run_bamout(out_path, reference, bams, samples, args.bamout,
                           bamout_type=getattr(args, "bamout_type", "MINI"),
                           scoring=scoring_config(args))
        print(f"octopus-tpu-torch: bamout {args.bamout}: "
              f"{stats['realigned']} realigned, "
              f"{stats['passthrough']} passthrough reads", file=sys.stderr)
    if args.output is None:
        sys.stdout.write(open(out_path).read())
        os.unlink(out_path)
    if not getattr(args, "keep_temporary_files", False):
        shutil.rmtree(shard_dir, ignore_errors=True)
    print(f"octopus-tpu-torch: completed {len(windows)} windows in "
          f"{time.time() - t0:.1f}s", file=sys.stderr)
    if timers.enabled:
        print(timers.report(), file=sys.stderr)
    return 0


def _run_process_pool(args, pending, shard_dir, n_workers, run_one, finish):
    """Call `pending` on a spawned process pool of CPU-only workers (the
    reference's thread scheduler maps to processes here because the host
    pipeline is python; octopus.cpp:1226-1342). The parent harvests results
    in completion order and runs ONLY the dense windows that workers
    decline (HeavyWindowDeferred), on its own device: a dense cluster costs
    seconds on the card and minutes on a CPU worker, and the parent taking
    light windows too would only oversubscribe the cores."""
    import concurrent.futures as cf
    import multiprocessing as mp
    from collections import deque
    from concurrent.futures import ProcessPoolExecutor
    from .utils import timers
    if getattr(args, "device", "cuda") == "cuda":
        # CUDA reads CUDA_VISIBLE_DEVICES when it starts: start it in the
        # parent before the workers' empty value is set below
        import torch
        from .device import resolve_device
        resolve_device("cuda")
        torch.cuda.init()
    window_of = {w.key: w for w in pending}
    env = {"CUDA_VISIBLE_DEVICES": "",
           "OCTOPUS_TPU_HOST_HMM_MAX": os.environ.get(
               "OCTOPUS_TPU_WORKER_HOST_HMM_MAX", "1000000000")}
    # the parent has changed into --working-directory already. Workers
    # decline dense windows (an active region of >= defer_heavy variants, or
    # a device-sized genotype reduction) so the card's parent runs them
    worker_args = dict(vars(args), device="cpu", working_directory=None,
                       defer_heavy=int(os.environ.get(
                           "OCTOPUS_TPU_DEFER_HEAVY_AT", "8")))
    todo = deque(pending)
    deferred = deque()
    inflight: set = set()

    def harvest(result):
        key, shard_path, tdelta = result
        if shard_path is None:          # worker declined: the parent runs it
            POOL.deferred_windows += 1
            deferred.append(window_of[key])
            return
        POOL.worker_windows += 1
        finish(window_of[key], shard_path)
        timers.merge(tdelta)

    # spawned workers inherit the environment they start in: no visible card
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        with ProcessPoolExecutor(
                max_workers=min(n_workers, len(pending)),
                mp_context=mp.get_context("spawn"),
                initializer=_process_worker_init,
                initargs=(worker_args, env)) as ex:
            def submit():
                w = todo.popleft()
                inflight.add(ex.submit(_process_worker_run,
                                       (w.contig, w.begin, w.end, w.key,
                                        shard_dir)))

            # two tasks in flight per worker: workers never idle while the
            # parent is busy inside a deferred window
            for _ in range(min(2 * n_workers, len(todo))):
                submit()
            while inflight or deferred:
                while deferred:
                    finish(*run_one(deferred.popleft()))
                if not inflight:
                    break
                done_futs, _ = cf.wait(inflight,
                                       return_when=cf.FIRST_COMPLETED)
                for f in done_futs:
                    inflight.discard(f)
                    harvest(f.result())
                    if todo:
                        submit()
    finally:
        if saved is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved


def _call_window(window, reference, bams, samples, pipe, csr, caller_cache,
                 caller_kind="individual", caller_config=None, cli_args=None,
                 refcall_mode=None, annotations=()):
    from .utils import timers
    pad = 200
    with timers.phase("bam_fetch"):
        per_sample = {}
        for bam in bams:
            got = bam.fetch(window.contig, max(window.begin - pad, 0),
                            window.end + pad)
            for s, batch in got.items():
                if len(batch):
                    per_sample.setdefault(s, []).append(batch)
    batches_by_sample = []
    raw_by_sample = []
    any_reads = False
    total_raw = total_kept = 0
    for s in samples:
        if per_sample.get(s):
            raw = ReadBatch.concatenate(per_sample[s]).sorted_by_begin()
            with timers.phase("read_pipe"):
                b, rep = pipe.process(raw)
            total_raw += rep.n_raw
            total_kept += rep.n_downsampled
            any_reads = any_reads or len(b) > 0
        else:
            raw = b = ReadBatch.empty(window.contig)
        raw_by_sample.append(raw)
        batches_by_sample.append(b)
    if not any_reads:
        return []
    from .readpipe.pipe import ReadPipeReport
    window_report = ReadPipeReport(n_raw=total_raw, n_downsampled=total_kept)
    caller = caller_cache.get(window.contig)
    if caller is None:
        caller = _make_caller(caller_kind, reference, window.contig, samples,
                              caller_config, cli_args)
        if cli_args is not None:
            from .basics.ploidy import PloidyMap
            pm = PloidyMap.parse(getattr(cli_args, "organism_ploidy", 2) or 2,
                                 getattr(cli_args, "contig_ploidies", None),
                                 getattr(cli_args, "contig_ploidies_file", None))
            caller.config.ploidy = pm.of(window.contig)
        caller_cache[window.contig] = caller
    if caller_kind == "trio":
        # reorder the raw (filtering) batches identically: facet/measure
        # sample indices must align with the trio-ordered genotypes
        batches_by_sample = _order_trio(batches_by_sample, samples, cli_args)
        raw_by_sample = _order_trio(raw_by_sample, samples, cli_args)
    with timers.phase("calling"):
        calls = caller.call(window.begin, window.end, batches_by_sample)
    merged = ReadBatch.concatenate([b for b in batches_by_sample if len(b)])
    records = []
    pairs = []
    kept_calls = [c for c in calls if c.begin < window.end]
    # facet bundles per phase-set block: shared lazily-computed context
    # (HMM read assignments, repeat context) for the measures
    # (facet_factory.hpp:28-79); phase length per block (phase_length.cpp)
    facet_of_call: dict[int, object] = {}
    phase_len_of_call: dict[int, int] = {}
    if csr is not None and kept_calls:
        # the reference filters with ALL well-formed reads by default;
        # --use-preprocessed-reads-for-filtering opts into the calling
        # pipeline's preprocessed set (cli.md:1543-1549)
        facet_reads = (batches_by_sample
                       if getattr(cli_args, "use_preprocessed_reads_for_filtering",
                                  False)
                       else raw_by_sample)
        with timers.phase("csr_facets"):
            facet_of_call, phase_len_of_call = _make_facet_bundles(
                kept_calls, window, reference, facet_reads, samples,
                caller.config.ploidy, caller.config.likelihood)
    else:
        facet_reads = batches_by_sample
    merged_csr = (merged if facet_reads is batches_by_sample
                  else ReadBatch.concatenate([b for b in facet_reads if len(b)]))
    for call in kept_calls:
        # keep seam overhang on the LEFT: a call can left-align below
        # window.begin (repeat-spanning indels); the shard reconciliation
        # pass resolves duplicates with the previous window
        # (resolve_connecting_calls, octopus.cpp:950-1015)
        record = site_call_to_record(call, window.contig, reference)
        pairs.append((call, record))
        if csr is not None:
            ref_lo = max(int(call.begin) - 120, 0)
            ref_hi = min(int(call.end) + 120,
                         reference.contig_size(window.contig))
            if facet_of_call.get(id(call)) is None:
                # CSR is on but this call has no facet bundle: the measures
                # will use pileup fallbacks — count it (auditability)
                from .core.csr import measures as _measures_mod
                _measures_mod.FACET_MISSES += 1
            with timers.phase("csr_measures"):
                measures = compute_measures(
                    call, merged_csr,
                    ref_codes=reference.fetch_codes(window.contig, ref_lo, ref_hi),
                    ref_begin=ref_lo, pipe_report=window_report,
                    reads_by_sample=facet_reads,
                    facets=facet_of_call.get(id(call)),
                    phase_length=phase_len_of_call.get(id(call)))
            rfgq = None
            if hasattr(csr, "classify_q"):
                failed, rfgq = csr.classify_q(
                    measures, somatic=bool(call.info.get("SOMATIC")),
                    denovo=bool(call.info.get("DENOVO")))
            else:
                failed = csr.classify(measures,
                                      somatic=bool(call.info.get("SOMATIC")),
                                      denovo=bool(call.info.get("DENOVO")))
            record.filters = failed if failed else ["PASS"]
            if rfgq is not None:
                if "RFGQ" not in record.format_keys:
                    record.format_keys.append("RFGQ")
                for sv in record.sample_values:
                    sv["RFGQ"] = round(rfgq, 2)
            for name in annotations:
                if name in measures and name not in record.info:
                    v = measures[name]
                    if v is None:
                        record.info[name] = "."   # missing measure (VCF spec)
                    else:
                        record.info[name] = round(v, 4) if isinstance(v, float) else v
        for k, v in call.info.items():
            record.info.setdefault(k, v)
        records.append(record)
    # NS/DP/MQ read stats from the calling reads
    # (vcf_record_factory.cpp:654-677)
    from .core.tools.vcf_record_factory import annotate_read_stats
    annotate_read_stats(pairs, batches_by_sample)
    apply_spanning_alleles(pairs)
    if refcall_mode:
        records.extend(_refcall_records(window, reference, merged, calls,
                                        samples, refcall_mode, cli_args))
        records.sort(key=lambda r: r.pos)
    return records


def _run_data_profile(args, reference, bams, regions, vcf_path) -> None:
    """--data-profile: indel-error-rate CSV over the called regions
    (reference run_data_profiler, octopus.cpp:1710-1730)."""
    from .core.tools.indel_profiler import profile_indels
    called: dict[str, set[int]] = {}
    for rec in VcfReader(vcf_path):
        if any(len(a) != len(rec.ref) for a in rec.alts):
            called.setdefault(rec.chrom, set()).add(rec.pos - 1)
    profiles = []
    for contig, begin, end in regions:
        batches = []
        for bam in bams:
            for batch in bam.fetch(contig, begin, end).values():
                if len(batch):
                    batches.append(batch)
        if not batches:
            continue
        merged = ReadBatch.concatenate(batches)
        profiles.append(profile_indels(reference, contig, merged, begin, end,
                                       called.get(contig)))
    if profiles:
        total = profiles[0]
        for p in profiles[1:]:
            for k, (sp, er) in p.counts.items():
                c = total.counts.setdefault(k, [0, 0])
                c[0] += sp
                c[1] += er
        total.write_csv(args.data_profile)


def _order_trio(batches, samples, cli_args):
    """Reorder per-sample batches to [maternal, paternal, child] from
    --maternal-sample/--paternal-sample flags or a --pedigree PED file."""
    maternal = getattr(cli_args, "maternal_sample", None) if cli_args else None
    paternal = getattr(cli_args, "paternal_sample", None) if cli_args else None
    ped_path = getattr(cli_args, "pedigree", None) if cli_args else None
    if (not maternal or not paternal) and ped_path:
        from .io.pedigree import Pedigree
        trio = Pedigree.read(ped_path).find_trio(samples)
        if trio is not None:
            maternal, paternal = trio.maternal, trio.paternal
    if maternal in samples and paternal in samples:
        child = next(s for s in samples if s not in (maternal, paternal))
        order = [samples.index(maternal), samples.index(paternal),
                 samples.index(child)]
        return [batches[i] for i in order]
    return batches


def _make_facet_bundles(calls, window, reference, batches_by_sample,
                        samples, ploidy, scoring=None):
    """One FacetBundle per phase-set block of calls, plus per-call phase
    lengths (FacetFactory blocks, facet_factory.hpp:28-79). `scoring` is
    the run's LikelihoodConfig: read assignment runs on its device."""
    from .core.csr.facets import FacetBlock, FacetBundle
    blocks: dict = {}
    for c in calls:
        key = c.phase_set if c.phase_set is not None else c.begin
        blocks.setdefault(key, []).append(c)
    facet_of_call: dict[int, object] = {}
    phase_len: dict[int, int] = {}
    for group in blocks.values():
        begin = min(c.begin for c in group)
        end = max(max(c.end, c.begin + 1) for c in group)
        span = end - begin
        variants = [c.alts[0] for c in group if c.alts]
        genotypes = []
        for s in range(len(batches_by_sample)):
            genotypes.append([
                (c.genotypes[s] if c.genotypes and s < len(c.genotypes)
                 else [0] * ploidy)
                for c in group if c.alts])
        bundle = FacetBundle(FacetBlock(
            contig=window.contig, begin=begin, end=end,
            variants=variants, genotypes=genotypes,
            reads_by_sample=batches_by_sample, samples=list(samples),
            reference=reference, ploidy=ploidy,
            site_alts=[list(c.alts) for c in group if c.alts],
            scoring=scoring))
        for c in group:
            facet_of_call[id(c)] = bundle
            phase_len[id(c)] = span
    _precompute_read_assignments(set(facet_of_call.values()), scoring)
    return facet_of_call, phase_len


def _precompute_read_assignments(bundles, scoring=None) -> None:
    """Batch all facet bundles' HMM read-assignment jobs into one grouped
    evaluation on the device of `scoring` (scores identical to the lazy
    per-block path; the merge amortises per-block host overhead and yields
    device-sized batches). When one block's haplotype is too short to
    band-align a read, the bundles keep their lazy per-block computation,
    which confines that failure to its block; any other error, a scorer,
    kernel or torch.cuda one included, ends the run."""
    from .core.likelihood.likelihood_array import ShortHaplotypeError
    from .core.tools.read_assigner import assign_reads_grouped
    from .utils import timers
    jobs, slots = [], []
    for bundle in bundles:
        lo, _ = bundle.reference_context
        for si, (b, haps) in enumerate(
                zip(bundle.overlapping_reads,
                    bundle.called_haplotypes_by_sample)):
            if len(b):
                jobs.append((b, haps, lo))
                slots.append((bundle, si))
    if not jobs:
        return
    try:
        with timers.phase("read_assignment"):
            assignments = assign_reads_grouped(jobs, scoring=scoring)
    except ShortHaplotypeError:
        return
    per_bundle: dict[int, dict] = {}
    for (bundle, si), a in zip(slots, assignments):
        per_bundle.setdefault(id(bundle), {})[si] = a
    for bundle in bundles:
        d = per_bundle.get(id(bundle), {})
        bundle.__dict__["read_assignments"] = [
            d.get(si) for si in range(len(bundle.block.samples))]


def _reconcile_shards(windows, done, reference, header) -> None:
    """Resolve seam conflicts between adjacent completed windows' shards
    (resolve_connecting_calls, octopus.cpp:950-1015): rewrite both shard
    files whenever the boundary trimmed either side."""
    from .core.tools.reconcile import resolve_connecting_records
    ordered = [w for w in windows if w.key in done
               and os.path.exists(done[w.key])]
    for lhs_w, rhs_w in zip(ordered, ordered[1:]):
        if lhs_w.contig != rhs_w.contig:
            continue
        lhs_recs = list(VcfReader(done[lhs_w.key]))
        rhs_recs = list(VcfReader(done[rhs_w.key]))
        if not lhs_recs or not rhs_recs:
            continue

        def fetch_base(pos0, contig=lhs_w.contig):
            from .basics.sequence import decode_sequence
            return decode_sequence(
                reference.fetch_codes(contig, pos0, pos0 + 1)) or "N"

        new_lhs, new_rhs = resolve_connecting_records(
            lhs_recs, rhs_recs, fetch_base)
        if len(new_lhs) != len(lhs_recs):
            with VcfWriter(done[lhs_w.key], header) as w:
                for r in new_lhs:
                    w.write(r)
        if new_rhs != rhs_recs:
            with VcfWriter(done[rhs_w.key], header) as w:
                for r in new_rhs:
                    w.write(r)


def _refcall_records(window, reference, batch, calls, samples, mode,
                     args=None):
    from .io.vcf import VcfRecord
    from .basics.sequence import decode_sequence
    import numpy as np
    ref_codes = reference.fetch_codes(window.contig, window.begin, window.end)
    called_mask = np.zeros(window.end - window.begin, bool)
    for c in calls:
        lo = max(c.begin - window.begin, 0)
        hi = min(max(c.end, c.begin + 1) - window.begin, len(called_mask))
        called_mask[lo:hi] = True
    # --refcall-block-merge-quality / --max-refcall-posterior
    # (option_collation.cpp:2179-2188)
    cfg = RefcallConfig(mode=mode)
    if args is not None:
        merge_q = getattr(args, "refcall_block_merge_quality", None)
        if merge_q is not None:
            cfg.block_quality_quantum = max(int(merge_q), 1)
        max_post = getattr(args, "max_refcall_posterior", None)
        if max_post is not None:
            cfg.max_quality = int(max_post)
    blocks = make_refcall_blocks(batch, window.begin, window.end, ref_codes,
                                 called_mask, cfg)
    out = []
    for b in blocks:
        base = decode_sequence(ref_codes[b.begin - window.begin:
                                         b.begin - window.begin + 1])
        out.append(VcfRecord(
            chrom=window.contig, pos=b.begin + 1, id="", ref=base or "N",
            alts=[], qual=float(b.quality), filters=["PASS"],
            info={"END": b.end},
            format_keys=["GT", "GQ", "DP"],
            sample_values=[{"GT": "0|0", "GQ": b.quality, "DP": b.min_depth}
                           for _ in samples],
        ))
    return out


__all__ = ["run_calling", "propose_windows", "parse_region"]
