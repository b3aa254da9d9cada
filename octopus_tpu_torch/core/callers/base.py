"""Generic caller pipeline.

Capability-equivalent to the reference's abstract Caller
(src/core/callers/caller.{hpp,cpp}): owns the window algorithm —
candidate generation, active-region proposal, haplotype enumeration,
likelihood population, latent inference (subclass hook), and call
construction (subclass hook).  Subclasses: individual, population, trio,
cancer, polyclone, cell.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from dataclasses import dataclass, field

import numpy as np

from ..._build import require_native
from ...device import resolve_device
from ...errors import HeavyWindowDeferred
from ...logging_.progress import TRACE

_log = logging.getLogger("octopus_tpu_torch")

from ...basics.phred import LN10_DIV_10
from ...utils import timers
from ...basics.reads import ReadBatch
from ..hapgen.generator import (
    enumerate_haplotypes,
    group_exclusive_sites,
    propose_active_regions,
)
from ..likelihood.likelihood_array import (ROUTING,
                                           FlankState,
                                           HaplotypeLikelihoodArray,
                                           LikelihoodConfig,
                                           ShortHaplotypeError,
                                           select_band)
from ..models.coalescent import CoalescentModel, CoalescentParams
from ..models.individual import logsumexp
from ..tools.phaser import Phaser
from ..types.haplotypes import Haplotype
from ..types.variants import Variant
from ..vargen.cigar_scanner import ScannerOptions
from ..vargen.generator import VariantGenerator, VariantGeneratorConfig
from ..vargen.assembler import AssemblerOptions


@dataclass
class BaseCallerConfig:
    ploidy: int = 2
    min_variant_posterior_phred: float = 0.1
    max_haplotypes: int = 200
    snp_heterozygosity: float = 0.001
    snp_heterozygosity_stdev: float = 0.01
    indel_heterozygosity: float = 0.0001
    haplotype_pad: int = 30
    likelihood: LikelihoodConfig = field(default_factory=LikelihoodConfig)
    scanner: ScannerOptions = field(default_factory=ScannerOptions)
    use_assembler: bool = False
    use_pileup_scanner: bool = True
    use_repeat_scanner: bool = True
    assembler: AssemblerOptions = field(default_factory=AssemblerOptions)
    source_vcf: str | None = None
    min_source_candidate_quality: float | None = None
    read_linkage: str = "paired"      # none | paired | linked (AlignedTemplate joint scoring)
    # haplotype generation limits (haplotype_generator.hpp:44-52 + CLI overrides)
    haplotype_holdout_threshold: int = 2500
    haplotype_overflow: int = 200000
    max_holdout_depth: int = 20
    lagging_level: str = "moderate"   # none|conservative|moderate|optimistic|aggressive
    extension_level: str = "moderate"
    backtrack_level: str = "none"
    protect_reference_haplotype: bool = True
    min_protected_haplotype_posterior: float = 1e-10
    # genotype model limits
    use_uniform_genotype_priors: bool = False
    max_genotypes: int | None = None
    max_genotype_combinations: int | None = None
    max_vb_seeds: int = 12
    # phasing / region control
    min_phase_score: float = 5.0
    bad_region_tolerance: str = "normal"
    model_posterior_policy: str = "all"
    region_merge_distance: int | None = None   # default: read-length scale
    # --phasing-policy (option_parser.cpp:595-597): CONSERVATIVE holds
    # active regions together longer (2x merge distance) for cross-site
    # phasing; AGGRESSIVE/AUTO-diploid keep the early-splitting default
    # (get_phase_detection_policy, option_collation.cpp:2148-2158)
    phasing_policy: str = "auto"
    # --use-independent-genotype-priors (option_collation.cpp:1157-1163)
    use_independent_genotype_priors: bool = False
    # --use-filtered-source-candidates (vcf_extractor.hpp extract_filtered)
    use_filtered_source_candidates: bool = False
    # --target-working-memory caps the model-evaluation chunk working set
    # (option_parser.cpp:130-136 'not strictly enforced')
    target_working_memory: int | None = None
    use_device: bool = True
    # torch device of the pair-HMM and genotype reductions. The caller
    # copies it into likelihood.device, whatever that held: set the device
    # here, not there. use_device=False keeps genotype reductions on the
    # host whatever their size.
    device: str = "cuda"
    # a CPU-only pool worker's: hand the window back to the card's parent
    # (HeavyWindowDeferred) at an active region of this many variants or at
    # a genotype reduction of device size; 0 never does
    defer_heavy: int = 0


@dataclass
class SiteCall:
    """One called site (possibly multi-allelic), all samples."""

    begin: int
    end: int
    alts: list[Variant]
    quality: float
    genotypes: list[list[int]]        # per sample: allele index per haplotype
    genotype_qualities: list[float]   # per sample GQ
    phase_set: int
    alt_qualities: list[float]
    info: dict = field(default_factory=dict)
    # phred quality of the phase set this site belongs to (phaser.cpp
    # phase-set quality; emitted as FORMAT/PQ, vcf_record_factory.cpp:681)
    phase_quality: float | None = None
    # per-sample model posterior, phred of P(model wrong) — FORMAT MP
    # (caller.cpp:975-996 set_model_posteriors; emitted
    # vcf_record_factory.cpp:684-690); joint MP rides info["MP"]
    model_posteriors: list[float] | None = None

    # single-sample conveniences
    @property
    def genotype(self) -> list[int]:
        return self.genotypes[0]

    @property
    def genotype_quality(self) -> float:
        return self.genotype_qualities[0]


@dataclass
class ActiveRegionContext:
    begin: int
    end: int
    variants: list[Variant]
    haplotypes: list[Haplotype]
    lnL: list[np.ndarray]             # per sample (H, R)
    prior_model: CoalescentModel
    contains: np.ndarray              # (n_variants, H) bool


class CallerBase:
    """Shared window pipeline; subclasses implement _infer_and_call."""

    config: BaseCallerConfig

    def __init__(self, reference, contig: str, config: BaseCallerConfig):
        self.reference = reference
        self.contig = contig
        resolve_device(config.device)
        require_native()
        self.config = dataclasses.replace(
            config, likelihood=dataclasses.replace(config.likelihood,
                                                   device=config.device))

    # -- pipeline ----------------------------------------------------------

    def call(self, region_begin: int, region_end: int,
             reads_by_sample: list[ReadBatch]) -> list[SiteCall]:
        cfg = self.config
        vargen = VariantGenerator(
            self.reference, self.contig,
            VariantGeneratorConfig(scanner=cfg.scanner,
                                   use_pileup_scanner=cfg.use_pileup_scanner,
                                   use_assembler=cfg.use_assembler,
                                   use_repeat_scanner=cfg.use_repeat_scanner,
                                   assembler=cfg.assembler,
                                   source_vcf=cfg.source_vcf,
                                   min_source_quality=cfg.min_source_candidate_quality,
                                   use_filtered_source=cfg.use_filtered_source_candidates))
        with timers.phase("vargen"):
            for s, batch in enumerate(reads_by_sample):
                vargen.add_reads(s, batch)
            candidates = vargen.generate(region_begin, region_end)
        ROUTING.record_candidates(len(candidates))
        if not candidates:
            return []
        from ..tools.bad_region_detector import (BadRegionConfig, Severity,
                                                 assess_region, median_depth)
        bad_region_config = BadRegionConfig.from_tolerance(cfg.bad_region_tolerance)
        calls: list[SiteCall] = []
        # raw (haplotype, read) scores shared between beam pruning rounds and
        # the final likelihood populate of each region (one window's worth)
        self._score_cache: dict = {}
        if _log.isEnabledFor(logging.DEBUG):
            _log.debug("window %s:%d-%d: %d reads, %d candidates",
                       self.contig, region_begin, region_end,
                       sum(len(b) for b in reads_by_sample), len(candidates))
            if _log.isEnabledFor(TRACE):
                for v in candidates:
                    _log.log(TRACE, "  candidate %s", v)
        merge_distance = cfg.region_merge_distance
        if merge_distance is None:
            # phasing range: variants joinable by one read (or one fragment
            # under paired/linked linkage) share an active region — the role
            # of the reference's haplotype-tree lagging across windows
            merge_distance = 350 if cfg.read_linkage in ("paired", "linked") else 150
            # --phasing-policy (get_phase_detection_policy,
            # option_collation.cpp:2148-2158): early phase splitting is off
            # for CONSERVATIVE, and off automatically for polyploid or
            # barcode-linked runs; regions then merge across longer spans so
            # sites stay jointly phased
            policy = getattr(cfg, "phasing_policy", "auto")
            early_split = (policy == "aggressive"
                           or (policy == "auto" and cfg.ploidy < 3
                               and cfg.read_linkage != "linked"))
            if not early_split:
                merge_distance *= 2
        # CPU worker processes hand HEAVY windows back to the TPU-owning
        # parent: a dense candidate cluster means beam growth + big
        # populates + big genotype reductions — seconds on the accelerator,
        # minutes on a worker (the 10 Mb heavy-tail, BASELINE.md round 4).
        # The threshold is variants-per-active-region; 0 disables.
        defer_at = cfg.defer_heavy
        regions_list = propose_active_regions(
            candidates, merge_distance=merge_distance,
            max_variants_per_region=None)
        if defer_at and any(len(vs) >= defer_at for _, _, vs in regions_list):
            raise HeavyWindowDeferred(region_begin, region_end)
        # per-sample typical depths, once per window (the reference keeps a
        # per-sample average_depths map, bad_region_detector.hpp:71):
        # pooling multi-sample reads against one sample's typical depth
        # would misread every N-sample region as an N-fold depth spike
        typical_by_sample = ([median_depth(b) if len(b) else 0.0
                              for b in reads_by_sample]
                             if bad_region_config is not None else None)
        def too_bad(begin, end, variants) -> bool:
            """Whether the region's reads are so bad that its candidates
            are erased (caller.cpp:185-199)."""
            severity = Severity.NONE
            if bad_region_config is not None:
                for b, typ in zip(reads_by_sample, typical_by_sample):
                    if len(b):
                        s = assess_region(b, begin, end, len(variants),
                                          typ, bad_region_config)
                        if s.value > severity.value:
                            severity = s
            return severity == Severity.HIGH

        for begin, end, variants in regions_list:
            if len(variants) > self.MAX_DIRECT_VARIANTS:
                # dense super-region: step the stateful generator through it
                # (lagging keeps cross-window phase; holdout/backtrack bound
                # the tree, haplotype_generator.hpp:60-160); each of its
                # packets is an active_region phase
                if not too_bad(begin, end, variants):
                    calls.extend(self._call_with_generator(variants,
                                                           reads_by_sample))
                continue
            with timers.phase("active_region"):
                if too_bad(begin, end, variants):
                    continue
                ctx = self._build_context(begin, end, variants, reads_by_sample,
                                          all_candidates=candidates)
                if ctx is not None:
                    with timers.phase("infer_latents"):
                        new_calls = self._infer_and_call(ctx)
                    self._debug_dump_region(ctx, new_calls)
                    calls.extend(new_calls)
        calls.sort(key=lambda c: (c.begin, c.end))
        return calls

    MAX_DIRECT_VARIANTS = 24

    def _debug_dump_region(self, ctx, new_calls) -> None:
        """--debug/--trace region dumps (the reference's debug::print_*
        helpers, caller.cpp:228-284): active region, haplotype/read counts,
        per-call genotypes and qualities; TRACE adds haplotype variants."""
        if not _log.isEnabledFor(logging.DEBUG):
            return
        _log.debug("region %s:%d-%d: %d variants, %d haplotypes, reads/sample %s",
                   self.contig, ctx.begin, ctx.end, len(ctx.variants),
                   len(ctx.haplotypes),
                   [m.shape[1] for m in ctx.lnL])
        if _log.isEnabledFor(TRACE):
            for i, h in enumerate(ctx.haplotypes):
                _log.log(TRACE, "  hap %d: %s", i,
                         [str(v) for v in h.variants] or "<ref>")
        for c in new_calls:
            _log.debug("  call %d-%d %s gt=%s q=%.2f %s", c.begin, c.end,
                       [str(v) for v in c.alts], c.genotypes, c.quality,
                       c.info or "")

    def _call_with_generator(self, variants, reads_by_sample) -> list[SiteCall]:
        from ..hapgen.haplotype_generator import (GeneratorLimits,
                                                  HaplotypeGenerator)
        cfg = self.config
        fetch = lambda b, e: self.reference.fetch_codes(self.contig, b, e)
        active_all = [b.overlapping(min(v.begin for v in variants) - 500,
                                    max(v.end for v in variants) + 500)
                      for b in reads_by_sample]
        gen = HaplotypeGenerator(
            variants, fetch, active_all,
            GeneratorLimits(target=cfg.max_haplotypes,
                            holdout=cfg.haplotype_holdout_threshold,
                            overflow=cfg.haplotype_overflow,
                            max_holdout_depth=cfg.max_holdout_depth,
                            lagging_level=cfg.lagging_level,
                            extension_level=cfg.extension_level,
                            backtrack_level=cfg.backtrack_level),
            likelihood_config=cfg.likelihood)
        calls: list[SiteCall] = []
        called_spans: list[tuple[int, int]] = []
        while not gen.done():
            # the tree: walker, holdout, path extension and its pruning
            # rounds, lagging, Haplotype.build
            with timers.phase("hapgen_tree"):
                packet = gen.generate()
            if packet is None:
                break
            ROUTING.record_packet()
            with timers.phase("active_region"):
                ctx = self._context_from_haplotypes(
                    packet.haplotypes, packet.variants, reads_by_sample,
                    all_candidates=variants,
                    active_begin=packet.active_begin,
                    active_end=packet.active_end)
                if ctx is None:
                    continue
                with timers.phase("infer_latents"):
                    new_calls = self._infer_and_call(ctx)
                self._debug_dump_region(ctx, new_calls)
                for c in new_calls:
                    # indicators re-call lagged sites; keep the first emission
                    if any(c.begin < e and c.end > b for b, e in called_spans):
                        continue
                    calls.append(c)
                    called_spans.append((c.begin, c.end))
        return calls

    def _flank_state(self, hap_begin, hap_end, active_begin, active_end,
                     candidates) -> FlankState | None:
        if not self.config.likelihood.use_flank_state:
            return None
        return calculate_flank_state(hap_begin, hap_end, active_begin,
                                     active_end, candidates)

    def _context_from_haplotypes(self, haplotypes, variants,
                                 reads_by_sample, all_candidates=None,
                                 active_begin=None,
                                 active_end=None) -> ActiveRegionContext | None:
        if len(haplotypes) < 2:
            return None
        hap_begin = haplotypes[0].begin
        hap_end = haplotypes[0].end
        active = [b.overlapping(hap_begin, hap_end) for b in reads_by_sample]
        if all(len(b) == 0 for b in active):
            return None
        flank = None
        if active_begin is not None:
            flank = self._flank_state(hap_begin, hap_end, active_begin,
                                      active_end, all_candidates or variants)
        try:
            return self._finish_context(hap_begin, hap_end, variants,
                                        haplotypes, active, flank_state=flank)
        except ShortHaplotypeError:
            # skip the region, as the reference does (caller.cpp:1182-1188)
            return None

    def _build_context(self, begin, end, variants, reads_by_sample,
                       all_candidates=None) -> ActiveRegionContext | None:
        cfg = self.config
        pad = cfg.likelihood.max_indel_error
        active = [b.overlapping(begin, end) for b in reads_by_sample]
        if all(len(b) == 0 for b in active):
            return None
        lo = min([int(b.begins.min()) for b in active if len(b)] + [begin])
        hi = max([int(b.ends.max()) for b in active if len(b)] + [end])
        hap_begin = max(lo - (pad + cfg.haplotype_pad), 0)
        hap_end = min(hi + (pad + cfg.haplotype_pad),
                      self.reference.contig_size(self.contig))
        fetch = lambda b, e: self.reference.fetch_codes(self.contig, b, e)
        n_options = 1
        for g in group_exclusive_sites(variants):
            n_options *= len(g) + 1
        # inactive candidates from NEIGHBOURING active regions can fall
        # inside this context's haplotype span (reads extend it); discount
        # their mismatches via the flank state (caller.cpp:1121-1157)
        flank = self._flank_state(hap_begin, hap_end, begin, end,
                                  all_candidates or variants)
        band = select_band(variants, cfg.likelihood.max_indel_error)
        if n_options > cfg.max_haplotypes:
            from ..hapgen.beam import grow_haplotypes_beam
            with timers.phase("hapgen_beam"):
                haplotypes = grow_haplotypes_beam(
                    hap_begin, hap_end, variants, fetch, active,
                    cfg.max_haplotypes, cfg.likelihood,
                    cache=getattr(self, "_score_cache", None),
                    flank_state=flank, pad=band)
        else:
            haplotypes = enumerate_haplotypes(hap_begin, hap_end, variants,
                                              fetch, cfg.max_haplotypes)
        if len(haplotypes) < 2:
            return None
        try:
            return self._finish_context(begin, end, variants, haplotypes,
                                        active, flank_state=flank, pad=band)
        except ShortHaplotypeError:
            return None

    def _finish_context(self, begin, end, variants, haplotypes,
                        active, flank_state=None,
                        pad=None) -> ActiveRegionContext | None:
        cfg = self.config
        hap_begin = haplotypes[0].begin
        hap_end = haplotypes[0].end
        fetch = lambda b, e: self.reference.fetch_codes(self.contig, b, e)
        lik = HaplotypeLikelihoodArray(cfg.likelihood)
        with timers.phase("likelihood_populate"):
            lik.populate(active, [h.sequence for h in haplotypes], hap_begin,
                         flank_state=flank_state,
                         substitution_masks=[h.substitution_mask() for h in haplotypes],
                         cache=getattr(self, "_score_cache", None),
                         pad=pad if pad is not None
                         else select_band(variants, cfg.likelihood.max_indel_error))
        matrices = [lik.sample_matrix(s) for s in range(len(active))]
        if cfg.read_linkage in ("paired", "linked"):
            # AlignedTemplate joint scoring: linked reads' log-likelihoods sum
            # (haplotype_likelihood_model.cpp:306-311)
            matrices = [_link_template_columns(m, active[s])
                        for s, m in enumerate(matrices)]
        ref_hap = next((h for h in haplotypes if not h.variants), None)
        if ref_hap is None:
            ref_hap = Haplotype.build(hap_begin, hap_end, [], fetch)
        prior_model = CoalescentModel(
            ref_hap,
            CoalescentParams(cfg.snp_heterozygosity, cfg.indel_heterozygosity),
            indel_error_model=lik._indel_model,
        )
        prior_model.prime(haplotypes)
        contains = np.zeros((len(variants), len(haplotypes)), dtype=bool)
        for vi, v in enumerate(variants):
            for hi_, h in enumerate(haplotypes):
                contains[vi, hi_] = h.contains(v)
        return ActiveRegionContext(
            begin=begin, end=end, variants=list(variants), haplotypes=haplotypes,
            lnL=matrices,
            prior_model=prior_model, contains=contains,
        )

    # -- genotype proposal (with explosion guard) --------------------------

    def propose_genotypes(self, ctx: ActiveRegionContext, ploidy: int,
                          lnL: np.ndarray) -> np.ndarray:
        """All genotypes of `ploidy`, or the max-zygosity seeded reduction
        when the count exceeds --max-genotypes
        (IndividualCaller::propose_genotypes,
        individual_caller.cpp:699-752): start at the largest ploidy whose
        full enumeration fits, then repeatedly keep the top posterior
        genotypes as seeds and extend them by every haplotype until the
        target ploidy, always retaining the hom-ref genotype."""
        from ..models.individual import IndividualModel
        from ..types.genotypes import generate_all_genotypes, num_genotypes
        cfg = self.config
        H = len(ctx.haplotypes)
        cap = cfg.max_genotypes
        if cap is None or num_genotypes(H, ploidy) <= cap:
            return generate_all_genotypes(H, ploidy)
        p = ploidy - 1
        while p > 1 and num_genotypes(H, p) > cap:
            p -= 1
        result = generate_all_genotypes(H, p)
        model = IndividualModel(ctx.prior_model,   # has evaluate_many
                                use_device=cfg.use_device, device=cfg.device,
                                defer_device=cfg.defer_heavy > 0)
        ref_idx = next((i for i, h in enumerate(ctx.haplotypes)
                        if not h.variants), None)
        while p < ploidy:
            log_post = model.evaluate(result, lnL).log_posteriors
            order = np.argsort(log_post)                  # ascending
            result = result[order]
            chunks: list[np.ndarray] = []
            built = 0
            for _ in range(3):
                if built >= cap or len(result) == 0:
                    break
                num_seeds = max((cap - built) // max(H, 1), 1)
                num_seeds = min(num_seeds, len(result))
                seeds = result[len(result) - num_seeds:]
                # keep the hom-ref genotype among the seeds (QUAL sanity,
                # individual_caller.cpp:736-741)
                if ref_idx is not None:
                    hom_ref = np.full(p, ref_idx)
                    if not (seeds == hom_ref).all(axis=1).any():
                        where = np.nonzero(
                            (result[:len(result) - num_seeds]
                             == hom_ref).all(axis=1))[0]
                        if len(where):
                            seeds = np.concatenate(
                                [seeds[1:], result[where[:1]]])
                chunks.append(extend_genotypes(seeds, H))
                built = len(np.unique(np.concatenate(chunks), axis=0))
                result = result[:len(result) - num_seeds]
            result = np.unique(np.concatenate(chunks), axis=0)
            p += 1
        return result

    # -- subclass hook -----------------------------------------------------

    def _infer_and_call(self, ctx: ActiveRegionContext) -> list[SiteCall]:
        raise NotImplementedError

    # -- shared call assembly ----------------------------------------------

    @staticmethod
    def make_site_alleles(ctx: ActiveRegionContext,
                          site_groups: list[list[Variant]]) -> np.ndarray:
        site_alleles = np.zeros((len(site_groups), len(ctx.haplotypes)), np.int32)
        for si, group in enumerate(site_groups):
            for gi, v in enumerate(group):
                site_alleles[si][ctx.contains[ctx.variants.index(v)]] = gi + 1
        return site_alleles


def calculate_flank_state(hap_begin: int, hap_end: int, active_begin: int,
                          active_end: int, candidates) -> FlankState | None:
    """Flank sizes from the haplotype-region overhang and the INACTIVE
    candidates it contains, mirroring calculate_flank_regions
    (caller.cpp:1121-1157): a flank only exists up to the furthest candidate
    variant not represented by the active haplotypes — mismatches there are
    plausibly real variation and must not be charged to the haplotype.
    Returns None when both flanks are empty."""
    lhs_b, lhs_e = hap_begin, max(active_begin, hap_begin)
    rhs_b, rhs_e = min(active_end, hap_end), hap_end

    def contained(b, e):
        return [v for v in candidates if v.begin >= b and v.end <= e]

    active = contained(active_begin, active_end)
    if not active:
        return None
    leftmost = min(active, key=lambda v: (v.begin, v.end))
    rightmost = max(active, key=lambda v: (v.begin, v.end))
    # boundary insertions (empty regions) stay active (caller.cpp:1129-1131)
    if leftmost.begin == leftmost.end and lhs_e > lhs_b:
        lhs_e -= 1
    lhs_inactive = contained(lhs_b, lhs_e)
    lhs_size = (max(lhs_inactive, key=lambda v: (v.begin, v.end)).end
                - hap_begin) if lhs_inactive else 0
    if rightmost.begin == rightmost.end and rhs_e > rhs_b:
        rhs_b += 1
    rhs_inactive = contained(rhs_b, rhs_e)
    rhs_size = (hap_end
                - min(rhs_inactive, key=lambda v: (v.begin, v.end)).begin
                ) if rhs_inactive else 0
    if lhs_size <= 0 and rhs_size <= 0:
        return None
    return FlankState(max(lhs_size, 0), max(rhs_size, 0))


def _link_template_columns(lnL: np.ndarray, batch) -> np.ndarray:
    """Sum likelihood columns of reads sharing a template (read name)."""
    if batch.name_hashes is None or lnL.shape[1] == 0:
        return lnL
    _, inverse = np.unique(batch.name_hashes, return_inverse=True)
    n_templates = int(inverse.max()) + 1
    out = np.zeros((lnL.shape[0], n_templates))
    np.add.at(out, (slice(None), inverse), lnL)
    return out


def model_posterior_phred(normal_log_evidence: float,
                          dummy_log_evidence: float,
                          noise_log_evidence: float | None = None) -> float:
    """Phred-scaled model posterior from competing model evidences.

    Mirrors the static calculate_model_posterior shared by the callers
    (individual_caller.cpp:168-177, population_caller.cpp:230-239,
    trio_caller.cpp:444-453, cancer_caller.cpp:208-230): the used model
    carries prior 0.9999999 and the higher-capacity dummy model 1e-7;
    with a noise model the normaliser takes max(dummy, noise)
    (cancer_caller.cpp:219-230).  The emitted value is
    probability_false_to_phred(1 - mp) (caller.cpp:984-989)."""
    ln_normal = math.log(0.9999999) + normal_log_evidence
    ln_dummy = math.log(1.0 - 0.9999999) + dummy_log_evidence
    if noise_log_evidence is not None:
        ln_dummy = max(ln_dummy,
                       math.log(1.0 - 0.9999999) + noise_log_evidence)
    norm = logsumexp(np.asarray([ln_normal, ln_dummy]))
    mp = math.exp(ln_normal - norm)
    return -10.0 * math.log10(max(1.0 - mp, 1e-300))


def extend_genotypes(seeds: np.ndarray, n_haplotypes: int) -> np.ndarray:
    """All distinct ploidy+1 genotypes obtained by appending one haplotype
    to each seed genotype (genotype.hpp extend; used by the model-check
    genotype proposals, individual_caller.cpp:755-767)."""
    seeds = np.asarray(seeds)
    if seeds.ndim == 1:
        seeds = seeds[None, :]
    K, P = seeds.shape
    rep = np.repeat(seeds, n_haplotypes, axis=0)              # (K*H, P)
    add = np.tile(np.arange(n_haplotypes), K)[:, None]        # (K*H, 1)
    out = np.sort(np.concatenate([rep, add], axis=1), axis=1)
    return np.unique(out, axis=0)


def phred_not(log_posts: np.ndarray) -> float:
    """phred(P(none of these)) from log posteriors of the complement set."""
    if len(log_posts) == 0:
        return math.inf
    lse = min(logsumexp(log_posts), 0.0)
    return -lse / LN10_DIV_10


__all__ = [
    "CallerBase",
    "BaseCallerConfig",
    "SiteCall",
    "ActiveRegionContext",
    "phred_not",
    "model_posterior_phred",
    "extend_genotypes",
]
