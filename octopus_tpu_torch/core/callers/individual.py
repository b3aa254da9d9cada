"""Individual (single-sample germline) caller.

Capability-equivalent to the reference's IndividualCaller
(src/core/callers/individual_caller.cpp):

* variant posterior: phred of the total posterior mass of genotypes NOT
  containing the alt allele (individual_caller.cpp:242-266),
* called iff posterior >= min threshold and the alt is in the MAP genotype,
* per-site genotype call and GQ from the posterior mass of genotypes whose
  allele multiset at the site matches the MAP chunk,
* phase sets from the Phaser over genotype posteriors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...basics.reads import ReadBatch
from ..hapgen.generator import group_exclusive_sites
from ..models.individual import IndividualModel
from ..tools.phaser import Phaser, PhaserConfig
from .base import (
    ActiveRegionContext,
    BaseCallerConfig,
    CallerBase,
    SiteCall,
    extend_genotypes,
    model_posterior_phred,
    phred_not,
)

# Back-compat alias: the public config for this caller
CallerConfig = BaseCallerConfig


class IndividualCaller(CallerBase):
    def __init__(self, reference, contig: str, config: BaseCallerConfig | None = None):
        super().__init__(reference, contig, config or BaseCallerConfig())

    def call(self, region_begin: int, region_end: int, reads) -> list[SiteCall]:
        if isinstance(reads, ReadBatch):
            reads = [reads]
        return super().call(region_begin, region_end, reads)

    def _infer_and_call(self, ctx: ActiveRegionContext) -> list[SiteCall]:
        cfg = self.config
        genotypes = self.propose_genotypes(ctx, cfg.ploidy, ctx.lnL[0])
        model = IndividualModel(_PriorAdapter(ctx.prior_model),
                                use_device=cfg.use_device, device=cfg.device,
                                defer_device=cfg.defer_heavy > 0)
        latents = model.evaluate(genotypes, ctx.lnL[0])
        log_post = latents.log_posteriors
        map_genotype = genotypes[int(np.argmax(log_post))]
        called = []
        for vi, v in enumerate(ctx.variants):
            g_has = ctx.contains[vi][genotypes].any(axis=1)
            phred = phred_not(log_post[~g_has])
            if phred >= cfg.min_variant_posterior_phred and ctx.contains[vi][map_genotype].any():
                called.append((v, phred))
        if not called:
            return []
        mp = None
        if cfg.model_posterior_policy == "all":
            mp = self._model_posterior(ctx, genotypes, latents, model)
        site_groups = group_exclusive_sites([v for v, _ in called])
        quality_of = {v: q for v, q in called}
        site_alleles = self.make_site_alleles(ctx, site_groups)
        phase_sets = Phaser(PhaserConfig(min_phase_quality=self.config.min_phase_score)).phase(site_alleles, genotypes, latents.posteriors)
        site_phase_set = {}
        site_phase_quality = {}
        for ps in phase_sets:
            ps_begin = min(site_groups[si][0].begin for si in ps.site_indices)
            for si in ps.site_indices:
                site_phase_set[si] = ps_begin
                site_phase_quality[si] = ps.quality
        out = []
        for si, group in enumerate(site_groups):
            hap_allele = site_alleles[si]
            gt = [int(hap_allele[h]) for h in map_genotype]
            site_gt = np.sort(hap_allele[genotypes], axis=1)
            matches = (site_gt == np.sort(np.asarray(gt))).all(axis=1)
            gq = phred_not(log_post[~matches])
            out.append(SiteCall(
                begin=min(v.begin for v in group),
                end=max(v.end for v in group),
                alts=list(group),
                quality=max(quality_of[v] for v in group),
                genotypes=[gt],
                genotype_qualities=[gq],
                phase_set=site_phase_set.get(si, group[0].begin),
                phase_quality=site_phase_quality.get(si),
                alt_qualities=[quality_of[v] for v in group],
                model_posteriors=[mp] if mp is not None else None,
            ))
        return out

    def _model_posterior(self, ctx, genotypes, latents, model) -> float:
        """Model-check posterior: the called-ploidy model vs a dummy
        ploidy+1 model grown from the top genotypes
        (IndividualCaller::calculate_model_posterior,
        individual_caller.cpp:179-192 and :755-767)."""
        num_seeds = min(3, len(genotypes))
        seeds = genotypes[np.argsort(latents.log_posteriors)[::-1][:num_seeds]]
        dummy_genotypes = extend_genotypes(seeds, len(ctx.haplotypes))
        dummy = model.evaluate(dummy_genotypes, ctx.lnL[0])
        return model_posterior_phred(latents.log_evidence, dummy.log_evidence)


class _PriorAdapter:
    """CoalescentModel -> GenotypePriorModel interface."""

    def __init__(self, model):
        self.model = model

    def evaluate_many(self, genotypes: np.ndarray) -> np.ndarray:
        return self.model.evaluate_many(genotypes)


__all__ = ["IndividualCaller", "CallerConfig", "SiteCall"]
