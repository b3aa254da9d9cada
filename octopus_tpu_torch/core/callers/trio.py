"""Trio caller (maternal + paternal + child) with de novo calling.

Capability-equivalent to the reference's TrioCaller
(src/core/callers/trio_caller.cpp): joint trio genotype posteriors via
TrioModel; variant posterior marginalises joint states containing the alt in
any member; calls are labelled DENOVO when the posterior mass of states with
the alt in the child but neither parent dominates (min-denovo-posterior
default phred 3).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..hapgen.generator import group_exclusive_sites
from ..models.denovo import DeNovoModel, DeNovoParams
from ..models.individual import IndividualModel
from ..models.trio import TrioModel
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


@dataclass
class TrioCallerConfig(BaseCallerConfig):
    # sample order in reads_by_sample: [maternal, paternal, child]
    min_denovo_posterior_phred: float = 3.0
    denovo_snv_prior: float = 1.3e-8
    denovo_indel_prior: float = 1e-9
    max_joint_combinations: int = 20000


class TrioCaller(CallerBase):
    MATERNAL, PATERNAL, CHILD = 0, 1, 2

    def __init__(self, reference, contig: str,
                 config: TrioCallerConfig | None = None):
        super().__init__(reference, contig, config or TrioCallerConfig())

    def _infer_and_call(self, ctx: ActiveRegionContext) -> list[SiteCall]:
        cfg = self.config
        assert len(ctx.lnL) == 3, "trio caller needs [maternal, paternal, child]"
        # explosion guard scores seeds on the pooled trio reads
        genotypes = self.propose_genotypes(
            ctx, cfg.ploidy, np.concatenate(ctx.lnL, axis=1))
        model = TrioModel(
            _Prior(ctx.prior_model),
            DeNovoModel(DeNovoParams(cfg.denovo_snv_prior, cfg.denovo_indel_prior)),
            cfg.max_joint_combinations,
        )
        latents = model.evaluate(genotypes, ctx.haplotypes,
                                 ctx.lnL[0], ctx.lnL[1], ctx.lnL[2])
        log_post = latents.log_posteriors
        combos = latents.combos                       # (C, 3)
        map_combo = combos[int(np.argmax(log_post))]
        map_gts = [genotypes[g] for g in map_combo]
        called = []
        denovo_flags = {}
        denovo_posteriors = {}
        for vi, v in enumerate(ctx.variants):
            g_has = ctx.contains[vi][genotypes].any(axis=1)     # (G,)
            combo_has = g_has[combos].any(axis=1)
            phred = phred_not(log_post[~combo_has])
            in_map = any(ctx.contains[vi][mg].any() for mg in map_gts)
            if phred >= cfg.min_variant_posterior_phred and in_map:
                called.append((v, phred))
                # de novo: child has it, neither parent does
                dn_states = (g_has[combos[:, 2]]
                             & ~g_has[combos[:, 0]] & ~g_has[combos[:, 1]])
                dn_phred = phred_not(log_post[~dn_states])
                denovo_flags[v] = dn_phred >= cfg.min_denovo_posterior_phred
                denovo_posteriors[v] = dn_phred
        if not called:
            return []
        # SPECIAL policy computes MP only when a call requires model
        # evaluation — i.e. a de novo call exists (caller.cpp:969-981)
        policy = cfg.model_posterior_policy
        want_mp = (policy == "all"
                   or (policy == "special" and any(denovo_flags.values())))
        mps = (self._model_posteriors(ctx, genotypes, combos, latents)
               if want_mp else None)
        site_groups = group_exclusive_sites([v for v, _ in called])
        quality_of = {v: q for v, q in called}
        site_alleles = self.make_site_alleles(ctx, site_groups)
        # phase over the child's marginal posterior
        child_post = np.zeros(len(genotypes))
        np.add.at(child_post, combos[:, 2], latents.posteriors)
        phase_sets = Phaser(PhaserConfig(min_phase_quality=self.config.min_phase_score)).phase(site_alleles, genotypes, child_post)
        site_ps = {}
        site_pq = {}
        for ps in phase_sets:
            b = min(site_groups[si][0].begin for si in ps.site_indices)
            for si in ps.site_indices:
                site_ps[si] = b
                site_pq[si] = ps.quality
        out = []
        for si, group in enumerate(site_groups):
            hap_allele = site_alleles[si]
            gts, gqs = [], []
            for member in range(3):
                gt = [int(hap_allele[h]) for h in map_gts[member]]
                sig = np.sort(np.asarray(gt))
                member_site_gt = np.sort(hap_allele[genotypes[combos[:, member]]], axis=1)
                matches = (member_site_gt == sig).all(axis=1)
                gqs.append(phred_not(log_post[~matches]))
                gts.append(gt)
            info = {}
            if any(denovo_flags.get(v, False) for v in group):
                info["DENOVO"] = True
                # INFO PP: the de novo classification posterior, distinct
                # from QUAL = variant posterior (denovo_call.cpp:10-16;
                # trio_caller.cpp:1010-1021 passes denovo.denovo_posterior)
                info["PP"] = round(max(
                    denovo_posteriors[v] for v in group
                    if denovo_flags.get(v, False)), 2)
            out.append(SiteCall(
                begin=min(v.begin for v in group),
                end=max(v.end for v in group),
                alts=list(group),
                quality=max(quality_of[v] for v in group),
                genotypes=gts,
                genotype_qualities=gqs,
                phase_set=site_ps.get(si, group[0].begin),
                phase_quality=site_pq.get(si),
                alt_qualities=[quality_of[v] for v in group],
                info=info,
                model_posteriors=mps,
            ))
        return out

    def _model_posteriors(self, ctx, genotypes, combos,
                          latents) -> list[float] | None:
        """Per-member model posteriors: a restricted top-5 single-sample
        model (from the member's marginal posterior over the joint states)
        vs the same seeds extended by every haplotype
        (TrioCaller::calculate_model_posterior, trio_caller.cpp:458-508)."""
        model = IndividualModel(_Prior(ctx.prior_model),
                                use_device=self.config.use_device,
                                device=self.config.device,
                                defer_device=self.config.defer_heavy > 0)
        log_post = latents.log_posteriors
        mps = []
        for member in range(3):
            marg = np.full(len(genotypes), -np.inf)
            np.logaddexp.at(marg, combos[:, member], log_post)
            k = min(5, len(genotypes))
            assumed = genotypes[np.argsort(marg)[::-1][:k]]
            augmented = extend_genotypes(assumed, len(ctx.haplotypes))
            lev1 = model.evaluate(assumed, ctx.lnL[member]).log_evidence
            lev2 = model.evaluate(augmented, ctx.lnL[member]).log_evidence
            mps.append(model_posterior_phred(lev1, lev2))
        return mps


class _Prior:
    def __init__(self, model):
        self.model = model

    def evaluate_many(self, genotypes: np.ndarray) -> np.ndarray:
        return self.model.evaluate_many(genotypes)


__all__ = ["TrioCaller", "TrioCallerConfig"]
