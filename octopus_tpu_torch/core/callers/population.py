"""Population (multi-sample joint germline) caller.

Capability-equivalent to the reference's PopulationCaller
(src/core/callers/population_caller.cpp).  Two model modes as in the
reference (population_model.hpp:23-71):

* independent: per-sample IndividualModel posteriors (the reference's
  IndependentPopulationModel); joint variant posterior combines samples as
  P(no alt anywhere) = prod_s P_s(no alt);
* exact joint (small cohorts): joint genotype combinations scored with a
  shared-haplotype coalescent prior over the union of sample genotypes,
  capped by max_genotype_combinations via per-sample top-k pre-pruning.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from itertools import product

import numpy as np

from ..hapgen.generator import group_exclusive_sites
from ..models.individual import IndividualModel, logsumexp
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
class PopulationCallerConfig(BaseCallerConfig):
    joint_model: bool = True
    # reference default for the population caller
    # (option_collation.cpp:2106-2120: 100'000 unless --fast)
    max_genotype_combinations: int = 100_000


class PopulationCaller(CallerBase):
    def __init__(self, reference, contig: str,
                 config: PopulationCallerConfig | None = None):
        super().__init__(reference, contig, config or PopulationCallerConfig())

    def _infer_and_call(self, ctx: ActiveRegionContext) -> list[SiteCall]:
        cfg = self.config
        n_samples = len(ctx.lnL)
        # explosion guard scores seeds on the pooled reads (all samples)
        genotypes = self.propose_genotypes(
            ctx, cfg.ploidy, np.concatenate(ctx.lnL, axis=1))
        model = IndividualModel(_Prior(ctx.prior_model), use_device=cfg.use_device,
                                device=cfg.device,
                                defer_device=cfg.defer_heavy > 0)
        latents = [model.evaluate(genotypes, ctx.lnL[s]) for s in range(n_samples)]
        if cfg.joint_model and n_samples > 1:
            return self._call_joint(ctx, genotypes, latents)
        return self._call_independent(ctx, genotypes, latents)

    def _model_posteriors(self, ctx, genotypes,
                          marginal_log_posts) -> list[float] | None:
        """Per-sample model posteriors: a restricted top-5 genotype model vs
        the same seeds augmented with every haplotype (ploidy+1)
        (PopulationCaller::calculate_model_posterior,
        population_caller.cpp:241-260 and :845-862)."""
        if self.config.model_posterior_policy != "all":
            return None
        model = IndividualModel(_Prior(ctx.prior_model),
                                use_device=self.config.use_device,
                                device=self.config.device,
                                defer_device=self.config.defer_heavy > 0)
        mps = []
        for s, marg in enumerate(marginal_log_posts):
            k = min(5, len(genotypes))
            assumed = genotypes[np.argsort(marg)[::-1][:k]]
            augmented = extend_genotypes(assumed, len(ctx.haplotypes))
            lev1 = model.evaluate(assumed, ctx.lnL[s]).log_evidence
            lev2 = model.evaluate(augmented, ctx.lnL[s]).log_evidence
            mps.append(model_posterior_phred(lev1, lev2))
        return mps

    # -- independent mode --------------------------------------------------

    def _call_independent(self, ctx, genotypes, latents) -> list[SiteCall]:
        cfg = self.config
        n_samples = len(latents)
        map_gts = [genotypes[int(np.argmax(l.log_posteriors))] for l in latents]
        called = []
        for vi, v in enumerate(ctx.variants):
            g_has = ctx.contains[vi][genotypes].any(axis=1)
            # ln P(no alt in sample s)
            ln_no = [min(logsumexp(l.log_posteriors[~g_has]), 0.0) if (~g_has).any() else -np.inf
                     for l in latents]
            total_phred = -sum(ln_no) / np.log(10) * 10
            in_a_map = any(ctx.contains[vi][mg].any() for mg in map_gts)
            if total_phred >= cfg.min_variant_posterior_phred and in_a_map:
                called.append((v, total_phred))
        if not called:
            return []
        mps = self._model_posteriors(ctx, genotypes,
                                     [l.log_posteriors for l in latents])
        site_groups = group_exclusive_sites([v for v, _ in called])
        quality_of = {v: q for v, q in called}
        site_alleles = self.make_site_alleles(ctx, site_groups)
        # phase per sample 0 for PS grouping (shared sites)
        phase_sets = Phaser(PhaserConfig(min_phase_quality=self.config.min_phase_score)).phase(site_alleles, genotypes, latents[0].posteriors)
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
            for s, l in enumerate(latents):
                gt = [int(hap_allele[h]) for h in map_gts[s]]
                site_gt = np.sort(hap_allele[genotypes], axis=1)
                matches = (site_gt == np.sort(np.asarray(gt))).all(axis=1)
                gqs.append(phred_not(l.log_posteriors[~matches]))
                gts.append(gt)
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
                model_posteriors=mps,
            ))
        return out

    # -- exact joint mode --------------------------------------------------

    def _call_joint(self, ctx, genotypes, latents) -> list[SiteCall]:
        """Joint posterior over per-sample genotype combinations.

        p(g_1..g_S) propto prior_pop(union haplotypes) * prod_s p(reads_s|g_s)
        over all combinations when G^S fits --max-genotype-combinations,
        else over the EM-marginal top-k tuple reduction at ANY cohort size
        (PopulationModel::evaluate, population_model.cpp:594-615 +
        propose_genotype_combinations :492-521)."""
        from ..models.population_em import (em_genotype_marginals,
                                            propose_genotype_combinations)
        cfg = self.config
        n_samples = len(latents)
        G = len(genotypes)
        cap = cfg.max_genotype_combinations
        if G ** n_samples <= cap:
            combos = list(product(*[range(G)] * n_samples))
        else:
            loglik = np.stack([l.log_likelihoods for l in latents])  # (S, G)
            marginals = em_genotype_marginals(genotypes, loglik,
                                              len(ctx.haplotypes))
            ref_idx = next((i for i, h in enumerate(ctx.haplotypes)
                            if not h.variants), None)
            hom_ref_gidx = None
            if ref_idx is not None:
                hits = np.nonzero((genotypes == ref_idx).all(axis=1))[0]
                hom_ref_gidx = int(hits[0]) if len(hits) else None
            combos = [tuple(row) for row in propose_genotype_combinations(
                genotypes, marginals, cap, hom_ref_gidx)]
        combo_arr = np.asarray(combos)                     # (C, S)
        lik_mat = np.stack([l.log_likelihoods for l in latents])  # (S, G)
        lik_sum = lik_mat[np.arange(n_samples)[None, :],
                          combo_arr].sum(axis=1)           # (C,)
        independent_priors = getattr(self.config,
                                     "use_independent_genotype_priors", False)
        if independent_priors:
            # --use-independent-genotype-priors: per-sample genotype priors
            # instead of the shared-haplotype population prior
            # (cli.md:1157-1163; population caller prior model switch)
            prior_mat = np.stack([l.log_priors for l in latents])
            prior_vec = prior_mat[np.arange(n_samples)[None, :],
                                  combo_arr].sum(axis=1)
        else:
            # joint prior: coalescent over the union of haplotypes across
            # samples (captures shared variation); likelihoods independent.
            # Vectorised: union masks per combo, prior per UNIQUE union.
            H = len(ctx.haplotypes)
            hap_of_g = np.zeros((G, H), dtype=bool)
            np.put_along_axis(hap_of_g, genotypes, True, axis=1)
            union = hap_of_g[combo_arr].any(axis=1)        # (C, H)
            uniq, inverse = np.unique(union, axis=0, return_inverse=True)
            uniq_priors = np.asarray([
                ctx.prior_model.evaluate_indices(np.flatnonzero(u))
                for u in uniq])
            prior_vec = uniq_priors[inverse]
        joint_scores = prior_vec + lik_sum
        joint_scores -= logsumexp(joint_scores)
        joint_post = np.exp(joint_scores)
        map_combo = combos[int(np.argmax(joint_scores))]
        map_gts = [genotypes[g] for g in map_combo]
        called = []
        for vi, v in enumerate(ctx.variants):
            g_has = ctx.contains[vi][genotypes].any(axis=1)   # (G,)
            combo_has = g_has[combo_arr].any(axis=1)          # (C,)
            phred = phred_not(joint_scores[~combo_has])
            in_map = any(ctx.contains[vi][mg].any() for mg in map_gts)
            if phred >= cfg.min_variant_posterior_phred and in_map:
                called.append((v, phred))
        if not called:
            return []
        # per-sample marginal genotype posteriors from the joint states
        marginals = []
        for s in range(n_samples):
            marg = np.full(G, -np.inf)
            np.logaddexp.at(marg, combo_arr[:, s], joint_scores)
            marginals.append(marg)
        mps = self._model_posteriors(ctx, genotypes, marginals)
        site_groups = group_exclusive_sites([v for v, _ in called])
        quality_of = {v: q for v, q in called}
        site_alleles = self.make_site_alleles(ctx, site_groups)
        phase_sets = Phaser(PhaserConfig(min_phase_quality=self.config.min_phase_score)).phase(site_alleles, genotypes, latents[0].posteriors)
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
            for s in range(n_samples):
                gt = [int(hap_allele[h]) for h in map_gts[s]]
                sig = np.sort(np.asarray(gt))
                sample_site_gt = np.sort(hap_allele[genotypes[combo_arr[:, s]]], axis=1)
                matches = (sample_site_gt == sig).all(axis=1)
                gqs.append(phred_not(joint_scores[~matches]))
                gts.append(gt)
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
                model_posteriors=mps,
            ))
        return out


class _Prior:
    def __init__(self, model):
        self.model = model

    def evaluate_many(self, genotypes: np.ndarray) -> np.ndarray:
        return self.model.evaluate_many(genotypes)


__all__ = ["PopulationCaller", "PopulationCallerConfig"]
