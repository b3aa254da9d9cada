"""Polyclone caller (unknown number of haploid clones, e.g. bacteria /
parasites in mixed infection).

Capability-equivalent to the reference's PolycloneCaller
(src/core/callers/polyclone_caller.cpp): compares a haploid IndividualModel
against SubcloneModels with k = 2..max_clones haplotypes under a geometric
clonality prior (polyclone_caller.cpp:92-110); calls variants from the
winning model's haplotype posteriors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from itertools import combinations

import numpy as np

from ..hapgen.generator import group_exclusive_sites
from ..models.genotype_likelihoods import genotype_log_likelihoods_np
from ..models.individual import logsumexp
from ..models.subclone_vb import SubcloneModel
from ..types.genotypes import generate_all_genotypes
from .base import (
    ActiveRegionContext,
    BaseCallerConfig,
    CallerBase,
    SiteCall,
    phred_not,
)


@dataclass
class PolycloneCallerConfig(BaseCallerConfig):
    max_clones: int = 3
    clonality_prior_decay: float = 0.5     # P(k) propto decay^(k-1)
    max_tuples_per_k: int = 200
    # --clone-concentration: symmetric Dirichlet prior concentration of the
    # clone mixture weights (polyclone_caller.cpp:627 make_sublone_model_
    # mixture_prior_map; caller_builder.hpp:158 clone_concentration)
    clone_concentration: float = 1.0

    def __post_init__(self):
        self.ploidy = 1


class PolycloneCaller(CallerBase):
    def __init__(self, reference, contig: str,
                 config: PolycloneCallerConfig | None = None):
        super().__init__(reference, contig, config or PolycloneCallerConfig())

    def _infer_and_call(self, ctx: ActiveRegionContext) -> list[SiteCall]:
        cfg = self.config
        H = len(ctx.haplotypes)
        lnL = ctx.lnL[0]
        # k = 1: haploid exact model
        singles = generate_all_genotypes(H, 1)
        hap_priors = ctx.prior_model.evaluate_many(singles)
        hap_liks = genotype_log_likelihoods_np(lnL, singles)
        k1_joint = hap_priors + hap_liks
        evidences = {1: logsumexp(k1_joint)}
        model_latents = {1: (singles, np.exp(k1_joint - evidences[1]), None)}
        vb = SubcloneModel(n_seeds=3, n_iter=50, device=cfg.device)
        for k in range(2, min(cfg.max_clones, H) + 1):
            tuples = np.asarray(list(combinations(range(H), k)))
            if len(tuples) > cfg.max_tuples_per_k:
                score = hap_liks[tuples].sum(axis=1)
                tuples = tuples[np.argsort(score)[::-1][:cfg.max_tuples_per_k]]
            prior = np.asarray([hap_priors[t].sum() for t in tuples])
            inf = vb.evaluate(
                tuples, lnL, log_priors=prior,
                alpha0_vec=np.full(k, cfg.clone_concentration, np.float32))
            evidences[k] = inf.log_evidence
            model_latents[k] = (tuples, inf.genotype_posteriors, inf.map_alphas)
        ks = sorted(evidences)
        log_prior_k = np.asarray([
            (k - 1) * math.log(cfg.clonality_prior_decay) for k in ks])
        joint_k = log_prior_k + np.asarray([evidences[k] for k in ks])
        joint_k -= logsumexp(joint_k)
        best_k = ks[int(np.argmax(joint_k))]
        tuples, post, alphas = model_latents[best_k]
        log_post = np.log(np.clip(post, 1e-300, None))
        map_tuple = tuples[int(np.argmax(post))]
        called = []
        for vi, v in enumerate(ctx.variants):
            t_has = ctx.contains[vi][tuples].any(axis=1)
            phred = phred_not(log_post[~t_has])
            if phred >= cfg.min_variant_posterior_phred and ctx.contains[vi][map_tuple].any():
                called.append((v, phred))
        if not called:
            return []
        site_groups = group_exclusive_sites([v for v, _ in called])
        quality_of = {v: q for v, q in called}
        site_alleles = self.make_site_alleles(ctx, site_groups)
        out = []
        for si, group in enumerate(site_groups):
            hap_allele = site_alleles[si]
            gt = sorted({int(hap_allele[h]) for h in map_tuple})
            out.append(SiteCall(
                begin=min(v.begin for v in group),
                end=max(v.end for v in group),
                alts=list(group),
                quality=max(quality_of[v] for v in group),
                genotypes=[gt],
                genotype_qualities=[quality_of[group[0]]],
                phase_set=group[0].begin,
                alt_qualities=[quality_of[v] for v in group],
                info={"CLONES": best_k},
            ))
        return out


__all__ = ["PolycloneCaller", "PolycloneCallerConfig"]
