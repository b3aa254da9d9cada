"""Cancer (tumour +/- normal) caller.

Capability-equivalent to the reference's CancerCaller
(src/core/callers/cancer_caller.cpp): three competing models per region —

* germline: all samples share one germline genotype (IndividualModel math),
* CNV: germline genotype with free per-sample mixture weights (SubcloneModel
  over the genotype's own haplotypes),
* somatic: cancer genotypes (germline genotype + somatic haplotype) with
  free weights (SomaticSubcloneModel);

model posteriors combine evidences with the reference's priors
(cancer_caller.cpp set_model_priors: with normal {.09,.01,.9}, without
{.09,.001,.909}).  Somatic calls carry SOMATIC info and require the somatic
model to dominate; germline calls marginalise over models.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from ..hapgen.generator import group_exclusive_sites
from ..models.denovo import DeNovoModel, DeNovoParams
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


def beta_hdi(a: float, b: float, mass: float) -> tuple[float, float]:
    """Beta highest-density-interval cases as in the reference
    (src/utils/maths.hpp:1029-1060 beta_hdi)."""
    from scipy.stats import beta as beta_dist
    if mass <= 0.0:
        m = a / (a + b)
        return m, m
    if mass >= 1.0:
        return 0.0, 1.0
    if a == b:
        if a == 1.0:                       # uniform
            half = (1.0 - mass) / 2
            return half, half + mass
        x = float(beta_dist.ppf((1.0 - mass) / 2, a, a))
        return x, 1.0 - x
    if a == 1.0:                           # J shaped
        return 0.0, float(beta_dist.ppf(mass, 1.0, b))
    if b == 1.0:                           # reverse J
        return float(beta_dist.ppf(1.0 - mass, a, 1.0)), 1.0
    c = (1.0 - mass) / 2
    return (float(beta_dist.ppf(c, a, b)),
            float(beta_dist.ppf(c + mass, a, b)))


@dataclass
class CancerCallerConfig(BaseCallerConfig):
    normal_sample: int | None = None       # index into reads_by_sample
    max_somatic_haplotypes: int = 2
    min_somatic_posterior_phred: float = 2.0
    somatic_snv_prior: float = 1e-4
    somatic_indel_prior: float = 1e-5
    # Dirichlet concentrations per model and sample role
    # (cancer_caller.hpp:43-56 Concentrations defaults): the CNV model's
    # normal concentration of 50 pins the normal's weights near uniform —
    # a normal sample cannot explain skewed allele fractions, which is what
    # lets the somatic model win on true somatics
    cnv_normal_concentration: float = 50.0
    cnv_tumour_concentration: float = 0.5
    somatic_normal_germline_concentration: float = 50.0
    somatic_normal_somatic_concentration: float = 0.05
    tumour_germline_concentration: float = 1.5
    somatic_concentration: float = 1.0
    max_genotypes: int = 500
    # somatic-VAF credible-region gating (cancer_caller.cpp:1230-1265):
    # a somatic call requires >= 1 tumour sample whose somatic-weight
    # credible region (beta HDI at `somatic_credible_mass` over the VB
    # Dirichlet posterior) starts above `min_credible_somatic_frequency`,
    # and is vetoed when the normal sample's does too; the call posterior is
    # additionally scaled by P(somatic frequency >= min_expected_somatic_
    # frequency) (calculate_somatic_mass, cancer_caller.cpp:1352-1357)
    min_expected_somatic_frequency: float = 0.01
    somatic_credible_mass: float = 0.9
    min_credible_somatic_frequency: float = 0.005
    # --normal-contamination-risk HIGH disables both normal-sample vetoes:
    # the credible-region check and the normal-only noise-model fit
    # (evaluate_noise_model, cancer_caller.cpp:572-588,1254-1266)
    normal_contamination_risk: str = "low"


class CancerCaller(CallerBase):
    def __init__(self, reference, contig: str,
                 config: CancerCallerConfig | None = None):
        super().__init__(reference, contig, config or CancerCallerConfig())

    def _infer_and_call(self, ctx: ActiveRegionContext) -> list[SiteCall]:
        cfg = self.config
        n_samples = len(ctx.lnL)
        H = len(ctx.haplotypes)
        genotypes = generate_all_genotypes(H, cfg.ploidy)
        log_priors = ctx.prior_model.evaluate_many(genotypes)
        likelihoods = np.stack([
            genotype_log_likelihoods_np(ctx.lnL[s], genotypes)
            for s in range(n_samples)])                      # (S, G)
        # cap genotype space by joint score (CLI --max-genotypes is optional
        # in the reference, option_parser.cpp:546; None = internal default)
        max_genotypes = cfg.max_genotypes if cfg.max_genotypes is not None else 500
        if len(genotypes) > max_genotypes:
            order = np.argsort(log_priors + likelihoods.sum(axis=0))[::-1]
            keep = np.sort(order[:max_genotypes])
            genotypes, log_priors = genotypes[keep], log_priors[keep]
            likelihoods = likelihoods[:, keep]
        G = len(genotypes)

        # -- germline model evidence ---------------------------------------
        germline_joint = log_priors + likelihoods.sum(axis=0)
        germline_ev = logsumexp(germline_joint)
        germline_post = np.exp(germline_joint - germline_ev)

        # -- CNV model: free weights over the genotype's haplotypes --------
        vb = SubcloneModel(n_seeds=2, n_iter=40, device=cfg.device)
        cnv_ev_by_g = np.zeros(G)
        for s in range(n_samples):
            conc = (cfg.cnv_normal_concentration if s == cfg.normal_sample
                    else cfg.cnv_tumour_concentration)
            inf = vb.evaluate(genotypes, ctx.lnL[s],
                              alpha0_vec=np.full(cfg.ploidy, conc, np.float32))
            cnv_ev_by_g += inf.genotype_log_evidences
        cnv_joint = log_priors + cnv_ev_by_g
        cnv_ev = logsumexp(cnv_joint)

        # -- somatic model: genotype + one somatic haplotype ---------------
        denovo = DeNovoModel(DeNovoParams(cfg.somatic_snv_prior, cfg.somatic_indel_prior))
        cancer_tuples = []
        cancer_meta = []       # (genotype_idx, somatic_hap)
        cancer_prior = []
        for gi in range(G):
            g = genotypes[gi]
            for h in range(H):
                if h in g:
                    continue
                # somatic prior: P(somatic hap | closest germline hap)
                lp_som = max(denovo.ln_probability(h, int(x), ctx.haplotypes)
                             for x in g)
                if not ctx.haplotypes[h].variants and lp_som == 0.0:
                    continue
                cancer_tuples.append(list(g) + [h])
                cancer_meta.append((gi, h))
                cancer_prior.append(log_priors[gi] + lp_som)
        somatic_ev = -np.inf
        somatic_post = None
        if cancer_tuples:
            tuples = np.asarray(cancer_tuples)
            conc_tumour = np.concatenate([
                np.full(cfg.ploidy, cfg.tumour_germline_concentration),
                [cfg.somatic_concentration]]).astype(np.float32)
            # the normal sample is evaluated under the same tuple with the
            # somatic component pinned near zero weight (concentration 0.05)
            conc_normal = np.concatenate([
                np.full(cfg.ploidy, cfg.somatic_normal_germline_concentration),
                [cfg.somatic_normal_somatic_concentration]]).astype(np.float32)
            som_ev_by_t = np.zeros(len(tuples))
            som_alphas_by_s = []
            for s in range(n_samples):
                conc = conc_normal if s == cfg.normal_sample else conc_tumour
                inf = vb.evaluate(tuples, ctx.lnL[s], alpha0_vec=conc)
                som_ev_by_t += inf.genotype_log_evidences
                som_alphas_by_s.append(np.asarray(inf.map_alphas))
            somatic_joint = np.asarray(cancer_prior) + som_ev_by_t
            somatic_ev = logsumexp(somatic_joint)
            somatic_post = np.exp(somatic_joint - somatic_ev)

        # -- noise model (evaluate_noise_model, cancer_caller.cpp:572-588):
        # fit the somatic mixture on the NORMAL sample alone with
        # tumour-like concentrations over the high-posterior cancer
        # genotypes; if its evidence beats the normal's germline evidence
        # AND the normal's somatic weight is credibly non-zero, the
        # "somatic" signal lives in the normal too -> veto somatic calls
        # (cancer_caller.cpp:1254-1266)
        noise_veto = False
        noise_ev = None
        if (cancer_tuples and cfg.normal_sample is not None
                and str(cfg.normal_contamination_risk).lower() != "high"):
            s = cfg.normal_sample
            normal_germ_ev = float(logsumexp(log_priors + likelihoods[s]))
            top = np.argsort(somatic_joint)[::-1][:min(10, len(tuples))]
            inf_noise = vb.evaluate(tuples[top], ctx.lnL[s],
                                    alpha0_vec=conc_tumour)
            noise_ev = float(logsumexp(
                np.asarray(cancer_prior)[top]
                + inf_noise.genotype_log_evidences))
            if noise_ev > normal_germ_ev:
                from scipy.stats import beta as beta_dist
                best_local = int(np.argmax(inf_noise.genotype_log_evidences))
                a = np.asarray(inf_noise.map_alphas, dtype=np.float64)[best_local]
                a_som = float(a[-1])
                a_rest = float(a.sum()) - a_som
                noise_mass = 1.0 - float(beta_dist.cdf(
                    cfg.min_expected_somatic_frequency, a_som, a_rest))
                if noise_mass > 2 * cfg.min_credible_somatic_frequency:
                    noise_veto = True

        # -- model comparison ----------------------------------------------
        if cfg.normal_sample is not None:
            model_priors = np.log(np.asarray([0.09, 0.01, 0.9]))
        else:
            model_priors = np.log(np.asarray([0.09, 0.001, 0.909]))
        evidences = np.asarray([germline_ev, cnv_ev, somatic_ev])
        model_log_post = model_priors + evidences
        model_log_post -= logsumexp(model_log_post)
        model_post = np.exp(model_log_post)

        # joint model posterior (INFO MP): the normal sample's germline
        # evidence vs a demoted ploidy+1 dummy (and the noise fit when
        # available) — CancerCaller::calculate_model_posterior
        # (cancer_caller.cpp:246-276)
        joint_mp = None
        # SPECIAL computes MP whenever somatic calls are possible (somatic
        # calls require model evaluation, somatic_call.hpp:57)
        if (cfg.normal_sample is not None and cancer_tuples
                and cfg.model_posterior_policy in ("all", "special")):
            from .base import model_posterior_phred
            s = cfg.normal_sample
            normal_ev = float(logsumexp(log_priors + likelihoods[s]))
            demoted = np.unique(np.sort(tuples, axis=1), axis=0)
            dummy_ev = float(logsumexp(
                ctx.prior_model.evaluate_many(demoted)
                + genotype_log_likelihoods_np(ctx.lnL[s], demoted)))
            joint_mp = model_posterior_phred(normal_ev, dummy_ev, noise_ev)

        calls = self._make_calls(ctx, genotypes, germline_post, model_post,
                                 cancer_meta, somatic_post,
                                 som_alphas_by_s if cancer_tuples else None,
                                 noise_veto=noise_veto)
        if joint_mp is not None:
            for c in calls:
                c.info.setdefault("MP", round(joint_mp, 2))
        return calls

    def _somatic_vaf_gates(self, som_alphas_by_s, map_t):
        """Somatic-VAF posterior statistics of the MAP cancer genotype.

        Returns (conditional somatic mass = P(any sample's somatic frequency
        >= min_expected_somatic_frequency), per-sample credible-region
        qualification), per cancer_caller.cpp:753-775 (compute_credible_
        somatic_mass) and :1235-1253 (vaf_stats credible-region checks)."""
        from scipy.stats import beta as beta_dist
        cfg = self.config
        inv_mass = 1.0
        qualifies = []
        for alphas in som_alphas_by_s:
            a = np.asarray(alphas[map_t], dtype=np.float64)
            a_som = float(a[-1])
            a_rest = float(a.sum()) - a_som
            inv_mass *= float(beta_dist.cdf(
                cfg.min_expected_somatic_frequency, a_som, a_rest))
            lo, _ = beta_hdi(a_som, a_rest, cfg.somatic_credible_mass)
            qualifies.append(lo >= cfg.min_credible_somatic_frequency)
        return 1.0 - inv_mass, qualifies

    def _make_calls(self, ctx, genotypes, germline_post, model_post,
                    cancer_meta, somatic_post, som_alphas_by_s=None,
                    noise_veto=False) -> list[SiteCall]:
        cfg = self.config
        log_g = np.log(np.clip(germline_post, 1e-300, None))
        p_somatic_model = float(model_post[2])
        somatic_samples = None
        somatic_wins = somatic_post is not None and p_somatic_model > 0.5
        if somatic_wins and som_alphas_by_s is not None:
            # model-level somatic posterior = P(somatic model) x P(somatic
            # frequency >= min expected); gate vs --min-somatic-posterior
            # (cancer_caller.cpp:1186-1199)
            map_t = int(np.argmax(somatic_post))
            mass, qualifies = self._somatic_vaf_gates(som_alphas_by_s, map_t)
            somatic_posterior = p_somatic_model * mass
            phred_model = -10 * math.log10(max(1 - somatic_posterior, 1e-300))
            somatic_samples = [q and s != cfg.normal_sample
                               for s, q in enumerate(qualifies)]
            normal_veto = (cfg.normal_sample is not None
                           and str(cfg.normal_contamination_risk).lower() != "high"
                           and qualifies[cfg.normal_sample])
            if (phred_model < cfg.min_somatic_posterior_phred
                    or normal_veto or noise_veto or not any(somatic_samples)):
                # keep the cancer-genotype germline call, but emit no
                # somatic records (cancer_caller.cpp:1246-1267)
                somatic_samples = [False] * len(qualifies)
        if somatic_wins:
            map_meta = cancer_meta[int(np.argmax(somatic_post))]
            map_g = genotypes[map_meta[0]]
            log_s = np.log(np.clip(somatic_post, 1e-300, None))
            meta_gi = np.asarray([m[0] for m in cancer_meta])
            meta_h = np.asarray([m[1] for m in cancer_meta])
        else:
            map_g = genotypes[int(np.argmax(germline_post))]
        called = []
        somatic_calls = []
        for vi, v in enumerate(ctx.variants):
            has_v = ctx.contains[vi]
            if somatic_wins:
                germ_has = has_v[genotypes[meta_gi]].any(axis=1)
                som_has = has_v[meta_h]
                if has_v[map_g].any():
                    phred = phred_not(log_s[~germ_has])
                    if phred >= cfg.min_variant_posterior_phred:
                        called.append((v, phred))
                elif has_v[map_meta[1]] and (somatic_samples is None
                                             or any(somatic_samples)):
                    mass = float(np.exp(log_s[som_has & ~germ_has]).sum())
                    p_som = p_somatic_model * mass
                    phred_som = -10 * math.log10(max(1 - p_som, 1e-300))
                    if phred_som >= cfg.min_somatic_posterior_phred:
                        somatic_calls.append((v, phred_som))
            else:
                g_has = has_v[genotypes].any(axis=1)
                phred = phred_not(log_g[~g_has])
                if phred >= cfg.min_variant_posterior_phred and has_v[map_g].any():
                    called.append((v, phred))
        out = []
        out.extend(self._emit(ctx, genotypes, log_g, map_g, called, {}))
        if somatic_calls:
            out.extend(self._emit(ctx, genotypes, log_g, map_g, somatic_calls,
                                  {"SOMATIC": True},
                                  somatic_samples=somatic_samples))
        return out

    def _emit(self, ctx, genotypes, log_post, map_genotype, called, info,
              somatic_samples=None):
        if not called:
            return []
        site_groups = group_exclusive_sites([v for v, _ in called])
        quality_of = {v: q for v, q in called}
        site_alleles = self.make_site_alleles(ctx, site_groups)
        n_samples = len(ctx.lnL)
        out = []
        for si, group in enumerate(site_groups):
            site_info = dict(info)
            if site_info.get("SOMATIC"):
                # INFO PP: the somatic classification posterior
                # (somatic_call.cpp:49-56)
                site_info["PP"] = round(max(quality_of[v] for v in group), 2)
            hap_allele = site_alleles[si]
            if info.get("SOMATIC"):
                # tumour samples carry the somatic allele as an extra ploidy
                # slot; the normal sample does NOT (it has only the germline
                # genotype) — both for VCF semantics and so carrier-sample
                # measures (AD/AF) are evaluated against tumour reads only
                # only samples whose somatic-VAF credible region qualifies
                # carry the somatic allele (cancer_caller.cpp:1240-1253);
                # the normal never does
                gts = [[0, 0, 1] if (s != self.config.normal_sample
                                     and (somatic_samples is None
                                          or somatic_samples[s]))
                       else [0, 0]
                       for s in range(n_samples)]
                gqs = [quality_of[group[0]]] * n_samples
            else:
                gt = [int(hap_allele[h]) for h in map_genotype]
                site_gt = np.sort(hap_allele[genotypes], axis=1)
                matches = (site_gt == np.sort(np.asarray(gt))).all(axis=1)
                gq = phred_not(log_post[~matches])
                gts = [gt] * n_samples
                gqs = [gq] * n_samples
            out.append(SiteCall(
                begin=min(v.begin for v in group),
                end=max(v.end for v in group),
                alts=list(group),
                quality=max(quality_of[v] for v in group),
                genotypes=gts,
                genotype_qualities=gqs,
                phase_set=group[0].begin,
                alt_qualities=[quality_of[v] for v in group],
                info=site_info,
            ))
        return out


__all__ = ["CancerCaller", "CancerCallerConfig"]
