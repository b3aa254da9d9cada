"""Trio model: joint (maternal, paternal, child) genotype inference.

Capability-equivalent to the reference's TrioModel
(src/core/models/genotype/trio_model.cpp:133-363): joint posterior

  p(gm, gp, gc | reads) propto prior(gm) prior(gp) p(gc | gm, gp)
                               p(reads_m|gm) p(reads_p|gp) p(reads_c|gc)

with Mendelian transmission + de novo mutation:

  p(gc = {a, b} | gm, gp) = 1/2 [ T(a|gm) T(b|gp) + T(b|gm) T(a|gp) ]
  T(x | g) = 1/ploidy * sum_{h in g} P_denovo(x | h)

and the reference's combinatorial reduction: per-member top-k pruning of
genotypes by prior x likelihood before the joint product.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import product

import numpy as np

from .denovo import DeNovoModel, DeNovoParams
from .individual import logsumexp


@dataclass
class TrioLatents:
    genotypes: np.ndarray             # (G, P) shared genotype index matrix
    combos: np.ndarray                # (C, 3) [maternal, paternal, child] rows
    log_posteriors: np.ndarray        # (C,)
    posteriors: np.ndarray
    log_evidence: float


class TrioModel:
    def __init__(self, prior_model, denovo: DeNovoModel | None = None,
                 max_combinations: int = 20000):
        self.prior_model = prior_model
        self.denovo = denovo or DeNovoModel()
        self.max_combinations = max_combinations

    def evaluate(self, genotypes: np.ndarray, haplotypes,
                 lnL_mother: np.ndarray, lnL_father: np.ndarray,
                 lnL_child: np.ndarray) -> TrioLatents:
        from .genotype_likelihoods import genotype_log_likelihoods_np

        log_priors = self.prior_model.evaluate_many(genotypes)
        lik_m = genotype_log_likelihoods_np(lnL_mother, genotypes)
        lik_p = genotype_log_likelihoods_np(lnL_father, genotypes)
        lik_c = genotype_log_likelihoods_np(lnL_child, genotypes)
        G = len(genotypes)
        k = max(2, int(round(self.max_combinations ** (1 / 3))))
        k = min(k, G)
        top_m = np.argsort(log_priors + lik_m)[::-1][:k]
        top_p = np.argsort(log_priors + lik_p)[::-1][:k]
        top_c = np.argsort(lik_c)[::-1][:k]
        combos = []
        scores = []
        trans_cache: dict[tuple[int, int, int], float] = {}
        for gm, gp, gc in product(top_m, top_p, top_c):
            key = (int(gm), int(gp), int(gc))
            t = trans_cache.get(key)
            if t is None:
                t = self._ln_transmission(genotypes[gm], genotypes[gp],
                                          genotypes[gc], haplotypes)
                trans_cache[key] = t
            combos.append(key)
            scores.append(log_priors[gm] + log_priors[gp] + t
                          + lik_m[gm] + lik_p[gp] + lik_c[gc])
        scores = np.asarray(scores)
        log_evidence = logsumexp(scores)
        log_post = scores - log_evidence
        return TrioLatents(
            genotypes=genotypes,
            combos=np.asarray(combos),
            log_posteriors=log_post,
            posteriors=np.exp(log_post),
            log_evidence=log_evidence,
        )

    def _ln_transmission(self, gm, gp, gc, haplotypes) -> float:
        """ln p(child diploid genotype | parental genotypes)."""
        a, b = int(gc[0]), int(gc[1])

        def T(x, parent):
            vals = [self.denovo.ln_probability(x, int(h), haplotypes)
                    for h in parent]
            return logsumexp(np.asarray(vals)) - np.log(len(parent))

        t1 = T(a, gm) + T(b, gp)
        t2 = T(b, gm) + T(a, gp)
        both = logsumexp(np.asarray([t1, t2])) - np.log(2.0)
        if a == b:
            # unordered {a,a}: the two orderings coincide
            both = t1
        return float(both)


__all__ = ["TrioModel", "TrioLatents"]
