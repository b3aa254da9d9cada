"""Individual (single-sample) genotype model.

Capability-equivalent to the reference's IndividualModel
(src/core/models/genotype/individual_model.{hpp,cpp}): exact posterior over
candidate genotypes for one sample,

    posterior(g) proportional to  prior(g) * p(reads | g)

with model evidence  ln sum_g prior(g) p(reads | g).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...errors import HeavyWindowDeferred
from .genotype_likelihoods import genotype_log_likelihoods, runs_on_device


@dataclass
class IndividualLatents:
    genotypes: np.ndarray            # (G, P) index matrix
    log_likelihoods: np.ndarray      # (G,)
    log_priors: np.ndarray           # (G,)
    posteriors: np.ndarray           # (G,) normalised probabilities
    log_posteriors: np.ndarray       # (G,) normalised in log space
    log_evidence: float


def logsumexp(a: np.ndarray) -> float:
    m = np.max(a)
    if not np.isfinite(m):
        return float(m)
    return float(m + np.log(np.exp(a - m).sum()))


class IndividualModel:
    """defer_device (a CPU-only pool worker's): raise HeavyWindowDeferred
    rather than run a device-sized genotype reduction here, whose float32
    bits on this CPU would differ from the card's."""

    def __init__(self, prior_model, use_device: bool = True,
                 device: str = "cuda", defer_device: bool = False):
        self.prior_model = prior_model
        self.use_device = use_device
        self.device = device
        self.defer_device = defer_device

    def evaluate(self, genotypes: np.ndarray, lnL: np.ndarray) -> IndividualLatents:
        """genotypes: (G, P) haplotype index matrix; lnL: (H, R) per-read."""
        if self.defer_device and runs_on_device(lnL, genotypes,
                                                self.use_device):
            raise HeavyWindowDeferred()
        log_liks = genotype_log_likelihoods(lnL, genotypes,
                                            use_device=self.use_device,
                                            device=self.device)
        log_priors = self.prior_model.evaluate_many(genotypes)
        joint = log_priors + log_liks
        log_evidence = logsumexp(joint)
        log_post = joint - log_evidence
        return IndividualLatents(
            genotypes=genotypes,
            log_likelihoods=log_liks,
            log_priors=log_priors,
            posteriors=np.exp(log_post),
            log_posteriors=log_post,
            log_evidence=log_evidence,
        )


class UniformGenotypePriorModel:
    """Mirrors UniformGenotypePriorModel — flat prior."""

    def evaluate_many(self, genotypes: np.ndarray) -> np.ndarray:
        return np.zeros(len(genotypes))

    def prime(self, haplotypes) -> None:
        pass


__all__ = ["IndividualModel", "IndividualLatents", "UniformGenotypePriorModel", "logsumexp"]
