"""Hardy-Weinberg genotype prior.

Capability-equivalent to the reference's HardyWeinbergModel
(src/core/models/genotype/hardy_weinberg_model.{hpp,cpp}): genotype prior
from haplotype frequencies under random mating,

  p(g) = multinomial(ploidy; counts) * prod_h f_h^{count_h}

with either fixed frequencies or the uniform (empirical max-entropy)
default.
"""

from __future__ import annotations

from math import lgamma, log

import numpy as np


class HardyWeinbergModel:
    def __init__(self, haplotype_log_frequencies: np.ndarray | None = None,
                 n_haplotypes: int | None = None):
        if haplotype_log_frequencies is not None:
            self.log_freqs = np.asarray(haplotype_log_frequencies, np.float64)
        else:
            assert n_haplotypes is not None
            self.log_freqs = np.full(n_haplotypes, -log(n_haplotypes))

    def evaluate_many(self, genotypes: np.ndarray) -> np.ndarray:
        """(G,) log priors for a (G, P) genotype index matrix."""
        G, P = genotypes.shape
        out = np.zeros(G)
        if P == 0:
            return out
        # multinomial coefficient over per-haplotype counts
        out += lgamma(P + 1)
        srt = np.sort(genotypes, axis=1)
        for g in range(G):
            counts: dict[int, int] = {}
            for h in srt[g]:
                counts[int(h)] = counts.get(int(h), 0) + 1
            for h, c in counts.items():
                out[g] += c * self.log_freqs[h] - lgamma(c + 1)
        return out

    def prime(self, haplotypes) -> None:
        if len(self.log_freqs) != len(haplotypes):
            self.log_freqs = np.full(len(haplotypes), -log(len(haplotypes)))


__all__ = ["HardyWeinbergModel"]
