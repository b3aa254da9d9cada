"""The plain individual model and allele depth of germline calling, in
PyTorch float64 on the CPU.

The individual model (octopus's src/core/models/genotype/
individual_model.cpp): a genotype g of ploidy P draws each read from one of
its P haplotypes with equal weight, so a read r's log-likelihood under g is
ln sum_{h in g} exp(lnL[h, r]) - ln P, a haplotype counted as often as g
holds it, and g's log-likelihood is the sum over the reads. The posterior
of g is its prior times that likelihood, normalised over the genotypes.

Allele depth over read assignment (octopus's ReadAssigner,
src/core/tools/read_assigner.hpp:63-91, and compute_allele_support): a
read's tie set is the called haplotypes whose likelihood lies within
`margin` of its best. A read with one haplotype in its tie set is assigned
to it; a read with more is tied. An allele's depth (AD) counts the reads
over the site that are assigned to a haplotype carrying the allele, and
the tied reads every haplotype of whose tie set carries it. The assigned
depth (ADP) counts the assigned reads over the site, and the tied ones
whose tie set carries the allele throughout or the reference throughout.
"""

from __future__ import annotations

import math

import torch

MARGIN = 1e-9
UNIT32 = 2.0 ** -24             # float32's unit roundoff


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64, device="cpu")


def genotype_log_likelihoods(lnL, genotypes,
                             dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """(G,) float64 log-likelihood of each genotype: lnL (H, R) the reads'
    log-likelihoods under each haplotype, genotypes (G, P) haplotype
    indices. `dtype` computes it in a narrower type (a control)."""
    lnL = _f64(lnL).to(dtype)
    genotypes = torch.as_tensor(genotypes, dtype=torch.long)
    G, P = genotypes.shape
    if P == 0 or lnL.shape[1] == 0:
        return torch.zeros(G, dtype=torch.float64)
    per_read = torch.logsumexp(lnL[genotypes], dim=1) - math.log(P)  # (G, R)
    return per_read.sum(dim=1).double()


def float32_bound(lnL, genotypes) -> torch.Tensor:
    """(G,) a bound on how far a float32 reduction of the same genotypes
    (the port's card path: m the read's best lnL, S = sum over g's
    haplotypes of exp(lnL - m), m + ln S - ln P, summed over the reads) can
    lie from `genotype_log_likelihoods`.

    With u = 2^-24 and M_r = max_h |lnL[h, r]|: rounding lnL to float32
    moves m and each lnL by at most u M_r, and lnL - m, rounded, by at most
    2 u M_r more, so the exponent errs by at most 4 u M_r; exp errs by at
    most 2 u relatively, the sum of P non-negative terms by P u, and the
    log by 2 u plus the rounding of its result; m + ln S - ln P adds two
    roundings of at most u (M_r + ln P + 2) together. That gives
    u (6 M_r + P + 8) a read, since ln P < P. Summing R per-read values in
    float32, in any order, errs by at most R u sum_r |v_r|. The bound holds
    where no exp(lnL - m) underflows, lnL - m > -87: the mapping-quality
    mixture keeps every read's lnL within 0.23 MQ nats of 0 (58.7 at MQ
    255)."""
    lnL = _f64(lnL)
    genotypes = torch.as_tensor(genotypes, dtype=torch.long)
    G, P = genotypes.shape
    R = lnL.shape[1]
    if P == 0 or R == 0:
        return torch.zeros(G, dtype=torch.float64)
    per_read = torch.logsumexp(lnL[genotypes], dim=1) - math.log(P)  # (G, R)
    M = lnL.abs().amax(dim=0)
    return UNIT32 * ((6 * M + P + 8).sum() + R * per_read.abs().sum(dim=1))


def posteriors(log_likelihoods, log_priors) -> torch.Tensor:
    """(G,) posterior of each genotype from its log-likelihood and log
    prior."""
    joint = _f64(log_likelihoods) + _f64(log_priors)
    return torch.exp(joint - torch.logsumexp(joint, dim=0))


def tie_sets(lnL, margin: float = MARGIN) -> torch.Tensor:
    """(H, R) bool: the haplotypes within `margin` of each read's best."""
    lnL = _f64(lnL)
    if lnL.numel() == 0:
        return torch.zeros(lnL.shape, dtype=torch.bool)
    best = lnL.max(dim=0).values
    return (best[None, :] - lnL) <= margin


def allele_depths(lnL, alt_haps, ref_haps, overlapping,
                  margin: float = MARGIN) -> tuple:
    """(AD, ADP, tied reads credited to the allele) over the reads that
    `overlapping` (R,) marks: lnL (H, R) the reads' log-likelihoods under
    the sample's called haplotypes, alt_haps (H,) the haplotypes that carry
    the allele, ref_haps (H,) those that carry the reference at the
    site."""
    ties = tie_sets(lnL, margin)
    alt_haps = torch.as_tensor(alt_haps, dtype=torch.bool)
    ref_haps = torch.as_tensor(ref_haps, dtype=torch.bool)
    over = torch.as_tensor(overlapping, dtype=torch.bool)
    ad = adp = credited = 0
    for r in range(ties.shape[1]):
        if not over[r]:
            continue
        haps = torch.nonzero(ties[:, r]).flatten()
        all_alt = bool(alt_haps[haps].all()) and len(haps) > 0
        all_ref = bool(ref_haps[haps].all()) and len(haps) > 0
        if len(haps) == 1:
            adp += 1
            ad += int(all_alt)
        elif len(haps) > 1:
            adp += int(all_alt or all_ref)
            ad += int(all_alt)
            credited += int(all_alt)
    return ad, adp, credited


__all__ = ["genotype_log_likelihoods", "float32_bound", "posteriors",
           "tie_sets", "allele_depths", "MARGIN", "UNIT32"]
