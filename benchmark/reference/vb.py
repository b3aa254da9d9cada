"""The plain variational Bayes of the subclone model: a Dirichlet mixture of
K haplotypes over a sample's reads, in NumPy float64.

The model (octopus's src/core/models/genotype/
variational_bayes_mixture_model.hpp): each read comes from one of a
genotype's K haplotypes, with weights w ~ Dirichlet(alpha0). Coordinate
ascent from a seed's responsibilities: alpha = alpha0 + the responsibilities
summed over reads; then, `iterations` times, responsibilities = softmax over
K of E[ln w] + the reads' log-likelihoods, and alpha again. The evidence
bound (ELBO) of the last state is the expected log-likelihood, the
expected log prior of the assignments and the weights, and their entropies.
A genotype's log evidence is its best ELBO over the seeds.

The seeds: uniform responsibilities, then one Dirichlet(1, ..., 1) draw a
seed from a generator seeded 0, each drawn at the padded read count
32 * 4^k >= N and cut to the N reads.

`rounding` gives the control: "bfloat16" rounds every intermediate to
bfloat16 (8 bits of mantissa, nearest even), the precision below the
float32 the model states.
"""

from __future__ import annotations

import numpy as np
from scipy.special import digamma, gammaln


def _bf16(x):
    a = np.asarray(x, np.float32)
    u = a.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


ROUNDINGS = {None: lambda x: np.asarray(x, np.float64), "bfloat16": _bf16}


def seeds(K: int, N: int, n_seeds: int) -> np.ndarray:
    """(S, K, N) seed responsibilities."""
    rung = 32
    while rung < N:
        rung *= 4
    rng = np.random.default_rng(0)
    out = [np.full((K, rung), 1.0 / K, np.float32)]
    for _ in range(n_seeds - 1):
        out.append(rng.dirichlet(np.ones(K), size=rung).astype(np.float32).T)
    return np.stack(out)[:, :, :N].astype(np.float64)


def log_evidences(lnl, alpha0, *, iterations: int, n_seeds: int,
                  rounding: str | None = None) -> np.ndarray:
    """(G,) log evidence of each genotype: lnl (G, K, N) its reads'
    log-likelihoods under its K haplotypes, alpha0 (K,) the prior
    concentrations."""
    r = ROUNDINGS[rounding]
    lnl = r(lnl)[:, None]                                   # (G, 1, K, N)
    a0 = r(alpha0)
    G, _, K, N = lnl.shape

    def e_ln_w(alpha):
        return r(r(digamma(alpha)) - r(digamma(r(alpha.sum(-1, keepdims=True)))))

    def responsibilities(alpha):
        x = r(e_ln_w(alpha)[..., None] + lnl)               # (G, S, K, N)
        x = r(np.exp(r(x - x.max(-2, keepdims=True))))
        return r(x / r(x.sum(-2, keepdims=True)))

    resp = np.broadcast_to(r(seeds(K, N, n_seeds)), (G, n_seeds, K, N))
    alpha = r(a0 + r(resp.sum(-1)))
    for _ in range(iterations):
        resp = responsibilities(alpha)
        alpha = r(a0 + r(resp.sum(-1)))
    elw = e_ln_w(alpha)                                     # (G, S, K)
    ll = r((r(resp * lnl)).sum((-2, -1)))
    z_prior = r((r(resp * elw[..., None])).sum((-2, -1)))
    z_entropy = -r((r(resp * r(np.log(np.maximum(resp, 1e-30))))).sum((-2, -1)))
    w_prior = r(r(gammaln(a0.sum())) - r(gammaln(a0).sum())
                + r((r((a0 - 1) * elw)).sum(-1)))
    w_entropy = -r(r(gammaln(r(alpha.sum(-1)))) - r(r(gammaln(alpha)).sum(-1))
                   + r((r((alpha - 1) * elw)).sum(-1)))
    elbo = r(ll + z_prior + z_entropy + w_prior + w_entropy)  # (G, S)
    return elbo.max(-1)


__all__ = ["log_evidences", "seeds", "ROUNDINGS"]
