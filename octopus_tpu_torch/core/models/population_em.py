"""Approximate joint population-model reduction for large cohorts.

Mirrors the reference PopulationModel's strategy when the full joint space
G^S exceeds --max-genotype-combinations
(src/core/models/genotype/population_model.cpp:560-615):

1. **EM marginals** (:120-300): per-sample genotype posteriors under a
   shared Hardy-Weinberg prior whose haplotype frequencies are fit by EM
   (init uniform; update freq[h] = sum over genotypes containing h of the
   summed sample posteriors, normalised by S*ploidy; stop at max 100
   iterations or max frequency change <= 0.001).
2. **Top-k joint tuples** (:501, src/utils/select_top_k.hpp): the k best
   sample-genotype index tuples by product of EM marginals, built by a
   progressive sorted join (Henderson & Eliassi-Rad top-K).
3. **Variations** (:502-520): substitute the globally-best genotypes
   (most top-1 votes across samples) into the best tuple, and always
   include the all-hom-ref tuple.
"""

from __future__ import annotations

import heapq

import numpy as np


def _hw_log_marginals(genotypes: np.ndarray, log_freqs: np.ndarray,
                      lgamma_cache: np.ndarray) -> np.ndarray:
    """(G,) Hardy-Weinberg log genotype probabilities: multinomial over
    per-haplotype counts (hardy_weinberg_model.cpp ln_hardy_weinberg_*)."""
    G, P = genotypes.shape
    out = np.full(G, lgamma_cache[P])
    srt = np.sort(genotypes, axis=1)
    # run-length of equal haplotypes per row
    out += log_freqs[genotypes].sum(axis=1)
    # subtract log(count!) per run of equal haplotypes
    for g in range(G):
        row = srt[g]
        c = 1
        for i in range(1, P):
            if row[i] == row[i - 1]:
                c += 1
            else:
                out[g] -= lgamma_cache[c]
                c = 1
        out[g] -= lgamma_cache[c]
    return out


def em_genotype_marginals(genotypes: np.ndarray, loglik: np.ndarray,
                          n_haplotypes: int, max_iter: int = 100,
                          eps: float = 0.001) -> np.ndarray:
    """(S, G) approximate per-sample genotype posteriors by EM over shared
    Hardy-Weinberg haplotype frequencies
    (compute_approx_genotype_marginal_posteriors,
    population_model.cpp:290-300 + run_em :277-285)."""
    from math import lgamma
    genotypes = np.asarray(genotypes)
    loglik = np.asarray(loglik, np.float64)
    S, G = loglik.shape
    P = genotypes.shape[1]
    lgam = np.asarray([lgamma(i + 1) for i in range(P + 2)])
    # unique-membership table (make_inverse_genotype_table dedups
    # haplotype->genotype indices, population_model.cpp:59-75)
    contains = np.zeros((G, n_haplotypes), dtype=bool)
    rows = np.repeat(np.arange(G), P)
    contains[rows, genotypes.ravel()] = True
    log_freqs = np.full(n_haplotypes, -np.log(n_haplotypes))
    norm = float(S * P)          # frequency_update_norm (:77-80)

    def posteriors(log_marg):
        x = log_marg[None, :] + loglik          # (S, G)
        x = x - x.max(axis=1, keepdims=True)
        p = np.exp(x)
        return p / p.sum(axis=1, keepdims=True)

    log_marg = _hw_log_marginals(genotypes, log_freqs, lgam)
    post = posteriors(log_marg)
    for _ in range(max_iter):
        collapsed = post.sum(axis=0)            # (G,)
        new_freqs = np.maximum(collapsed @ contains / norm, 1e-300)
        change = float(np.max(np.abs(np.exp(log_freqs) - new_freqs)))
        log_freqs = np.log(new_freqs)
        log_marg = _hw_log_marginals(genotypes, log_freqs, lgam)
        post = posteriors(log_marg)
        if change <= eps:
            break
    return post


def select_top_k_tuples(marginals: np.ndarray, k: int) -> np.ndarray:
    """(N<=k, S) genotype-index tuples with the largest products of
    per-sample marginals, in descending score order (select_top_k_tuples,
    src/utils/select_top_k.hpp:181-199): progressive sorted join, keeping
    the k best partial tuples after each sample."""
    S, G = marginals.shape
    logm = np.log(np.clip(marginals, 1e-300, None))
    # partial tuples after sample 0
    m = min(k, G)
    order = np.argsort(logm[0])[::-1][:m]
    part_scores = logm[0][order]                       # descending
    part_tuples = [[int(i)] for i in order]
    for s in range(1, S):
        order = np.argsort(logm[s])[::-1][:min(k, G)]
        cand_scores = logm[s][order]
        # k-best sums of two descending lists via heap
        n_a, n_b = len(part_scores), len(cand_scores)
        heap = [(-(part_scores[0] + cand_scores[0]), 0, 0)]
        seen = {(0, 0)}
        new_scores = []
        new_tuples = []
        while heap and len(new_scores) < k:
            neg, i, j = heapq.heappop(heap)
            new_scores.append(-neg)
            new_tuples.append(part_tuples[i] + [int(order[j])])
            if i + 1 < n_a and (i + 1, j) not in seen:
                heapq.heappush(heap, (-(part_scores[i + 1] + cand_scores[j]),
                                      i + 1, j))
                seen.add((i + 1, j))
            if j + 1 < n_b and (i, j + 1) not in seen:
                heapq.heappush(heap, (-(part_scores[i] + cand_scores[j + 1]),
                                      i, j + 1))
                seen.add((i, j + 1))
        part_scores = np.asarray(new_scores)
        part_tuples = new_tuples
    return np.asarray(part_tuples, dtype=np.int64)


def select_top_k_genotypes(marginals: np.ndarray, k: int) -> list[int]:
    """Genotype indices most often ranked top across samples
    (select_top_k_genotypes, population_model.cpp:452-489)."""
    S, G = marginals.shape
    if G <= k:
        return list(range(G))
    # per-sample descending candidate lists
    lists = [list(np.argsort(marginals[s])[::-1]) for s in range(S)]
    votes = np.zeros(G, np.int64)
    result: list[int] = []
    for _ in range(k + 1):
        for lst in lists:
            if lst:
                votes[lst[0]] += 1
        best = int(np.argmax(votes))
        if best not in result:
            result.append(best)
        votes[best] = 0
        for lst in lists:
            if lst and lst[0] == best:
                lst.pop(0)
    return result


def propose_genotype_combinations(genotypes: np.ndarray,
                                  marginals: np.ndarray,
                                  max_combinations: int,
                                  hom_ref_idx: int | None) -> np.ndarray:
    """(N, S) joint genotype-index combinations for the reduced posterior
    (propose_genotype_combinations, population_model.cpp:492-521)."""
    S, G = marginals.shape
    if G ** S <= max_combinations:
        grids = np.meshgrid(*([np.arange(G)] * S), indexing="ij")
        return np.stack([g.ravel() for g in grids], axis=1)
    result = select_top_k_tuples(marginals, max_combinations)
    rows = [tuple(r) for r in result]
    seen = set(rows)
    best = list(result[0])
    for gidx in select_top_k_genotypes(marginals, max(S // 2, 1)):
        for s in range(S):
            if best[s] != gidx:
                tmp = tuple(best[:s] + [gidx] + best[s + 1:])
                if tmp not in seen:
                    rows.append(tmp)
                    seen.add(tmp)
    if hom_ref_idx is not None:
        ref_tuple = tuple([hom_ref_idx] * S)
        if ref_tuple not in seen:
            rows[-1] = ref_tuple
    return np.asarray(rows, dtype=np.int64)


__all__ = ["em_genotype_marginals", "select_top_k_tuples",
           "select_top_k_genotypes", "propose_genotype_combinations"]
