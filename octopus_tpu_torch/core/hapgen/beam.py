"""Likelihood-pruned haplotype growth (HaplotypeTree + filtering equivalent).

Capability-equivalent to the reference's HaplotypeTree extend/prune driven by
Caller::call's generate -> likelihood -> filter loop
(haplotype_tree.hpp:35-143, caller.cpp:411-533, haplotype_filter.cpp): site
groups are added left-to-right to a beam of partial haplotype paths; when an
extension would exceed the haplotype cap, paths are pruned by read support
scores computed from a device likelihood round (max-likelihood assignment
counts, the reference's primary filter heuristic), with the reference path
protected.  No variant is ever silently dropped — dense regions cost pruning
rounds instead (the role of the reference's holdout stack).
"""

from __future__ import annotations

import os

import numpy as np

from ..likelihood.likelihood_array import (ROUTING, HaplotypeLikelihoodArray,
                                           LikelihoodConfig)
from ..types.haplotypes import Haplotype
from ..types.variants import Variant
from .generator import group_exclusive_sites


def grow_haplotypes_beam(
    region_begin: int,
    region_end: int,
    variants: list[Variant],
    ref_fetch,
    reads_by_sample,
    max_haplotypes: int,
    likelihood_config: LikelihoodConfig | None = None,
    cache: dict | None = None,
    flank_state=None,
    pad: int | None = None,
) -> list[Haplotype]:
    """Haplotypes over [region_begin, region_end) considering ALL variants."""
    groups = group_exclusive_sites(variants)
    paths: list[tuple[Variant, ...]] = [()]
    for group in groups:
        opts: list[Variant | None] = [None] + list(group)
        if len(paths) * len(opts) > max_haplotypes and len(paths) > 1:
            keep = max(max_haplotypes // len(opts), 2)
            paths = _prune_paths(paths, region_begin, region_end, ref_fetch,
                                 reads_by_sample, keep, likelihood_config,
                                 cache, flank_state, pad)
        new_paths = []
        for p in paths:
            for v in opts:
                if v is None:
                    new_paths.append(p)
                else:
                    if p and not (p[-1].end <= v.begin):
                        continue
                    new_paths.append(p + (v,))
        paths = new_paths
    if len(paths) > max_haplotypes:
        paths = _prune_paths(paths, region_begin, region_end, ref_fetch,
                             reads_by_sample, max_haplotypes,
                             likelihood_config, cache, flank_state, pad)
    haps = [Haplotype.build(region_begin, region_end, p, ref_fetch) for p in paths]
    # sequence-identical paths (e.g. the same indel proposed at two anchors
    # inside a repeat, or equivalent variant compositions) are one haplotype
    # to the model: keep the first representative, as the reference's
    # sequence-equality haplotype comparison does (haplotype.cpp operator==)
    seen: dict[bytes, None] = {}
    unique = []
    for h in haps:
        key = h.sequence.tobytes()
        if key not in seen:
            seen[key] = None
            unique.append(h)
    return unique


def _prune_paths(paths, begin, end, ref_fetch, reads_by_sample, keep,
                 likelihood_config, cache=None, flank_state=None, pad=None):
    """Keep the `keep` best-supported paths (reference path protected)."""
    if len(paths) <= keep:
        return paths
    # score only reads fully contained in the haplotype region: overhanging
    # reads force shifted anchor windows whose junk scores differ per
    # haplotype and can outvote the true path
    contained = [b.take((b.begins >= begin) & (b.ends <= end))
                 for b in reads_by_sample]
    if any(len(b) for b in contained):
        reads_by_sample = contained
    # reads overlapping only UNANIMOUS variant decisions (in every surviving
    # path, or in none) score identically on every path and cannot change
    # the ranking; restrict to the span of DISAGREEING variants (the live
    # branches of the reference's haplotype tree) — dense noisy regions
    # otherwise re-score every fragment at every pruning round
    from collections import Counter
    cnt = Counter(v for p in paths for v in p)
    live = [v for v, c in cnt.items() if c != len(paths)]
    if live:
        lo_v = min(v.begin for v in live) - 64
        hi_v = max(v.end for v in live) + 64
        focused = [b.take((b.begins < hi_v) & (b.ends > lo_v))
                   for b in reads_by_sample]
        if any(len(b) for b in focused):
            reads_by_sample = focused
    # ranking ~max_haplotypes paths needs read VOTES, not every read: cap
    # the pruning read set with an evenly-spaced (begin-sorted, so
    # coverage-uniform) deterministic subsample — deep fragment piles
    # otherwise make every pruning round O(paths x full depth)
    cap = int(os.environ.get("OCTOPUS_TPU_PRUNE_READS", "96"))
    reads_by_sample = [
        b if len(b) <= cap
        else b.take(np.linspace(0, len(b) - 1, cap).astype(np.int64))
        for b in reads_by_sample]
    ROUTING.record_prune_round()
    haps = [Haplotype.build(begin, end, p, ref_fetch) for p in paths]
    arr = HaplotypeLikelihoodArray(likelihood_config or LikelihoodConfig())
    arr.populate(reads_by_sample, [h.sequence for h in haps], begin,
                 flank_state=flank_state,
                 substitution_masks=[h.substitution_mask() for h in haps],
                 cache=cache, pad=pad)
    # score: assignment counts with SPLIT credit on ties (each read divides
    # its vote among the tied paths), tiebroken by total likelihood.  Full
    # credit on ties would let partial paths free-ride on reads they explain
    # locally, and exact ties then resolve by beam insertion order — which
    # systematically discards the newest site (haplotype_filter.cpp scores,
    # adapted for incremental use)
    n = len(paths)
    assign = np.zeros(n)
    total = np.zeros(n)
    for s in range(len(reads_by_sample)):
        lnL = arr.sample_matrix(s)
        if lnL.shape[1] == 0:
            continue
        m = lnL.max(axis=0)
        ties = (lnL >= m[None, :] - 1e-9)
        assign += (ties / np.maximum(ties.sum(axis=0), 1)[None, :]).sum(axis=1)
        total += lnL.sum(axis=1)
    order = np.lexsort((-total, -assign))
    kept = set(int(i) for i in order[:keep])
    ref_idx = next((i for i, p in enumerate(paths) if not p), None)
    if ref_idx is not None:
        kept.add(ref_idx)
    return [paths[i] for i in sorted(kept)]


__all__ = ["grow_haplotypes_beam"]
