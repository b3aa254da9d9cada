"""De novo mutation model: P(child haplotype | parent haplotype).

Capability-equivalent to the reference's DeNovoModel
(src/core/models/mutation/denovo_model.{hpp,cpp}) with its heavy memoisation.
The reference scores via a pair-HMM alignment between haplotype sequences
with mutation priors; here haplotypes carry their explicit variant sets, so
for haplotypes over the same region the transition probability is the
product of per-difference mutation priors over the symmetric difference
(equivalent for non-overlapping explicit variants; HMM-based scoring of
arbitrary sequences is the refinement path for haplotypes from different
builds).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

from ..types.haplotypes import Haplotype


@dataclass(frozen=True)
class DeNovoParams:
    snv_prior: float = 1.3e-8       # denovo-snv-prior default
    indel_prior: float = 1e-9       # denovo-indel-prior default


class DeNovoModel:
    def __init__(self, params: DeNovoParams | None = None):
        self.params = params or DeNovoParams()
        self._cache: dict[tuple[int, int], float] = {}
        self._context = None          # lazy ContextIndelModel over the parent
        self._context_key = None

    def ln_probability(self, child_idx: int, parent_idx: int,
                       haplotypes: list[Haplotype]) -> float:
        """ln P(child haplotype | parent haplotype) by haplotype index."""
        key = (child_idx, parent_idx)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        child = haplotypes[child_idx]
        parent = haplotypes[parent_idx]
        cs = set(child.variants)
        ps = set(parent.variants)
        lnp = 0.0
        for v in cs.symmetric_difference(ps):
            if v.is_indel():
                # repeat-context, size-dependent indel prior (the reference
                # scores via its IndelMutationModel context; indel_mutation.py
                # reproduces that model)
                ctx = self._context_for(parent)
                lnp += math.log(max(ctx.indel_probability(
                    v.begin - parent.begin, max(v.indel_size(), 1)), 1e-300))
            else:
                lnp += math.log(self.params.snv_prior)
        self._cache[key] = lnp
        return lnp

    def _context_for(self, parent: Haplotype):
        key = id(parent)
        if self._context_key != key:
            from .indel_mutation import ContextIndelModel, IndelMutationParams
            self._context = ContextIndelModel(
                parent.sequence,
                IndelMutationParams(indel_mutation_prior=self.params.indel_prior))
            self._context_key = key
        return self._context

    # -- arbitrary-sequence path (denovo_model.cpp evaluate_uncached) -------

    PAD_PENALTY = 60          # denovo_model.cpp:34 pad_penalty_
    BAND = 8                  # hmm band size (default pair-HMM)

    def ln_probability_sequences(self, child: "np.ndarray",
                                 parent: "np.ndarray") -> float:
        """ln P(child sequence | parent sequence) for arbitrary sequences.

        Mirrors the reference's evaluate_uncached: when the length distance
        fits the HMM band, banded-align child against the N-padded parent
        with repeat-context gap penalties and a flat SNV penalty, then
        recompute the probability from the alignment ops (substitutions at
        snv_prior, indel runs at the context indel model); otherwise fall
        back to a global alignment decomposition (the role of
        calculate_approx_log_probability)."""
        import numpy as np
        from .indel_mutation import ContextIndelModel, IndelMutationParams

        child = np.asarray(child, np.uint8)
        parent = np.asarray(parent, np.uint8)
        ctx = ContextIndelModel(
            parent, IndelMutationParams(indel_mutation_prior=self.params.indel_prior))
        snv_log_prior = math.log(self.params.snv_prior)
        if abs(len(child) - len(parent)) < self.BAND:
            ops, first = self._align_hmm(child, parent, ctx)
            if ops is not None and first == self.BAND:
                return self._recalculate(ops, child, parent, ctx, snv_log_prior)
        return self._approx_from_global_alignment(child, parent, ctx,
                                                  snv_log_prior)

    @staticmethod
    def _prob_to_penalty(p: float) -> int:
        return max(0, min(127, int(round(-10.0 * math.log10(max(p, 1e-300))))))

    def _align_hmm(self, child, parent, ctx):
        import numpy as np
        from ..likelihood import pairhmm_ref as ph

        pad = self.BAND
        R = len(child)
        W = R + 2 * pad - 1
        if pad + len(parent) > W:
            return None, None
        win = np.full(W, 4, np.uint8)                 # N padding
        win[pad:pad + len(parent)] = parent
        opn = np.full(W, self.PAD_PENALTY, np.int16)
        ext = np.full(W, self.PAD_PENALTY, np.int16)
        opn[pad:pad + len(parent)] = [self._prob_to_penalty(p)
                                      for p in ctx.gap_open]
        ext[pad:pad + len(parent)] = [
            self._prob_to_penalty(float(ctx.gap_extend[i, 1]))
            for i in range(len(parent))]
        snv_pen = self._prob_to_penalty(self.params.snv_prior)
        quals = np.full(R, snv_pen, np.uint8)
        try:
            aln = ph.banded_align(win, child, quals, opn, ext, pad=pad)
        except Exception:
            return None, None
        return aln.ops, aln.first_pos

    def _recalculate(self, ops, child, parent, ctx, snv_log_prior):
        """Probability from alignment ops (recalculate_log_probability)."""
        result = 0.0
        pos = 0          # parent position
        ci = 0           # child position
        i = 0
        n = len(ops)
        while i < n:
            op = ops[i]
            j = i
            while j < n and ops[j] == op:
                j += 1
            length = j - i
            if op == "M":
                for k in range(length):
                    if (pos + k < len(parent) and ci + k < len(child)
                            and parent[pos + k] != child[ci + k]):
                        result += snv_log_prior
                pos += length
                ci += length
            else:
                p = ctx.indel_probability(min(pos, len(parent) - 1), length)
                result += math.log(max(p, 1e-300))
                if op == "D":
                    pos += length
                else:
                    ci += length
            i = j
        return result

    def _approx_from_global_alignment(self, child, parent, ctx, snv_log_prior):
        from ..vargen.assembler import global_align
        ops = global_align(parent, child)
        result = 0.0
        pos = 0
        ci = 0
        for length, op in ops:
            if op == "M":
                for k in range(length):
                    if parent[pos + k] != child[ci + k]:
                        result += snv_log_prior
                pos += length
                ci += length
            elif op == "D":       # consumes parent: deletion in child
                p = ctx.indel_probability(min(pos, len(parent) - 1), length)
                result += math.log(max(p, 1e-300))
                pos += length
            else:                 # I consumes child: insertion
                p = ctx.indel_probability(min(pos, len(parent) - 1), length)
                result += math.log(max(p, 1e-300))
                ci += length
        return result


__all__ = ["DeNovoModel", "DeNovoParams"]
