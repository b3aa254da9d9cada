"""Single-cell caller over clone phylogenies.

Capability-equivalent to the reference's CellCaller + SingleCellModel
(src/core/callers/cell_caller.cpp, single_cell_model.hpp:27-142,
phylogeny.hpp): enumerates clone phylogenies up to --max-phylogeny-size
(founder germline genotype; each descendant clone adds one somatic
haplotype to its ancestor's genotype), scores each with the two-level VB
mixture (cells x clones, reads x clone haplotypes), and compares phylogeny
posteriors.  Somatic calls carry clone counts and the phylogeny posterior
(PPP).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..hapgen.generator import group_exclusive_sites
from ..models.denovo import DeNovoModel, DeNovoParams
from ..models.genotype_likelihoods import genotype_log_likelihoods_np
from ..models.individual import logsumexp
from ..models.mixture_mixture_vb import VariationalBayesMixtureMixtureModel
from ..types.genotypes import generate_all_genotypes
from ..types.phylogeny import enumerate_tree_shapes
from .base import (
    ActiveRegionContext,
    BaseCallerConfig,
    CallerBase,
    SiteCall,
    phred_not,
)


@dataclass
class CellCallerConfig(BaseCallerConfig):
    max_phylogeny_size: int = 3
    somatic_snv_prior: float = 1e-4
    somatic_indel_prior: float = 1e-5
    max_founders: int = 5
    max_somatic_candidates: int = 4
    dropout_concentration: float = 5.0      # --dropout-concentration
    phylogeny_concentration: float = 20.0   # --phylogeny-concentration
    clone_prior_penalty: float = math.log(1e-3)   # per extra clone
    # copy-number change detection; CLI defaults 0/0/1e-5
    # (option_parser.cpp:699-708; ploidy-1 clamp as cell_caller.cpp:44)
    max_copy_loss: int = 0                  # --max-copy-loss
    max_copy_gain: int = 0                  # --max-copy-gain
    somatic_cnv_prior: float = 1e-5         # --somatic-cnv-prior


@dataclass
class _Structure:
    founder_gi: int
    parents: list            # parent index per clone (None for founder)
    somatic: list            # somatic haplotype per non-founder clone
    members: list            # per clone: haplotype indices
    score: float = -np.inf
    assignments: np.ndarray | None = None


class CellCaller(CallerBase):
    def _infer_and_call(self, ctx: ActiveRegionContext) -> list[SiteCall]:
        cfg = self.config
        n_cells = len(ctx.lnL)
        H = len(ctx.haplotypes)
        genotypes = generate_all_genotypes(H, cfg.ploidy)
        log_priors = ctx.prior_model.evaluate_many(genotypes)
        cell_liks = np.stack([genotype_log_likelihoods_np(ctx.lnL[c], genotypes)
                              for c in range(n_cells)])        # (cells, G)
        pooled = log_priors + cell_liks.sum(axis=0)
        top_g = np.argsort(pooled)[::-1][:cfg.max_founders]
        denovo = DeNovoModel(DeNovoParams(cfg.somatic_snv_prior, cfg.somatic_indel_prior))
        mm = VariationalBayesMixtureMixtureModel(
            alpha0=cfg.dropout_concentration,
            beta0=cfg.phylogeny_concentration,
            n_seeds=min(cfg.max_vb_seeds, 4), device=cfg.device)

        structures: list[_Structure] = []
        for gi in top_g:
            g = genotypes[gi]
            # size-1 phylogeny: every cell is the founder clone
            s1 = _Structure(int(gi), [None], [], [list(g)])
            s1.score = log_priors[gi] + cell_liks[:, gi].sum()
            s1.assignments = np.zeros(n_cells, int)
            structures.append(s1)
            if cfg.max_phylogeny_size >= 2 and H > len(set(g)):
                # somatic haplotype candidates ranked by marginal read support
                cand = [h for h in range(H) if h not in g]
                support = {h: sum(float(np.sum(ctx.lnL[c][h])) for c in range(n_cells))
                           for h in cand}
                cand.sort(key=lambda h: -support[h])
                cand = cand[:cfg.max_somatic_candidates]
                for size in range(2, cfg.max_phylogeny_size + 1):
                    if len(cand) < size - 1:
                        continue
                    for parents in enumerate_tree_shapes(size):
                        for assign in _permutations(cand, size - 1):
                            members = [list(g)]
                            lp_som = 0.0
                            for node in range(1, size):
                                parent_members = members[parents[node]]
                                h = assign[node - 1]
                                lp_som += max(
                                    denovo.ln_probability(h, int(x), ctx.haplotypes)
                                    for x in parent_members)
                                members.append(parent_members + [h])
                            inf = mm.evaluate([ctx.lnL[c] for c in range(n_cells)],
                                              members)
                            st = _Structure(int(gi), parents, list(assign), members)
                            st.score = (inf.log_evidence + log_priors[gi] + lp_som
                                        + cfg.clone_prior_penalty * (size - 1))
                            st.assignments = inf.map_assignments
                            structures.append(st)
            # copy-number change clones (cell_caller.cpp:342-355,415-441):
            # a descendant clone whose genotype loses or gains haplotype
            # copies relative to the founder, at --somatic-cnv-prior per
            # copy-change event
            max_loss = min(cfg.max_copy_loss, cfg.ploidy - 1)
            max_gain = cfg.max_copy_gain
            if (max_loss > 0 or max_gain > 0) and cfg.max_phylogeny_size >= 2:
                ln_cnv = math.log(max(cfg.somatic_cnv_prior, 1e-300))
                variants_members = []
                for loss in range(1, max_loss + 1):
                    seen_m = set()
                    for drop in _combinations(range(len(g)), loss):
                        m = [h for k, h in enumerate(g) if k not in set(drop)]
                        key = tuple(sorted(m))
                        if key not in seen_m and len(m) >= 1:
                            seen_m.add(key)
                            variants_members.append((m, loss))
                for gain in range(1, max_gain + 1):
                    seen_m = set()
                    for dup in _combinations_wr(sorted(set(g)), gain):
                        m = list(g) + list(dup)
                        key = tuple(sorted(m))
                        if key not in seen_m:
                            seen_m.add(key)
                            variants_members.append((m, gain))
                for m, n_events in variants_members:
                    members = [list(g), m]
                    inf = mm.evaluate([ctx.lnL[c] for c in range(n_cells)],
                                      members)
                    st = _Structure(int(gi), [None, 0], [], members)
                    st.score = (inf.log_evidence + log_priors[gi]
                                + n_events * ln_cnv
                                + cfg.clone_prior_penalty)
                    st.assignments = inf.map_assignments
                    structures.append(st)
        scores = np.asarray([s.score for s in structures])
        log_post = scores - logsumexp(scores)
        best = structures[int(np.argmax(log_post))]
        founder = genotypes[best.founder_gi]
        somatic_set = set(best.somatic)
        ppp = phred_not(np.asarray([log_post[i] for i, s in enumerate(structures)
                                    if s is not best]))

        called = []
        info_of = {}
        for vi, v in enumerate(ctx.variants):
            has_v = ctx.contains[vi]
            present = np.asarray([
                has_v[genotypes[s.founder_gi]].any()
                or any(has_v[h] for h in s.somatic)
                for s in structures])
            phred = phred_not(log_post[~present])
            in_best = has_v[founder].any() or any(has_v[h] for h in somatic_set)
            if phred >= self.config.min_variant_posterior_phred and in_best:
                called.append((v, phred))
                if not has_v[founder].any():
                    som_clones = [ci for ci, ms in enumerate(best.members)
                                  if any(has_v[h] for h in ms)]
                    n_som_cells = int(np.isin(best.assignments, som_clones).sum())
                    info_of[v] = {"SOMATIC": True, "CELLS": n_som_cells,
                                  "PPP": round(float(ppp), 2)}
        if not called:
            return []
        site_groups = group_exclusive_sites([v for v, _ in called])
        quality_of = {v: q for v, q in called}
        site_alleles = self.make_site_alleles(ctx, site_groups)
        out = []
        for si, group in enumerate(site_groups):
            hap_allele = site_alleles[si]
            gts = []
            for c in range(len(ctx.lnL)):
                clone = int(best.assignments[c]) if best.assignments is not None else 0
                members = best.members[min(clone, len(best.members) - 1)]
                gts.append([int(hap_allele[h]) for h in members])
            info = {}
            for v in group:
                info.update(info_of.get(v, {}))
            out.append(SiteCall(
                begin=min(v.begin for v in group),
                end=max(v.end for v in group),
                alts=list(group),
                quality=max(quality_of[v] for v in group),
                genotypes=gts,
                genotype_qualities=[quality_of[group[0]]] * len(gts),
                phase_set=group[0].begin,
                alt_qualities=[quality_of[v] for v in group],
                info=info,
            ))
        return out


def _permutations(items, k):
    import itertools
    return itertools.permutations(items, k)


def _combinations(items, k):
    import itertools
    return itertools.combinations(items, k)


def _combinations_wr(items, k):
    import itertools
    return itertools.combinations_with_replacement(items, k)


__all__ = ["CellCaller", "CellCallerConfig"]
