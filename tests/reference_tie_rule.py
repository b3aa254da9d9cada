"""octopus's rule for tied reads, applied to the JAX reference package.

The port credits a tied read to an allele (the reference's
compute_allele_support over an AmbiguousRead's haplotypes,
read_assigner.hpp:63-91): a read whose likelihood ties on several called
haplotypes supports an allele when every haplotype it ties on carries the
allele, and the reference side when every one carries no allele at the
site. The JAX package counts no tied read. The tests that hold the port's
records against the JAX package's make the package's records under this
rule, with `applied()` around the calls that make them; nothing else runs
under it, and no file of the package changes.

This is a plain implementation of the rule, a read at a time, on the
package's own objects; it imports nothing of the port.
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import pytest


def _with_tie_sets(original):
    def assignment_from_matrix(lnL, unique_haps, ambiguous_margin=1e-9):
        a = original(lnL, unique_haps, ambiguous_margin)
        lnL = np.asarray(lnL)
        tie_haps = []
        for r in range(lnL.shape[1]):
            column = lnL[:, r]
            best = column.max()
            tie_haps.append(tuple(unique_haps[k] for k in range(len(column))
                                  if best - column[k] <= ambiguous_margin))
        a.tie_haplotypes = tie_haps
        return a
    return assignment_from_matrix


def _sides(haps, variant):
    """(alt, ref): the indices of the haplotypes that carry this alt, and
    of those that carry no allele at the site."""
    alt, ref = set(), set()
    for i, h in enumerate(haps):
        if any(v.begin == variant.begin and v.alt == variant.alt
               for v in h.variants):
            alt.add(i)
        elif not any(v.begin == variant.begin for v in h.variants):
            ref.add(i)
    return alt, ref


def _reads_over(b, variant):
    begin = variant.begin
    end = max(variant.end, variant.begin + 1)
    return [i for i in range(len(b))
            if b.begins[i] < end and b.ends[i] > begin]


def _supports(a, i, side):
    """Whether read i of Assignment `a` supports the haplotypes `side`."""
    h = int(a.hap_of_read[i])
    if h >= 0:
        return h in side
    ties = a.tie_haplotypes[i]
    return len(ties) > 1 and all(t in side for t in ties)


def allele_support_context(self, variant):
    out = []
    for b, a, haps in zip(self.overlapping_reads, self.read_assignments,
                          self.called_haplotypes_by_sample):
        if a is None or not len(b):
            out.append((0, 0))
            continue
        alt, ref = _sides(haps, variant)
        ad = depth = 0
        for i in _reads_over(b, variant):
            if _supports(a, i, alt):
                ad += 1
            if a.hap_of_read[i] >= 0 or _supports(a, i, alt) \
                    or _supports(a, i, ref):
                depth += 1
        out.append((ad, depth))
    return out


def allele_assignment_support(self, variant):
    from octopus_tpu.core.csr.facets import AlleleSupportSet
    out = []
    for b, a, haps in zip(self.overlapping_reads, self.read_assignments,
                          self.called_haplotypes_by_sample):
        if a is None or not len(b):
            out.append(None)
            continue
        alt, ref = _sides(haps, variant)
        over = _reads_over(b, variant)
        entry = {"n_overlapping": len(over),
                 "n_ambiguous": sum(1 for i in over if a.hap_of_read[i] < 0)}
        for key, side in (("alt", alt), ("ref", ref)):
            sel = np.asarray([i for i in range(len(b)) if _supports(a, i, side)],
                             np.int64)
            entry[key] = AlleleSupportSet(
                begins=b.begins[sel], ends=b.ends[sel],
                seq_lengths=b.lengths()[sel],
                is_forward=(b.flags[sel] & 0x10) == 0,
                reads=[(b, int(i)) for i in sel])
        out.append(entry)
    return out


def apply(mp: pytest.MonkeyPatch) -> None:
    """The rule on the JAX package, undone with `mp`; its process pool's
    workers take it too."""
    from octopus_tpu import run
    from octopus_tpu.core.csr import facets
    from octopus_tpu.core.tools import read_assigner
    mp.setattr(read_assigner, "_assignment_from_matrix",
               _with_tie_sets(read_assigner._assignment_from_matrix))
    mp.setattr(facets.FacetBundle, "allele_support_context",
               allele_support_context)
    mp.setattr(facets.FacetBundle, "allele_assignment_support",
               allele_assignment_support)
    mp.setattr(run, "_process_worker_init", worker_init)


def worker_init(*args):
    """The JAX package's process-pool initializer, with the rule applied
    in the worker for its life."""
    from octopus_tpu import run
    original = run._process_worker_init
    apply(pytest.MonkeyPatch())
    original(*args)


@contextmanager
def applied():
    """The JAX package under the rule for the block's duration."""
    with pytest.MonkeyPatch.context() as mp:
        apply(mp)
        yield


__all__ = ["apply", "applied", "worker_init"]
