"""CSR facet framework: lazily-computed shared context per call block.

Capability-equivalent to the reference's facet set built by FacetFactory
(src/core/csr/facets/, facet_factory.hpp:28-79): Samples, OverlappingReads,
ReadAssignments (per-haplotype support via HMM-scored assignment),
ReferenceContext, RepeatContext, Alleles, Genotypes, Pedigree, Ploidies,
ReadsSummary.  Measures receive one FacetBundle per call block; each facet
is computed at most once however many measures consume it.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from ...basics.reads import ReadBatch
from ..types.haplotypes import Haplotype
from ..types.variants import Variant


@dataclass
class AlleleSupportSet:
    """Reads assigned as supporting one allele (the reference's
    ReadRefSupportSet): mapped extents, sequencing-direction flags, and
    handles back to the batch for base-level access."""

    begins: np.ndarray
    ends: np.ndarray
    seq_lengths: np.ndarray
    is_forward: np.ndarray
    reads: list                 # (batch, index) handles

    def __len__(self) -> int:
        return len(self.begins)


@dataclass
class FacetBlock:
    """Inputs identifying one call block (usually one phase set)."""

    contig: str
    begin: int
    end: int
    variants: list            # Variant per called site (first ALT)
    genotypes: list           # per sample: allele indices per site
    reads_by_sample: list     # ReadBatch per sample
    samples: list
    reference: object
    pedigree: object | None = None
    ploidy: int = 2
    # multi-allelic sites: ALL alts per site, parallel to `variants`
    # (genotype allele index a > 0 selects site_alts[site][a-1]); when
    # absent, each site is assumed biallelic with `variants[site]`
    site_alts: list | None = None
    # the run's LikelihoodConfig: read assignment scores on its device with
    # its host-DP gate (None: LikelihoodConfig's defaults)
    scoring: object | None = None


class FacetBundle:
    """Lazy facet container (one per call block)."""

    def __init__(self, block: FacetBlock, pad: int = 100):
        self.block = block
        self._pad = pad

    # -- trivially derived facets -------------------------------------------

    @cached_property
    def samples(self) -> list:
        return list(self.block.samples)

    @cached_property
    def ploidies(self) -> dict:
        return {s: self.block.ploidy for s in self.block.samples}

    @cached_property
    def pedigree(self):
        return self.block.pedigree

    @cached_property
    def alleles(self) -> list:
        return list(self.block.variants)

    @cached_property
    def genotypes(self) -> list:
        return list(self.block.genotypes)

    # -- read facets ---------------------------------------------------------

    @cached_property
    def overlapping_reads(self) -> list:
        """Per sample, reads overlapping the padded block."""
        lo = max(self.block.begin - self._pad, 0)
        hi = self.block.end + self._pad
        return [b.overlapping(lo, hi) for b in self.block.reads_by_sample]

    @cached_property
    def reads_summary(self) -> list:
        """Per sample: (depth, mean length, rms mapq)."""
        out = []
        for b in self.overlapping_reads:
            if len(b) == 0:
                out.append((0, 0.0, 0.0))
                continue
            out.append((len(b), float(b.lengths().mean()),
                        float(np.sqrt(np.mean(b.mapq.astype(np.float64) ** 2)))))
        return out

    # -- reference facets ----------------------------------------------------

    @cached_property
    def reference_context(self) -> tuple[int, np.ndarray]:
        """The called-haplotype span: must cover every overlapping read's
        full extent plus the HMM band, or reads spilling past the haplotype
        ends score identically on all haplotypes and assign ambiguous
        (the reference sizes its ReadAssignments haplotypes the same way,
        read_assignments.hpp)."""
        lo = self.block.begin
        hi = self.block.end
        for b in self.overlapping_reads:
            if len(b):
                lo = min(lo, int(b.begins.min()))
                hi = max(hi, int(b.ends.max()))
        lo = max(lo - self._pad, 0)
        hi = min(hi + self._pad,
                 self.block.reference.contig_size(self.block.contig))
        return lo, self.block.reference.fetch_codes(self.block.contig, lo, hi)

    @cached_property
    def repeat_context(self) -> list:
        from ...utils.tandem import extract_exact_tandem_repeats
        lo, codes = self.reference_context
        reps = extract_exact_tandem_repeats(np.asarray(codes, np.uint8), 1, 6)
        return [(lo + r.pos, r.length, r.period) for r in reps]

    # -- HMM read assignment (the expensive facet) ---------------------------

    @cached_property
    def called_haplotypes(self) -> list[Haplotype]:
        """Haplotypes implied by the called genotypes over the block."""
        lo, codes = self.reference_context
        hi = lo + len(codes)
        fetch = lambda b, e: self.block.reference.fetch_codes(self.block.contig, b, e)
        haps: list[Haplotype] = []
        seen = set()
        for sample_haps in self.called_haplotypes_by_sample:
            for h in sample_haps:
                key = tuple((v.begin, v.alt) for v in h.variants)
                if key not in seen:
                    seen.add(key)
                    haps.append(h)
        if not haps:
            haps.append(Haplotype.build(lo, hi, [], fetch))
        return haps

    @cached_property
    def called_haplotypes_by_sample(self) -> list:
        """Per sample: haplotypes implied by ITS OWN called genotypes.

        Reads are assigned within each sample's genotype only (the
        reference's ReadAssignments keys support per sample per genotype
        haplotype, read_assignments.hpp:25-34) — pooling haplotypes across
        samples makes reads not spanning another sample's private variant
        ambiguous and collapses assigned depth."""
        lo, codes = self.reference_context
        hi = lo + len(codes)
        fetch = lambda b, e: self.block.reference.fetch_codes(
            self.block.contig, b, e)
        site_lists = (self.block.site_alts
                      or [[v] for v in self.block.variants])
        out = []
        for sample_gts in self.block.genotypes:
            # slot count from the sample's own genotypes: somatic/CNV calls
            # carry extra ploidy slots (e.g. tumour 0/0/1), and the somatic
            # haplotype must exist for assignment support
            n_slots = max((len(gt) for gt in sample_gts),
                          default=self.block.ploidy)
            haps = []
            seen = set()
            for k in range(n_slots):
                variants = []
                for alts, gt in zip(site_lists, sample_gts):
                    allele = gt[k] if k < len(gt) else 0
                    if allele > 0:
                        # allele index selects among the site's ALTs
                        variants.append(alts[min(allele, len(alts)) - 1])
                key = tuple((v.begin, v.alt) for v in variants)
                if key not in seen:
                    seen.add(key)
                    haps.append(Haplotype.build(lo, hi, variants, fetch))
            if not haps:
                haps.append(Haplotype.build(lo, hi, [], fetch))
            out.append(haps)
        return out

    @cached_property
    def read_assignments(self) -> list:
        """Per sample: Assignment of each read to one of the SAMPLE'S called
        haplotypes (the reference's ReadAssignments facet re-runs the HMM
        here too)."""
        from ..tools.read_assigner import assign_reads
        lo, _ = self.reference_context
        out = []
        for b, haps in zip(self.overlapping_reads,
                           self.called_haplotypes_by_sample):
            if not len(b):
                out.append(None)
                continue
            out.append(assign_reads(b, haps, list(range(len(haps))), lo,
                                    scoring=self.block.scoring))
        return out

    def allele_support(self, variant: Variant) -> list:
        """Per sample: reads that support the alt by the rule of
        `allele_support_context`."""
        return [alt for alt, _ in self.allele_support_context(variant)]

    def allele_support_context(self, variant: Variant) -> list:
        """Per sample (alt_support, depth) among reads overlapping the
        variant, from HMM read-to-haplotype assignment — the reference's
        AD/ADP/AF source (read_assignments.hpp:25-34, allele_depth.cpp).

        A read supports the alt when it is assigned to a haplotype that
        carries it, or when it is tied and every haplotype it ties on
        carries it (the reference's compute_allele_support over an
        AmbiguousRead's haplotypes, read_assigner.hpp:63-91): over a hom
        site every called haplotype carries the alt, so the reads there,
        tied when no het site lies within a read, all count. The depth
        counts the assigned reads and the tied reads whose tie set is all
        alt or all reference at the site. The tied reads credited to the
        alt are counted in likelihood_array.ROUTING.tied_reads_credited."""
        from ..likelihood.likelihood_array import ROUTING
        from ...utils import timers
        assignments = self.read_assignments      # assignment runs outside the phase
        out = []
        with timers.phase("allele_support"):
            credited = 0
            for b, a, haps in zip(self.overlapping_reads, assignments,
                                  self.called_haplotypes_by_sample):
                if a is None or not len(b):
                    out.append((0, 0))
                    continue
                over = _overlapping(b, variant)
                alt, ref, tied = _supporting_reads(a, *_site_haplotypes(
                    haps, variant))
                depth = over & (~tied | alt | ref)
                credited += int((over & alt & tied).sum())
                out.append((int((over & alt).sum()), int(depth.sum())))
            ROUTING.record_tied_credits(credited)
        return out

    def allele_assignment_support(self, variant: Variant) -> list:
        """Per sample: assignment-based per-allele read support — the
        reference's AlleleSupportMap (read_assignments.hpp:25-34,
        compute_allele_support), restricted to this site's ref and alt
        alleles.

        Returns, per sample, a dict with:
          'alt'/'ref': AlleleSupportSet of the reads that support the
                       allele / the reference at this site, by the rule of
                       `allele_support_context` (haplotypes carrying a
                       DIFFERENT alt of the same site support neither),
          'n_overlapping', 'n_ambiguous': overlapping-read accounting for
                       ARF (ambiguous_read_fraction.cpp:34-53).
        """
        from ...utils import timers
        assignments = self.read_assignments      # assignment runs outside the phase
        out = []
        with timers.phase("allele_support"):
            for b, a, haps in zip(self.overlapping_reads, assignments,
                                  self.called_haplotypes_by_sample):
                if a is None or not len(b):
                    out.append(None)
                    continue
                over = _overlapping(b, variant)
                alt, ref, tied = _supporting_reads(a, *_site_haplotypes(
                    haps, variant))
                entry = {
                    "n_overlapping": int(over.sum()),
                    "n_ambiguous": int((over & tied).sum()),
                }
                for key, reads in (("alt", alt), ("ref", ref)):
                    sel = np.flatnonzero(reads)
                    entry[key] = AlleleSupportSet(
                        begins=b.begins[sel], ends=b.ends[sel],
                        seq_lengths=b.lengths()[sel],
                        is_forward=(b.flags[sel] & 0x10) == 0,
                        reads=[(b, int(i)) for i in sel])
                out.append(entry)
        return out

    def mean_likelihoods(self, begin: int, end: int) -> list:
        """Per sample: mean phred of assigned-read likelihoods over the
        call region, per called haplotype (mean_likelihood.cpp MHL)."""
        from ...basics.phred import LN10_DIV_10
        out = []
        end = max(end, begin + 1)
        for b, a, haps in zip(self.overlapping_reads, self.read_assignments,
                              self.called_haplotypes_by_sample):
            if a is None or a.log_likelihoods is None or not len(b):
                out.append(None)
                continue
            over = (b.begins < end) & (b.ends > begin)
            per_hap = []
            for h in range(len(haps)):
                sel = over & (a.hap_of_read == h)
                if sel.any():
                    phreds = a.log_likelihoods[sel] / -LN10_DIV_10
                    per_hap.append(float(np.mean(phreds)))
            out.append(max(per_hap) if per_hap else None)
        return out

    def duplicate_concordance(self, variant: Variant) -> float | None:
        """Fraction of duplicate read groups overlapping the call whose
        members agree on carrying/not-carrying the alt
        (duplicate_concordance.cpp DC). None when no duplicate groups exist
        — the usual case after preprocessing removes duplicates."""
        from .measures import _read_supports
        vb = variant.begin
        ve = max(variant.end, variant.begin + 1)
        alt_codes = np.frombuffer(variant.alt, np.uint8)
        n_groups = 0
        n_concordant = 0
        for b in self.overlapping_reads:
            if not len(b):
                continue
            sub = b.take((b.begins < ve) & (b.ends > vb))
            if not len(sub):
                continue
            keys: dict = {}
            for i in range(len(sub)):
                sup, _, _ = _read_supports(sub, i, vb, variant.end,
                                           alt_codes,
                                           variant.is_insertion(),
                                           variant.is_deletion(), 0)
                key = (int(sub.begins[i]), int(sub.ends[i]),
                       int(sub.flags[i]) & 0x10)
                keys.setdefault(key, []).append(bool(sup))
            for members in keys.values():
                if len(members) > 1:
                    n_groups += 1
                    if len(set(members)) == 1:
                        n_concordant += 1
        if n_groups == 0:
            return None
        return n_concordant / n_groups


def _overlapping(b: ReadBatch, variant: Variant) -> np.ndarray:
    vb = variant.begin
    ve = max(variant.end, variant.begin + 1)
    return (b.begins < ve) & (b.ends > vb)


def _site_haplotypes(haps: list, variant: Variant) -> tuple:
    """(alt, ref) bool masks over `haps`: the haplotypes that carry this
    alt, and those that carry no allele at the site."""
    alt = np.zeros(len(haps), bool)
    ref = np.zeros(len(haps), bool)
    for i, h in enumerate(haps):
        if any(v.begin == variant.begin and v.alt == variant.alt
               for v in h.variants):
            alt[i] = True
        elif not any(v.begin == variant.begin for v in h.variants):
            ref[i] = True
    return alt, ref


def _supporting_reads(a, alt_haps: np.ndarray, ref_haps: np.ndarray) -> tuple:
    """(alt, ref, tied) bool masks over an Assignment's reads: a read
    supports a side when it is assigned to one of its haplotypes, or when
    it is tied and every haplotype of its tie set is one of them."""
    h = a.hap_of_read
    tied = h < 0
    slot = np.where(tied, 0, h)
    alt = ~tied & alt_haps[slot]
    ref = ~tied & ref_haps[slot]
    if a.ties is not None and tied.any():
        alt |= tied & ~np.any(a.ties & ~alt_haps[:, None], axis=0)
        ref |= tied & ~np.any(a.ties & ~ref_haps[:, None], axis=0)
    return alt, ref, tied


__all__ = ["AlleleSupportSet", "FacetBlock", "FacetBundle"]
