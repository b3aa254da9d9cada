"""Forest-training data preparation (TrainingFilterFactory parity).

The reference's training mode (--disable-call-filtering + --annotations,
option_collation.cpp:2306-2309) swaps in a PassingVariantCallFilter
(src/core/csr/filters/{training_filter_factory,passing_filter}.{hpp,cpp})
that marks every call PASS while annotating the requested measures; the
measure matrix is then extracted to a table and labelled against a truth
set for ranger training (scripts/forest.smk).  This module provides both
halves natively: the passing classification and the VCF -> measure-table
extraction feeding csr.random_forest.train_forest.
"""

from __future__ import annotations

import csv
import math

import numpy as np

from ...io.vcf import VcfReader
from .measures import ALL_MEASURES


class PassingFilter:
    """PassingVariantCallFilter: classify everything PASS, annotate measures."""

    def __init__(self, measures: tuple[str, ...] = ()):
        self.measures = tuple(measures) or tuple(ALL_MEASURES)

    def classify(self, measures: dict, somatic: bool = False,
                 denovo: bool = False) -> list[str]:
        return []

    def filter_ids(self) -> list[str]:
        return []


def extract_measure_table(vcf_path: str, measures: list[str] | None = None,
                          csv_path: str | None = None):
    """Collect per-record measure vectors from an annotated octopus-tpu VCF.

    Measures are read from INFO (site-level annotations as written by the
    --annotations run mode).  Returns (names, X, records) and optionally
    writes a CSV with CHROM/POS/REF/ALT key columns, the forest.smk layout.
    """
    reader = VcfReader(vcf_path)
    names = list(measures) if measures else None
    rows: list[list[float]] = []
    keys: list[tuple] = []
    for rec in reader:
        if names is None:
            names = sorted(k for k, v in rec.info.items()
                           if _is_number(v))
        row = []
        for nm in names:
            v = rec.info.get(nm)
            if v is None and rec.sample_values:
                v = rec.sample_values[0].get(nm)
            row.append(float(v) if _is_number(v) else math.nan)
        rows.append(row)
        keys.append((rec.chrom, rec.pos, rec.ref, ",".join(rec.alts or [])))
    X = np.asarray(rows, dtype=np.float64) if rows else np.zeros((0, 0))
    if csv_path is not None and names is not None:
        with open(csv_path, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["CHROM", "POS", "REF", "ALT", *names])
            for key, row in zip(keys, rows):
                w.writerow([*key, *row])
    return names or [], X, keys


def label_against_truth(keys: list[tuple], truth_vcf: str) -> np.ndarray:
    """0/1 labels: is each (chrom, pos, ref, alt) present in the truth VCF?

    The crude positional labelling step of forest.smk (which shells out to
    rtg vcfeval); adequate for training forests on synthetic/validated data.
    """
    truth: set[tuple] = set()
    for rec in VcfReader(truth_vcf):
        for alt in rec.alts or []:
            truth.add((rec.chrom, rec.pos, rec.ref, alt))
    labels = np.zeros(len(keys), dtype=np.int64)
    for i, (chrom, pos, ref, alts) in enumerate(keys):
        if any((chrom, pos, ref, a) in truth for a in alts.split(",")):
            labels[i] = 1
    return labels


def _is_number(v) -> bool:
    if isinstance(v, (int, float, np.floating, np.integer)):
        return True
    if isinstance(v, str):
        try:
            float(v)
            return True
        except ValueError:
            return False
    return False


__all__ = ["PassingFilter", "extract_measure_table", "label_against_truth"]
