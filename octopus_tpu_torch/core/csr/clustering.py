"""Unsupervised clustering call filter (experimental, like the reference's).

Capability-equivalent to the reference's UnsupervisedClusteringFilter
(src/core/csr/filters/unsupervised_clustering_filter.{hpp,cpp}): a
double-pass filter that records the full measure vector of every call, drops
all-missing feature columns (unsupervised_clustering_filter.cpp:67-99), and
classifies calls from cluster structure.  The reference leaves the actual
clustering as a TODO shell; here the intended capability is implemented:
standardised k-means over the measure matrix with the lowest-quality
minority cluster marked as failing ("UCF").
"""

from __future__ import annotations

import math

import numpy as np


class UnsupervisedClusteringFilter:
    FILTER_ID = "UCF"

    def __init__(self, k: int = 2, minority_fraction: float = 0.2,
                 seed: int = 0, max_iter: int = 50):
        self.k = k
        self.minority_fraction = minority_fraction
        self.seed = seed
        self.max_iter = max_iter
        self._names: list[str] | None = None
        self._rows: list[list[float]] = []

    # -- pass 1: record ------------------------------------------------
    def record(self, measures: dict) -> None:
        if self._names is None:
            self._names = sorted(k for k, v in measures.items()
                                 if isinstance(v, (int, float, np.floating, np.integer)))
        row = []
        for name in self._names:
            v = measures.get(name)
            if isinstance(v, (int, float, np.floating, np.integer)) \
                    and math.isfinite(float(v)):
                row.append(float(v))
            else:
                row.append(math.nan)
        self._rows.append(row)

    # -- pass 2: classify ----------------------------------------------
    def classify_all(self) -> list[list[str]]:
        """Per-call failed-filter lists (empty = PASS), in record order."""
        n = len(self._rows)
        if n == 0:
            return []
        X = np.asarray(self._rows, dtype=np.float64)
        # drop all-missing columns (remove_missing_features parity)
        keep = ~np.all(np.isnan(X), axis=0)
        X = X[:, keep]
        if X.shape[1] == 0 or n <= self.k:
            return [[] for _ in range(n)]
        # median-impute remaining missing values, then z-score
        med = np.nanmedian(X, axis=0)
        idx = np.where(np.isnan(X))
        X[idx] = np.take(med, idx[1])
        sd = X.std(axis=0)
        sd[sd == 0] = 1.0
        Z = (X - X.mean(axis=0)) / sd
        labels = _kmeans(Z, self.k, self.seed, self.max_iter)
        # the minority cluster fails if it is both small and lower quality
        # (QUAL/GQ-correlated features are standardised, so compare the mean
        # standardised quality column when present, else overall centroid norm)
        qual_col = None
        if self._names is not None:
            kept_names = [nm for nm, kp in zip(self._names, keep) if kp]
            for candidate in ("QUAL", "GQ", "QD"):
                if candidate in kept_names:
                    qual_col = kept_names.index(candidate)
                    break
        counts = np.bincount(labels, minlength=self.k)
        fail_clusters: set[int] = set()
        for c in range(self.k):
            if counts[c] == 0 or counts[c] > self.minority_fraction * n:
                continue
            members = Z[labels == c]
            others = Z[labels != c]
            if qual_col is not None:
                worse = members[:, qual_col].mean() < others[:, qual_col].mean()
            else:
                worse = np.linalg.norm(members.mean(axis=0)) > \
                    np.linalg.norm(others.mean(axis=0))
            if worse:
                fail_clusters.add(c)
        return [[self.FILTER_ID] if int(l) in fail_clusters else []
                for l in labels]

    def filter_ids(self) -> list[str]:
        return [self.FILTER_ID]


def _kmeans(Z: np.ndarray, k: int, seed: int, max_iter: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = Z.shape[0]
    # k-means++ style seeding: first centre random, rest by farthest distance
    centres = [Z[rng.integers(n)]]
    for _ in range(1, k):
        d2 = np.min([np.sum((Z - c) ** 2, axis=1) for c in centres], axis=0)
        centres.append(Z[int(np.argmax(d2))])
    C = np.stack(centres)
    labels = np.zeros(n, dtype=np.int64)
    for _ in range(max_iter):
        d = np.sum((Z[:, None, :] - C[None, :, :]) ** 2, axis=2)
        new_labels = np.argmin(d, axis=1)
        if np.array_equal(new_labels, labels) and _ > 0:
            break
        labels = new_labels
        for c in range(k):
            m = labels == c
            if m.any():
                C[c] = Z[m].mean(axis=0)
    return labels


__all__ = ["UnsupervisedClusteringFilter"]
