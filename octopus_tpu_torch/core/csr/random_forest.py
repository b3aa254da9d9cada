"""Random-forest call filtering with vectorised tree-ensemble inference.

Capability-equivalent to the reference's RandomForestFilter
(src/core/csr/filters/random_forest_filter.{hpp,cpp}) which feeds measure
vectors through a vendored ranger ForestProbability and emits
RFGQ = phred(P(error)).  Here the ensemble is stored as dense arrays
(feature index / threshold / child pointers / leaf probability per node) so
a whole call batch evaluates as a handful of device gathers — a
TPU-friendly formulation of forest inference.

Both the reference's ranger ``.forest``/``.forest.gz`` binary files (parsed
by `load_ranger_forest`, format per lib/ranger/Forest.cpp:841-905 +
ForestProbability.cpp:275-315) and our ``.npz`` dense format load; a bundled
trainer (bootstrap + greedy CART) fits forests from labelled measure tables
(the role of the reference's scripts/forest.smk pipeline).
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass

import numpy as np


@dataclass
class Forest:
    """Dense node-array ensemble. All arrays (n_trees, max_nodes)."""

    feature: np.ndarray     # int32, -1 at leaves
    threshold: np.ndarray   # float32
    left: np.ndarray        # int32 child index
    right: np.ndarray       # int32
    value: np.ndarray       # float32 leaf P(true positive)
    measures: list[str]     # feature names, order defines the input vector

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        """(n_samples,) P(true positive); X (n_samples, n_features)."""
        n_trees = self.feature.shape[0]
        n = X.shape[0]
        votes = np.zeros(n)
        for t in range(n_trees):
            node = np.zeros(n, np.int64)
            feat = self.feature[t]
            thr = self.threshold[t]
            left = self.left[t]
            right = self.right[t]
            # fixed-depth loop: all trees are depth-bounded at build time
            for _ in range(64):
                f = feat[node]
                done = f < 0
                if done.all():
                    break
                go_left = X[np.arange(n), np.maximum(f, 0)] <= thr[node]
                nxt = np.where(go_left, left[node], right[node])
                node = np.where(done, node, nxt)
            votes += self.value[t][node]
        return votes / n_trees

    def save(self, path: str) -> None:
        np.savez_compressed(path, feature=self.feature, threshold=self.threshold,
                            left=self.left, right=self.right, value=self.value,
                            measures=np.asarray(self.measures))

    @staticmethod
    def load(path: str) -> "Forest":
        from ...errors import MalformedFileError, MissingFileError
        import os
        if not os.path.exists(path):
            raise MissingFileError(path, "forest", where="RandomForestFilter",
                                   option="--forest-model")
        try:
            if path.endswith(".forest") or path.endswith(".forest.gz"):
                return load_ranger_forest(path)
            z = np.load(path, allow_pickle=False)
            return Forest(z["feature"], z["threshold"], z["left"], z["right"],
                          z["value"], [str(m) for m in z["measures"]])
        except (ValueError, KeyError, struct.error, EOFError, OSError) as e:
            # MalformedForestFile (random_forest_filter.cpp:355-360)
            raise MalformedFileError(
                path, "forest", detail=str(e), where="RandomForestFilter",
                help="make sure the file is a ranger .forest/.forest.gz or "
                     "an octopus-tpu .npz forest, trained with the same "
                     "measures in the same order as prediction") from None


# ---------------------------------------------------------------------------
# ranger .forest binary reader (lib/ranger serialization)
# ---------------------------------------------------------------------------

_TREE_PROBABILITY = 9


class _R:
    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def u32(self) -> int:
        v = struct.unpack_from("<I", self.d, self.o)[0]
        self.o += 4
        return v

    def u64(self) -> int:
        v = struct.unpack_from("<Q", self.d, self.o)[0]
        self.o += 8
        return v

    def s(self) -> str:
        n = self.u64()
        v = self.d[self.o:self.o + n].decode("latin-1")
        self.o += n
        return v

    def vec(self, fmt: str, size: int) -> np.ndarray:
        n = self.u64()
        v = np.frombuffer(self.d, dtype=fmt, count=n, offset=self.o)
        self.o += n * size
        return v

    def bools(self) -> np.ndarray:
        n = self.u64()
        v = np.frombuffer(self.d, dtype=np.uint8, count=n, offset=self.o)
        self.o += n
        return v.astype(bool)

    def vec2(self, fmt: str, size: int) -> list[np.ndarray]:
        n = self.u64()
        return [self.vec(fmt, size) for _ in range(n)]


def load_ranger_forest(path: str) -> Forest:
    """Parse a ranger ForestProbability file (.forest / .forest.gz) into the
    dense-array ensemble (saveToFile layout: write_meta, treetype,
    class_values, then per tree child_nodeIDs/split_varIDs/split_values/
    terminal_nodes/terminal_class_counts)."""
    raw = open(path, "rb").read()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    if raw.startswith(b"version https://git-lfs"):
        raise ValueError(f"{path} is a git-lfs pointer, not forest data")
    r = _R(raw)
    n_dep = r.u32()
    dep_names = [r.s() for _ in range(n_dep)]
    n_indep = r.u32()
    indep_names = [r.s() for _ in range(n_indep)]
    num_trees = r.u64()
    r.bools()                       # ordered-variable indicators
    treetype = r.u32()
    if treetype != _TREE_PROBABILITY:
        raise ValueError(f"{path}: not a probability forest (treetype={treetype})")
    class_values = r.vec("<f8", 8)
    trees = []
    max_nodes = 1
    for _ in range(num_trees):
        child = r.vec2("<u8", 8)    # [left children, right children]
        split_var = r.vec("<u8", 8)
        split_val = r.vec("<f8", 8)
        terminal_nodes = r.vec("<u8", 8)
        terminal_counts = r.vec2("<f8", 8)
        trees.append((child, split_var, split_val, terminal_nodes, terminal_counts))
        max_nodes = max(max_nodes, len(split_var))
    # P(class==1): octopus trains TP as class value 1 (scripts/forest.smk)
    try:
        tp_idx = int(np.flatnonzero(class_values == 1.0)[0])
    except IndexError:
        tp_idx = int(np.argmax(class_values))
    # float64 thresholds/values: ranger serialises doubles, and a float32
    # round could flip an X <= threshold comparison at a split boundary
    feature = np.full((num_trees, max_nodes), -1, np.int32)
    threshold = np.zeros((num_trees, max_nodes), np.float64)
    left = np.zeros((num_trees, max_nodes), np.int32)
    right = np.zeros((num_trees, max_nodes), np.int32)
    value = np.zeros((num_trees, max_nodes), np.float64)
    for t, (child, split_var, split_val, tnodes, tcounts) in enumerate(trees):
        n = len(split_var)
        lc, rc = child[0][:n], child[1][:n]
        internal = (lc != 0) | (rc != 0)
        feature[t, :n] = np.where(internal, split_var.astype(np.int64), -1)
        threshold[t, :n] = split_val
        left[t, :n] = lc
        right[t, :n] = rc
        for node, counts in zip(tnodes, tcounts):
            tot = counts.sum()
            value[t, int(node)] = counts[tp_idx] / tot if tot > 0 else 0.5
    return Forest(feature, threshold, left, right, value, indep_names)


# ---------------------------------------------------------------------------
# Trainer: bootstrap bagging + greedy gini CART (scripts/forest.smk role)
# ---------------------------------------------------------------------------

def train_forest(X: np.ndarray, y: np.ndarray, measures: list[str],
                 n_trees: int = 50, max_depth: int = 8,
                 min_leaf: int = 5, seed: int = 0) -> Forest:
    rng = np.random.default_rng(seed)
    n, d = X.shape
    max_nodes = 2 ** (max_depth + 1)
    feature = np.full((n_trees, max_nodes), -1, np.int32)
    threshold = np.zeros((n_trees, max_nodes), np.float32)
    left = np.zeros((n_trees, max_nodes), np.int32)
    right = np.zeros((n_trees, max_nodes), np.int32)
    value = np.zeros((n_trees, max_nodes), np.float32)
    m_try = max(1, int(np.sqrt(d)))
    for t in range(n_trees):
        idx = rng.integers(0, n, n)
        Xb, yb = X[idx], y[idx]
        next_node = [1]

        def build(node, rows, depth):
            ys = yb[rows]
            value[t, node] = ys.mean() if len(ys) else 0.5
            if depth >= max_depth or len(rows) < 2 * min_leaf or ys.min() == ys.max():
                return
            feats = rng.choice(d, m_try, replace=False)
            best = None
            parent_gini = _gini(ys)
            for f in feats:
                xs = Xb[rows, f]
                order = np.argsort(xs)
                xs_sorted = xs[order]
                ys_sorted = ys[order]
                csum = np.cumsum(ys_sorted)
                total = csum[-1]
                nn = len(rows)
                ks = np.arange(min_leaf, nn - min_leaf)
                if len(ks) == 0:
                    continue
                valid = xs_sorted[ks - 1] < xs_sorted[ks]
                if not valid.any():
                    continue
                ks = ks[valid]
                p_l = csum[ks - 1] / ks
                p_r = (total - csum[ks - 1]) / (nn - ks)
                g = (ks * p_l * (1 - p_l) + (nn - ks) * p_r * (1 - p_r)) / nn
                k = ks[np.argmin(g)]
                gval = g.min()
                if best is None or gval < best[0]:
                    best = (gval, f, (xs_sorted[k - 1] + xs_sorted[k]) / 2)
            if best is None or best[0] >= parent_gini:
                return
            _, f, thr = best
            if next_node[0] + 2 > max_nodes:
                return
            l, r = next_node[0], next_node[0] + 1
            next_node[0] += 2
            feature[t, node] = f
            threshold[t, node] = thr
            left[t, node] = l
            right[t, node] = r
            go = Xb[rows, f] <= thr
            build(l, rows[go], depth + 1)
            build(r, rows[~go], depth + 1)

        build(0, np.arange(n), 0)
    return Forest(feature, threshold, left, right, value, list(measures))


def _gini(y: np.ndarray) -> float:
    if len(y) == 0:
        return 0.0
    p = y.mean()
    return float(p * (1 - p))


class RandomForestFilter:
    """Classifies calls; RFGQ = phred(P(error)), failing below min quality
    (random_forest_filter.hpp min-forest-quality default 3)."""

    def __init__(self, forest: Forest, min_quality: float = 3.0):
        self.forest = forest
        self.min_quality = min_quality

    def classify(self, measure_dicts: list[dict]) -> tuple[np.ndarray, list[list[str]]]:
        X = np.asarray([[_num(m.get(k)) for k in self.forest.measures]
                        for m in measure_dicts])
        if len(X) == 0:
            return np.zeros(0), []
        p_good = self.forest.predict_proba(X)
        p_err = np.clip(1 - p_good, 1e-10, 1)
        rfgq = -10 * np.log10(p_err)
        fails = [[] if q >= self.min_quality else ["RF"] for q in rfgq]
        return rfgq, fails


def _num(v) -> float:
    """Missing/non-numeric measure -> -1.0, the training-time imputation."""
    if v is None or v is True or v is False:
        return 1.0 if v is True else (-1.0 if v is None else 0.0)
    try:
        f = float(v)
    except (TypeError, ValueError):
        return -1.0
    return f if np.isfinite(f) else -1.0


class ForestCsr:
    """In-run CSR classifier backed by forests (the reference's
    RandomForestFilterFactory path, random_forest_filter.hpp): germline
    calls score with the germline forest, SOMATIC calls with the somatic
    forest when given (somatic_random_forest_filter.hpp), falling back to
    the germline forest otherwise.  Refcall records in a somatic run score
    with the somatic forest unless --use-germline-forest-for-somatic-normals
    is set (somatic_random_forest_filter.cpp:28-37's chooser;
    option_collation.cpp:2374 use_somatic_forest_for_refcalls).  Satisfies
    the same classify() interface as ThresholdFilter plus classify_q()
    returning the RFGQ quality."""

    def __init__(self, germline_path: str, somatic_path: str | None = None,
                 min_quality: float = 3.0,
                 use_somatic_forest_for_refcalls: bool = True):
        self.germline = RandomForestFilter(Forest.load(germline_path), min_quality)
        self.somatic = (RandomForestFilter(Forest.load(somatic_path), min_quality)
                        if somatic_path else None)
        self.use_somatic_forest_for_refcalls = use_somatic_forest_for_refcalls

    def filter_ids(self) -> list[str]:
        return ["RF"]

    def _choose(self, somatic: bool, refcall: bool) -> RandomForestFilter:
        if self.somatic is None:
            return self.germline
        if somatic:
            return self.somatic
        if refcall and self.use_somatic_forest_for_refcalls:
            return self.somatic
        return self.germline

    def classify_q(self, measures: dict, somatic: bool = False,
                   denovo: bool = False,
                   refcall: bool = False) -> tuple[list[str], float]:
        rf = self._choose(somatic, refcall)
        rfgq, fails = rf.classify([measures])
        return fails[0], float(rfgq[0])

    def classify(self, measures: dict, somatic: bool = False,
                 denovo: bool = False, refcall: bool = False) -> list[str]:
        return self.classify_q(measures, somatic=somatic, denovo=denovo,
                               refcall=refcall)[0]


__all__ = ["Forest", "train_forest", "RandomForestFilter", "ForestCsr"]
