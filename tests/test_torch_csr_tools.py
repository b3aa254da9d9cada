"""The port's forest, training and clustering CSR against the reference's.

The same numpy-seeded inputs go through both packages' modules: the
shipped forests (resources/forests/*.npz) and a ranger .forest written by
the reference's own vendored ranger (tests/golden/golden_ranger) load into
the same arrays and predict the same probabilities; train_forest gives the
same trees for a seed; PassingFilter, extract_measure_table,
label_against_truth and UnsupervisedClusteringFilter give the same outputs.
Every comparison is exact.
"""

import gzip
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from octopus_tpu.core.csr import clustering as ref_clustering
from octopus_tpu.core.csr import random_forest as ref_rf
from octopus_tpu.core.csr import training as ref_training
from octopus_tpu_torch.core.csr import clustering, random_forest, training
from octopus_tpu_torch.io.vcf import VcfHeader, VcfRecord, VcfWriter

ROOT = Path(__file__).resolve().parent.parent
FORESTS = ROOT / "resources" / "forests"
GOLDEN = ROOT / "tests" / "golden" / "golden_ranger"
FOREST_ARRAYS = ("feature", "threshold", "left", "right", "value")


def assert_forests_equal(got, want):
    for name in FOREST_ARRAYS:
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert got.measures == want.measures


@pytest.mark.parametrize("name", ["germline", "somatic"])
def test_shipped_forest_loads_and_predicts_as_the_reference(name):
    path = str(FORESTS / f"{name}.npz")
    got = random_forest.Forest.load(path)
    want = ref_rf.Forest.load(path)
    assert_forests_equal(got, want)
    assert got.feature.shape[0] == 100
    rng = np.random.default_rng(11)
    X = rng.normal(size=(300, len(got.measures))) * 50.0
    X[::7] = -1.0                     # the missing-measure imputation
    assert np.array_equal(got.predict_proba(X), want.predict_proba(X))


def test_forest_csr_classifies_as_the_reference():
    germline, somatic = str(FORESTS / "germline.npz"), str(FORESTS / "somatic.npz")
    got = random_forest.ForestCsr(germline, somatic, 3.0)
    want = ref_rf.ForestCsr(germline, somatic, 3.0)
    rng = np.random.default_rng(5)
    measures = got.germline.forest.measures + got.somatic.forest.measures
    for i in range(40):
        m = {k: float(v) for k, v in
             zip(measures, rng.normal(size=len(measures)) * 30.0)}
        if i % 5 == 0:
            m[measures[0]] = None
        for somatic_call in (False, True):
            assert got.classify_q(m, somatic=somatic_call) == \
                want.classify_q(m, somatic=somatic_call)
    assert got.filter_ids() == want.filter_ids() == ["RF"]


@pytest.fixture(scope="module")
def ranger_forest(tmp_path_factory):
    """A forest trained and saved by the reference's vendored ranger, with
    its own predictions for a seeded test set."""
    if not os.access(GOLDEN, os.X_OK):
        pytest.skip("golden ranger binary unavailable")
    tmp = tmp_path_factory.mktemp("ranger")
    measures = ["AD", "AF", "DP", "GQ", "MQ", "QD", "QUAL", "SB"]
    rng = np.random.default_rng(42)
    X = rng.normal(size=(600, len(measures)))
    y = (X[:, 0] * 1.3 - X[:, 4] * 0.8 + X[:, 6] + rng.normal(size=600) * 0.3
         > 0).astype(int)
    train = tmp / "train.dat"
    with open(train, "w") as fh:
        fh.write(" ".join(measures + ["TP"]) + "\n")
        for row, label in zip(X, y):
            fh.write(" ".join(f"{v:.6f}" for v in row) + f" {label}\n")
    prefix = str(tmp / "model")
    r = subprocess.run([str(GOLDEN), "train", str(train), prefix, "25", "7"],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    forest = prefix + ".forest"
    forest_gz = str(tmp / "model.forest.gz")
    with open(forest, "rb") as fi, gzip.open(forest_gz, "wb") as fo:
        shutil.copyfileobj(fi, fo)
    Xt = rng.normal(size=(200, len(measures)))
    test = tmp / "test.dat"
    with open(test, "w") as fh:
        fh.write(" ".join(measures + ["TP"]) + "\n")
        for row in Xt:
            fh.write(" ".join(f"{v:.6f}" for v in row) + " 0\n")
    r = subprocess.run([str(GOLDEN), "predict", forest, str(test),
                        str(tmp / "pred")], capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    lines = (tmp / "pred.prediction").read_text().splitlines()
    col = [float(v) for v in lines[1].split()].index(1.0)
    golden = np.asarray([[float(v) for v in line.split()]
                         for line in lines[3:] if line.strip()])[:, col]
    return measures, forest, forest_gz, Xt, golden


@pytest.mark.parametrize("form", ["forest", "forest_gz"])
def test_ranger_reader_equals_the_reference_and_ranger(ranger_forest, form):
    measures, forest, forest_gz, Xt, golden = ranger_forest
    path = forest if form == "forest" else forest_gz
    got = random_forest.load_ranger_forest(path)
    assert_forests_equal(got, ref_rf.load_ranger_forest(path))
    assert got.measures == measures and got.feature.shape[0] == 25
    p = got.predict_proba(Xt)
    assert np.array_equal(p, ref_rf.load_ranger_forest(path).predict_proba(Xt))
    # the golden file prints %g (6 significant digits)
    np.testing.assert_allclose(p, golden, atol=5e-6)


def test_train_forest_gives_the_reference_trees(tmp_path):
    rng = np.random.default_rng(0)
    n = 400
    y = (rng.random(n) < 0.5).astype(np.float64)
    X = np.stack([np.where(y > 0, rng.normal(200, 60, n), rng.normal(25, 15, n)),
                  np.where(y > 0, rng.normal(58, 3, n), rng.normal(35, 12, n)),
                  rng.random(n)], axis=1)
    names = ["QUAL", "MQ", "SB"]
    got = random_forest.train_forest(X, y, names, n_trees=8, seed=3)
    want = ref_rf.train_forest(X, y, names, n_trees=8, seed=3)
    assert_forests_equal(got, want)
    path = str(tmp_path / "trained.npz")
    got.save(path)
    assert_forests_equal(ref_rf.Forest.load(path), want)
    rfgq, fails = random_forest.RandomForestFilter(got).classify(
        [{"QUAL": 250.0, "MQ": 60.0, "SB": 0.1},
         {"QUAL": 5.0, "MQ": 20.0, "SB": 0.9}])
    want_q, want_fails = ref_rf.RandomForestFilter(want).classify(
        [{"QUAL": 250.0, "MQ": 60.0, "SB": 0.1},
         {"QUAL": 5.0, "MQ": 20.0, "SB": 0.9}])
    assert np.array_equal(rfgq, want_q) and fails == want_fails


def _annotated_vcf(path, n=12, seed=4):
    rng = np.random.default_rng(seed)
    header = VcfHeader()
    header.add_info("QD", "1", "Float", "qual by depth")
    header.add_info("SB", "1", "Float", "strand bias")
    header.add_info("AD", "1", "Integer", "allele depth")
    with VcfWriter(str(path), header) as w:
        for i in range(n):
            info = {"QD": round(float(rng.normal(10, 3)), 4),
                    "SB": round(float(rng.random()), 4)}
            if i % 4:
                info["AD"] = int(rng.integers(1, 40))
            w.write(VcfRecord("chr1", 100 + 7 * i, ".", "A",
                              ["C"] if i % 3 else ["C", "T"], 50.0 + i,
                              ["PASS"], info))
    return str(path)


def test_training_tools_give_the_reference_outputs(tmp_path):
    vcf = _annotated_vcf(tmp_path / "annotated.vcf")
    truth = _annotated_vcf(tmp_path / "truth.vcf", n=6)
    for measures in (["QD", "SB", "AD"], None):
        got = training.extract_measure_table(
            vcf, measures, csv_path=str(tmp_path / "port.csv"))
        want = ref_training.extract_measure_table(
            vcf, measures, csv_path=str(tmp_path / "ref.csv"))
        assert got[0] == want[0] and got[2] == want[2]
        assert np.array_equal(got[1], want[1], equal_nan=True)
        assert (tmp_path / "port.csv").read_text() == \
            (tmp_path / "ref.csv").read_text()
        assert np.array_equal(training.label_against_truth(got[2], truth),
                              ref_training.label_against_truth(want[2], truth))
    f, g = training.PassingFilter(("QD", "SB")), ref_training.PassingFilter(("QD", "SB"))
    assert f.classify({"QUAL": 1.0}) == g.classify({"QUAL": 1.0}) == []
    assert f.filter_ids() == g.filter_ids() and f.measures == g.measures
    assert training.PassingFilter().measures == ref_training.PassingFilter().measures


@pytest.mark.parametrize("k,seed", [(2, 1), (3, 7)])
def test_unsupervised_clustering_gives_the_reference_labels(k, seed):
    rng = np.random.default_rng(seed)
    got = clustering.UnsupervisedClusteringFilter(k=k, seed=seed)
    want = ref_clustering.UnsupervisedClusteringFilter(k=k, seed=seed)
    for i in range(120):
        bad = i % 9 == 0
        m = {"QUAL": (5 if bad else 300) + rng.normal(0, 10),
             "GQ": (3 if bad else 90) + rng.normal(0, 3),
             "SB": rng.uniform(.7, 1.0) if bad else rng.uniform(0, .2),
             "MISSING": float("nan")}
        got.record(m)
        want.record(m)
    assert got.classify_all() == want.classify_all()
    assert got.filter_ids() == want.filter_ids() == ["UCF"]
