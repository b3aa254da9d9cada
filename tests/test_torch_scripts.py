"""The user scripts of docs/guides.md, ported as octopus_tpu_torch.scripts,
against the reference repository's scripts/ on the same small inputs, on
the CPU:

* long_phase: both passes through each package's CLI on a simulated 5 kb
  diploid at 30x; identical VCF record lines;
* split_realigned_bam and filter_assigned_reads on an evidence BAM written
  by the port's --bamout (FULL: unassigned reads too): identical BAMs and
  BAIs, byte for byte;
* train_forest --synthetic at 40 kb, a clean and a noisy replicate: the
  same trees and the same votes on both measure tables.

The originals run under octopus's rule for tied reads
(`reference_tie_rule`), which the port follows and the JAX package does
not. The reference CLI pins its host paths below 1 Mb by leaving
OCTOPUS_TPU_HOST_HMM_MAX and OCTOPUS_TPU_HOST_LATENTS in the environment;
both are cleared before every port run.
"""

import filecmp
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest

import reference_tie_rule as tie_rule

from octopus_tpu_torch import cli
from octopus_tpu_torch.scripts import (filter_assigned_reads, long_phase,
                                       split_realigned_bam, train_forest)
from octopus_tpu_torch.utils.synthetic import simulate_diploid

ROOT = Path(__file__).resolve().parent.parent
PINNED = ("OCTOPUS_TPU_HOST_HMM_MAX", "OCTOPUS_TPU_HOST_LATENTS")


def original(name):
    """The reference repository's scripts/<name>.py as a module."""
    spec = importlib.util.spec_from_file_location(
        f"ref_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def unpinned(monkeypatch):
    """Restores the environment after a reference run and clears its pins
    before a port run."""
    def clear():
        for k in PINNED:
            monkeypatch.delenv(k, raising=False)
    clear()
    return clear


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    d = tmp_path_factory.mktemp("scripts")
    fa, bam, truth, _ = simulate_diploid(str(d), kb=5, depth=30, seed=5,
                                         spacing=(150, 450))
    return d, fa, bam


@pytest.fixture(scope="module")
def evidence_bam(sample):
    d, fa, bam = sample
    saved = {k: os.environ.pop(k, None) for k in PINNED}
    try:
        out = str(d / "evidence.bam")
        assert cli.main(["-R", fa, "-I", bam, "-o", str(d / "calls.vcf"),
                         "--bamout", out, "--bamout-type", "FULL",
                         "--device", "cpu"]) == 0
    finally:
        for k, v in saved.items():
            if v is not None:
                os.environ[k] = v
    return out


def records(path):
    return [line for line in Path(path).read_text().splitlines()
            if not line.startswith("##")]


def test_long_phase_writes_the_originals_records(sample, tmp_path, unpinned):
    _, fa, bam = sample
    want, got = tmp_path / "ref.vcf", tmp_path / "port.vcf"
    with tie_rule.applied():
        assert original("long_phase").main(["-R", fa, "-I", bam,
                                            "-o", str(want)]) == 0
    unpinned()
    assert long_phase.main(["-R", fa, "-I", bam, "-o", str(got),
                            "--device", "cpu"]) == 0
    assert [line for line in records(got) if not line.startswith("#")]
    assert records(got) == records(want)
    assert not (tmp_path / "port.tmp.vcf").exists()


def bams_in(d):
    return sorted(p.name for p in Path(d).iterdir())


def same_dirs(a, b):
    names = bams_in(a)
    return names == bams_in(b) and all(
        filecmp.cmp(Path(a) / n, Path(b) / n, shallow=False) for n in names)


@pytest.mark.parametrize("assigned_only", [False, True])
def test_split_realigned_bam_writes_the_originals_bams(evidence_bam, tmp_path,
                                                       assigned_only):
    want, got = tmp_path / "ref", tmp_path / "port"
    want.mkdir()
    got.mkdir()
    flags = ["-A"] if assigned_only else []
    assert original("split_realigned_bam").main(
        ["-b", evidence_bam, "-o", str(want / "hp"), *flags]) == 0
    assert split_realigned_bam.main(
        ["-b", evidence_bam, "-o", str(got / "hp"), *flags]) == 0
    # one BAM and one BAI a haplotype-id tuple, and more than one tuple
    assert len(bams_in(got)) >= 4
    assert ("hp_R.bam" in bams_in(got)) != assigned_only
    assert same_dirs(want, got)


@pytest.mark.parametrize("region", [None, "chr1:1,000-3,000"])
def test_filter_assigned_reads_writes_the_originals_bam(evidence_bam,
                                                        tmp_path, region):
    want, got = tmp_path / "ref.bam", tmp_path / "port.bam"
    extra = ["-T", region] if region else []
    assert original("filter_assigned_reads").main(
        ["-I", evidence_bam, "-O", str(want), *extra]) == 0
    assert filter_assigned_reads.main(
        ["-I", evidence_bam, "-O", str(got), *extra]) == 0
    from octopus_tpu_torch.io.bam import BamFile
    (batch,) = BamFile(str(got)).fetch("chr1", 0, 5000, keep_aux=True).values()
    assert len(batch) and all("," not in str(batch.tag(i, "HP"))
                              for i in range(len(batch)))
    for ext in ("", ".bai"):
        assert filecmp.cmp(str(want) + ext, str(got) + ext, shallow=False)


def test_train_forest_synthetic_trains_the_originals_forest(tmp_path,
                                                           unpinned):
    """The same trees, and the same votes on both measure tables. The
    noisy replicate's window is large enough that the port's genotype
    reduction takes its float32 torch path where the reference's small run
    pins the float64 host path: a few annotations (MP, and QUAL and GQ at
    two records) differ in their sixth digit, and so does the threshold of
    one split (by 5e-5), which sits between the same two training values in
    both forests."""
    from octopus_tpu_torch.core.csr.random_forest import Forest
    argv = ["--synthetic", "--kb", "40", "--depth", "20", "--seeds", "101",
            "202", "--trees", "5", "--max-depth", "4"]
    runs = {}
    for name, mod, extra in (("ref", original("train_forest"), []),
                             ("port", train_forest, ["--device", "cpu"])):
        unpinned()
        out, csv = tmp_path / f"{name}.npz", tmp_path / f"{name}.csv"
        with tie_rule.applied():
            assert mod.main([*argv, "-o", str(out), "--csv", str(csv),
                             *extra]) == 0
        table = np.loadtxt(csv, delimiter=",", skiprows=1)
        runs[name] = (Forest.load(str(out)), table[:, :-1], table[:, -1],
                      csv.read_text().splitlines()[0])
    (fa, Xa, ya, ha), (fb, Xb, yb, hb) = runs["ref"], runs["port"]
    assert ha == hb and Xa.shape == Xb.shape and len(ya) > 40
    np.testing.assert_array_equal(ya, yb)
    assert fa.measures == fb.measures
    for k in ("feature", "left", "right", "value"):
        np.testing.assert_array_equal(getattr(fa, k), getattr(fb, k),
                                      err_msg=k)
    assert (fb.feature >= 0).any()          # the trees split
    for X in (Xa, Xb):
        np.testing.assert_array_equal(fa.predict_proba(X),
                                      fb.predict_proba(X))
