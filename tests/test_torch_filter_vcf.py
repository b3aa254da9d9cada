"""The port's CSR tools through its CLI against the reference CLI.

On the CPU (--device cpu), every output is compared exactly, line for
line, with the reference package's on the same input:

* standalone CSR (--filter-vcf) of an unfiltered call set of a simulated
  5 kb diploid at 30x, with the threshold filter and with the shipped
  germline forest;
* --filter-vcf against the inline pass on two samples with a
  multi-allelic site, mirroring tests/test_filter_vcf_fidelity.py;
* inline forest CSR (with the somatic forest and a quality floor) and
  training CSR (--disable-call-filtering --annotations);
* inline forest CSR on the process pool against the serial run.

The reference CLI pins OCTOPUS_TPU_HOST_HMM_MAX and
OCTOPUS_TPU_HOST_LATENTS in the environment below 1 Mb; they are restored
after each reference run and cleared before each port run. The reference
runs under octopus's rule for tied reads (`reference_tie_rule`), which the
port follows and the JAX package does not.
"""

import os
from pathlib import Path

import numpy as np
import pytest

import reference_tie_rule as tie_rule
from octopus_tpu import cli as ref_cli
from octopus_tpu_torch import cli, run
from octopus_tpu_torch.basics.reads import FLAG_REVERSE, make_read_batch
from octopus_tpu_torch.config.options import build_parser
from octopus_tpu_torch.io.bam_writer import BamWriter, build_bai
from octopus_tpu_torch.io.vcf import VcfReader
from octopus_tpu_torch.utils.synthetic import simulate_diploid

ROOT = Path(__file__).resolve().parent.parent
PINNED = ("OCTOPUS_TPU_HOST_HMM_MAX", "OCTOPUS_TPU_HOST_LATENTS")
GERMLINE = str(ROOT / "resources" / "forests" / "germline.npz")
SOMATIC = str(ROOT / "resources" / "forests" / "somatic.npz")


def lines(path):
    """Record lines and the header lines that carry no date or command."""
    return [line for line in Path(path).read_text().splitlines()
            if not line.startswith(("##fileDate", "##commandline",
                                    "##source"))]


def reference_main(argv):
    saved = {k: os.environ.get(k) for k in PINNED}
    try:
        with tie_rule.applied():
            assert ref_cli.main(argv) == 0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def port_main(argv, monkeypatch):
    for k in PINNED:
        monkeypatch.delenv(k, raising=False)
    assert cli.main([*argv, "--device", "cpu"]) == 0


@pytest.fixture(scope="module")
def diploid(tmp_path_factory):
    """A 5 kb diploid and the reference CLI's unfiltered calls of it."""
    d = tmp_path_factory.mktemp("filter_vcf")
    fa, bam, _, _ = simulate_diploid(str(d), kb=5, depth=30, seed=5,
                                     spacing=(150, 450))
    raw = str(d / "raw.vcf")
    reference_main(["-R", fa, "-I", bam, "-o", raw,
                    "--disable-call-filtering"])
    return d, fa, bam, raw


FILTERS = {
    "threshold": [],
    "forest": ["--forest-model", GERMLINE],
    "annotated": ["--annotations", "AF", "AD", "SB", "DP"],
}


@pytest.mark.parametrize("mode", sorted(FILTERS))
def test_filter_vcf_writes_the_reference_lines(diploid, monkeypatch, mode):
    d, fa, bam, raw = diploid
    want, got = str(d / f"ref_{mode}.vcf"), str(d / f"port_{mode}.vcf")
    argv = ["-R", fa, "-I", bam, "--filter-vcf", raw, *FILTERS[mode]]
    reference_main([*argv, "-o", want])
    port_main([*argv, "-o", got], monkeypatch)
    assert lines(got) == lines(want)
    records = [r for r in lines(got) if not r.startswith("#")]
    assert len(records) > 5
    if mode == "forest":
        assert all("RFGQ" in r.split("\t")[8] for r in records)


INLINE = {
    "forest_somatic_quality": ["--forest-model", GERMLINE,
                               "--somatic-forest-model", SOMATIC,
                               "--min-forest-quality", "5"],
    "training": ["--disable-call-filtering", "--annotations", "AF", "AD",
                 "SB", "DP", "QD"],
}


@pytest.mark.parametrize("mode", sorted(INLINE))
def test_inline_forest_and_training_csr_write_the_reference_lines(
        diploid, monkeypatch, mode):
    d, fa, bam, _ = diploid
    want, got = str(d / f"ref_inline_{mode}.vcf"), str(d / f"port_inline_{mode}.vcf")
    argv = ["-R", fa, "-I", bam, *INLINE[mode]]
    reference_main([*argv, "-o", want])
    port_main([*argv, "-o", got], monkeypatch)
    assert lines(got) == lines(want)
    records = [r for r in lines(got) if not r.startswith("#")]
    assert len(records) > 5
    if mode == "training":
        assert all(r.split("\t")[6] == "PASS" and "QD=" in r for r in records)


def test_forest_csr_on_the_process_pool_writes_the_serial_lines(
        diploid, monkeypatch):
    d, fa, bam, _ = diploid
    regions = ["-T", "chr1:0-2500", "chr1:2500-5000"]
    argv = ["-R", fa, "-I", bam, *regions, "--forest-model", GERMLINE]
    serial, pool = str(d / "forest_serial.vcf"), str(d / "forest_pool.vcf")
    port_main([*argv, "-o", serial], monkeypatch)
    run.POOL.reset()
    port_main([*argv, "-o", pool, "--threads", "2"], monkeypatch)
    assert run.POOL.worker_windows == 2 and not run.POOL.fallbacks
    assert lines(pool) == lines(serial)
    assert sum(not r.startswith("#") for r in lines(serial)) > 5


@pytest.fixture(scope="module")
def two_sample_multiallelic(tmp_path_factory):
    """Two samples, one multi-allelic site: S0 is 0/1 (alt T), S1 is 0/2
    (alt G) at pos 800; plus a biallelic het private to S1 at 1800 (the
    input of tests/test_filter_vcf_fidelity.py)."""
    tmp_path = tmp_path_factory.mktemp("multiallelic")
    rng = np.random.default_rng(23)
    seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 3000))
    fa = tmp_path / "ref.fa"
    with open(fa, "w") as fh:
        fh.write(">chr1\n")
        for i in range(0, len(seq), 70):
            fh.write(seq[i:i + 70] + "\n")
    base = seq[800]
    alt1 = "T" if base != "T" else "A"
    alt2 = "G" if base not in ("G",) and alt1 != "G" else "C"
    base2 = seq[1800]
    alt3 = "T" if base2 != "T" else "A"
    haps = {"S0": [list(seq), list(seq)], "S1": [list(seq), list(seq)]}
    haps["S0"][1][800] = alt1
    haps["S1"][1][800] = alt2
    haps["S1"][0][1800] = alt3
    bams = []
    for name, pair in haps.items():
        reads = []
        for i in range(700):
            hap = "".join(pair[i % 2])
            begin = int(rng.integers(0, len(hap) - 100))
            reads.append((begin, "100M", hap[begin:begin + 100],
                          [37] * 100, 60, FLAG_REVERSE if i % 3 == 0 else 0))
        batch = make_read_batch("chr1", reads).sorted_by_begin()
        p = tmp_path / f"{name}.bam"
        with BamWriter(str(p), ["chr1"], [len(seq)], samples=[name]) as w:
            w.write_batch(batch, sample=name)
        build_bai(str(p))
        bams.append(str(p))
    common = ["-R", str(fa), "-I", *bams]
    raw = str(tmp_path / "raw.vcf")
    with pytest.MonkeyPatch.context() as mp:
        for k in PINNED:
            mp.delenv(k, raising=False)
        args = build_parser().parse_args(
            [*common, "-o", raw, "-T", "chr1", "--caller", "population",
             "--disable-call-filtering", "--device", "cpu"])
        assert run.run_calling(args) == 0
    return tmp_path, common, raw


KEYS = ["AF", "AD", "ADP", "DP", "AFB", "SB"]


def test_filter_vcf_matches_inline_csr(two_sample_multiallelic, monkeypatch):
    """The standalone pass keeps the inline pass's records and FILTERs, and
    its support measures, on a multi-sample multi-allelic call set; and
    writes the reference CLI's lines."""
    tmp_path, common, raw = two_sample_multiallelic
    inline = str(tmp_path / "inline.vcf")
    port_main([*common, "-o", inline, "-T", "chr1", "--caller",
               "population", "--annotations", *KEYS], monkeypatch)
    standalone = str(tmp_path / "standalone.vcf")
    port_main([*common, "--filter-vcf", raw, "-o", standalone,
               "--annotations", *KEYS], monkeypatch)
    want = str(tmp_path / "standalone_reference.vcf")
    reference_main([*common, "--filter-vcf", raw, "-o", want,
                    "--annotations", *KEYS])
    assert lines(standalone) == lines(want)
    inline_recs = {(r.pos, tuple(r.alts or ())): r
                   for r in VcfReader(inline).records()}
    stand_recs = {(r.pos, tuple(r.alts or ())): r
                  for r in VcfReader(standalone).records()}
    assert [k for k in inline_recs if len(k[1]) >= 2], \
        "expected a multi-allelic record"
    assert set(stand_recs) == set(inline_recs)
    for key, ri in inline_recs.items():
        rs = stand_recs[key]
        assert rs.filters == ri.filters, (key, rs.filters, ri.filters)
        for k in KEYS:
            vi, vs = ri.info.get(k), rs.info.get(k)
            if vi in (None, ".") or vs in (None, "."):
                continue
            vi, vs = float(vi), float(vs)
            # the same facet semantics; DP may differ by boundary reads
            # between the two fetch paths
            tol = (max(0.05 * max(abs(vi), abs(vs)), 0.02) if k != "DP"
                   else max(0.1 * vi, 3))
            assert abs(vi - vs) <= tol, (key, k, vi, vs)


def test_filter_vcf_per_sample_not_pooled(two_sample_multiallelic,
                                          monkeypatch):
    """The AF of the S1-private het reflects S1's own reads (~0.5), not the
    pooled frequency of both samples (~0.25), as in the reference."""
    tmp_path, common, raw = two_sample_multiallelic
    out = str(tmp_path / "filtered_af.vcf")
    port_main([*common, "--filter-vcf", raw, "-o", out, "--annotations",
               "AF"], monkeypatch)
    want = str(tmp_path / "filtered_af_reference.vcf")
    reference_main([*common, "--filter-vcf", raw, "-o", want,
                    "--annotations", "AF"])
    assert lines(out) == lines(want)
    recs = [r for r in VcfReader(out).records() if r.pos - 1 == 1800]
    assert recs, "S1-private het missing from filter output"
    assert float(recs[0].info["AF"]) > 0.35
