"""The port's CLI with the VB callers against the reference CLI, on the CPU.

Tumour-normal (simulate_tumour_normal, 8 kb at 60x), the same tumour BAM
alone, and the polyclone and cell BAMs of tests/test_e2e_polyclone_cell.py
go through the reference package's CLI (JAX on the CPU) and the port's with
--device cpu; the VCF record lines and the header must be identical (but
the lines carrying a date or a command line). The reference CLI leaves
OCTOPUS_TPU_HOST_HMM_MAX and OCTOPUS_TPU_HOST_LATENTS set after a small run;
both are cleared before every port run.
"""

import filecmp
import os
import subprocess
import sys
from pathlib import Path

import pytest

from octopus_tpu import cli as ref_cli
from octopus_tpu.utils import synthetic as ref_synthetic
from octopus_tpu_torch import cli
from octopus_tpu_torch.core.models import subclone_vb
from octopus_tpu_torch.utils import synthetic

ROOT = Path(__file__).resolve().parent.parent
PINNED = ("OCTOPUS_TPU_HOST_HMM_MAX", "OCTOPUS_TPU_HOST_LATENTS")


def polyclone_sample(tmp):
    """3 haploid clones at 0.5/0.3/0.2 over 12 kb at 100x: 2 trunk and 3
    private SNVs."""
    fa, bam, trunk, private, _ = synthetic.simulate_polyclone(tmp)
    args = ["-T", "chr1", "--caller", "polyclone", "--organism-ploidy", "1",
            "--max-clones", "4"]
    return fa, [bam], args, {"truth": trunk + list(private)}


def cell_sample(tmp):
    """6 cells over 9 kb at 15x: a founder with 2 germline hets and a clone
    (cells 3-5) with one somatic SNV."""
    fa, bams, germ, som, _ = synthetic.simulate_cells(tmp)
    args = ["-T", "chr1", "--caller", "cell", "--max-phylogeny-size", "2"]
    return fa, bams, args, {"truth": germ, "somatic": som}


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    d = tmp_path_factory.mktemp("vb_cli")
    tn = d / "tumour_normal"
    tn.mkdir()
    fa, bam_n, bam_t, germline, somatic, n = synthetic.simulate_tumour_normal(
        str(tn), kb=8, depth=60, seed=7)
    cancer = ["--caller", "cancer"]
    out = {
        "tumour_normal": (fa, [bam_n, bam_t],
                          cancer + ["--normal-sample", "NORMAL"],
                          {"truth": sorted(somatic), "germline": germline}),
        "tumour_only": (fa, [bam_t], cancer, {"truth": sorted(somatic)}),
    }
    for name, make in (("polyclone", polyclone_sample), ("cell", cell_sample)):
        sub = d / name
        sub.mkdir()
        out[name] = make(str(sub))
    return d, out


@pytest.fixture(scope="module")
def reference_vcfs(samples):
    d, cases = samples
    saved = {k: os.environ.get(k) for k in PINNED}
    vcfs = {}
    try:
        for name, (fa, bams, args, _) in cases.items():
            vcfs[name] = str(d / f"reference_{name}.vcf")
            assert ref_cli.main(["-R", fa, "-I", *bams, "-o", vcfs[name],
                                 *args]) == 0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return vcfs


def split_vcf(path):
    lines = Path(path).read_text().splitlines()
    header = [line for line in lines if line.startswith("##")
              and not line.startswith(("##fileDate", "##commandline",
                                       "##source"))]
    return header, [line for line in lines if not line.startswith("##")]


def near(points, targets, tol=5):
    return [t for t in targets if any(abs(t - p) <= tol for p in points)]


@pytest.mark.parametrize("case", ["tumour_normal", "tumour_only",
                                  "polyclone", "cell"])
def test_port_cli_writes_the_reference_records(samples, reference_vcfs,
                                               monkeypatch, case):
    d, cases = samples
    fa, bams, args, truth = cases[case]
    for k in PINNED:
        monkeypatch.delenv(k, raising=False)
    out = str(d / f"port_{case}.vcf")
    subclone_vb.COUNTS.reset()
    assert cli.main(["-R", fa, "-I", *bams, "-o", out, "--device", "cpu",
                     *args]) == 0
    want_header, want = split_vcf(reference_vcfs[case])
    got_header, got = split_vcf(out)
    assert got == want
    assert got_header == want_header
    assert subclone_vb.COUNTS.host > 0 and subclone_vb.COUNTS.device == 0
    records = [line.split("\t") for line in got[1:]]
    called = [int(r[1]) - 1 for r in records]
    somatic = [int(r[1]) - 1 for r in records if "SOMATIC" in r[7]]
    if case == "tumour_normal":
        assert near(somatic, truth["truth"]) == truth["truth"]
        assert near(called, sorted(truth["germline"])) == sorted(
            truth["germline"])
    elif case in ("polyclone", "cell"):
        assert near(called, truth["truth"]) == truth["truth"]
    if case == "cell":
        som = [r for r in records if abs(int(r[1]) - 1 - truth["somatic"]) <= 5
               and "SOMATIC" in r[7]]
        cells = dict(kv.split("=") for kv in som[0][7].split(";") if "=" in kv)
        assert 1 <= int(cells["CELLS"]) <= 5


def test_tumour_normal_simulation_matches_the_reference(tmp_path):
    a, b = tmp_path / "reference", tmp_path / "port"
    a.mkdir()
    b.mkdir()
    want = ref_synthetic.simulate_tumour_normal(str(a), kb=6, depth=40,
                                                seed=3)
    got = synthetic.simulate_tumour_normal(str(b), kb=6, depth=40, seed=3)
    for x, y in zip(want[:3], got[:3]):
        assert filecmp.cmp(x, y, shallow=False), x
    for x, y in zip(want[1:3], got[1:3]):
        assert filecmp.cmp(x + ".bai", y + ".bai", shallow=False)
    assert want[3:] == got[3:]
    assert got[4], "no somatic SNVs"


def test_multi_sample_run_without_a_caller_writes_the_reference_records(
        samples, monkeypatch):
    """Two BAMs and no --caller take the population caller, in the
    reference as in the port."""
    d, cases = samples
    fa, bams, _, _ = cases["tumour_normal"]
    want = str(d / "reference_auto.vcf")
    saved = {k: os.environ.get(k) for k in PINNED}
    try:
        assert ref_cli.main(["-R", fa, "-I", *bams, "-o", want]) == 0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for k in PINNED:
        monkeypatch.delenv(k, raising=False)
    out = str(d / "port_auto.vcf")
    assert cli.main(["-R", fa, "-I", *bams, "-o", out, "--device",
                     "cpu"]) == 0
    assert split_vcf(out) == split_vcf(want)
    records = [line.split("\t") for line in split_vcf(out)[1][1:]]
    assert records and all(len(r) == 11 for r in records)


PROBE = r"""
import sys
from octopus_tpu_torch.cli import main
rc = main(sys.argv[1:])
leaked = sorted(m for m in sys.modules
                if m in ("jax", "jaxlib") or m.startswith(("jax.", "jaxlib."))
                or m == "octopus_tpu" or m.startswith("octopus_tpu."))
print("RC", rc)
print("LEAKED", leaked)
print("VB", "octopus_tpu_torch.core.models.subclone_vb" in sys.modules)
"""


def test_cancer_cli_process_loads_no_jax_and_no_reference_module(samples):
    d, cases = samples
    fa, bams, args, _ = cases["tumour_normal"]
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and k not in PINNED}
    out = str(d / "probe.vcf")
    proc = subprocess.run(
        [sys.executable, "-c", PROBE, "-R", fa, "-I", *bams, "-o", out,
         "--device", "cpu", *args], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "RC 0" in proc.stdout and "LEAKED []" in proc.stdout, proc.stdout
    assert "VB True" in proc.stdout
    assert split_vcf(out)[1][1:]
