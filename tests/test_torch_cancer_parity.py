"""The port's cancer CLI against the reference's at 50 kb, on the CPU.

simulate_tumour_normal(kb=50, depth=60, seed=7, vaf=0.25) (tumour 60x,
normal 30x, the input of chip_smoke.py's cancer phase cut from 100 kb to
50) goes through the reference package's CLI (JAX on the CPU) and the
port's with --device cpu, --caller cancer --normal-sample NORMAL. Every
record line must be identical, QUAL and PP included: a PP near 130 is 1
minus a posterior mass beyond float64's resolution, so it holds only
because the port's VB evidences equal XLA:CPU's bit for bit (vb_math in
XLA's forms and summation order; PERF.md, Findings).

The two runs took 45 s on an 8-core CPU host with nothing else running,
so this file stands alone and --dist loadfile gives it a worker.
"""

import os
from pathlib import Path

import pytest

from octopus_tpu import cli as ref_cli
from octopus_tpu_torch import cli
from octopus_tpu_torch.utils import synthetic

PINNED = ("OCTOPUS_TPU_HOST_HMM_MAX", "OCTOPUS_TPU_HOST_LATENTS")


def records(path):
    return [line for line in Path(path).read_text().splitlines()
            if not line.startswith("#")]


@pytest.fixture(scope="module")
def vcfs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cancer_parity")
    fa, bam_n, bam_t, germline, somatic, _ = synthetic.simulate_tumour_normal(
        str(d), kb=50, depth=60, seed=7, vaf=0.25)
    argv = ["-R", fa, "-I", bam_n, bam_t, "--caller", "cancer",
            "--normal-sample", "NORMAL"]
    out = {"reference": str(d / "reference.vcf"), "port": str(d / "port.vcf")}
    saved = {k: os.environ.get(k) for k in PINNED}
    try:
        assert ref_cli.main([*argv, "-o", out["reference"]]) == 0
        for k in PINNED:
            os.environ.pop(k, None)
        assert cli.main([*argv, "-o", out["port"], "--device", "cpu"]) == 0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out, germline, somatic


def test_cancer_records_match_the_reference_but_unresolved_pp(vcfs):
    """Every line identical, the PPs beyond float64's resolution too."""
    out, _, somatic = vcfs
    want, got = records(out["reference"]), records(out["port"])
    assert len(got) == len(want) > 0
    assert got == want
    called = [int(line.split("\t")[1]) - 1 for line in got
              if "SOMATIC" in line.split("\t")[7]]
    assert all(any(abs(s - c) <= 5 for c in called) for s in somatic)
