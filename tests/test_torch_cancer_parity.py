"""The port's cancer CLI against the reference's at 50 kb, on the CPU.

simulate_tumour_normal(kb=50, depth=60, seed=7, vaf=0.25) (tumour 60x,
normal 30x, the input of chip_smoke.py's cancer phase cut from 100 kb to
50) goes through the reference package's CLI (JAX on the CPU) and the
port's with --device cpu, --caller cancer --normal-sample NORMAL. Every
record line must be identical apart from QUAL and the INFO field PP, and
those must agree within 0.01 wherever the reference's PP is below 120 (on
records without PP, QUAL always). Above ~120 a PP is 1 minus a posterior
mass beyond float64's resolution, so a last-bit difference in one VB
evidence moves it by phreds; the port's VB agrees with XLA:CPU's to float32
rounding, not bit for bit (PERF.md, Findings).

The two runs took 110 s on an 8-core CPU host with nothing else running,
so this file stands alone and --dist loadfile gives it a worker.
"""

import os
from pathlib import Path

import pytest

from octopus_tpu import cli as ref_cli
from octopus_tpu_torch import cli
from octopus_tpu_torch.utils import synthetic

PINNED = ("OCTOPUS_TPU_HOST_HMM_MAX", "OCTOPUS_TPU_HOST_LATENTS")
PP_RESOLVED = 120.0   # phred; above it the PP is not held
TOL = 0.01


def records(path):
    return [line for line in Path(path).read_text().splitlines()
            if not line.startswith("#")]


def split_record(line):
    """(the line without QUAL and PP, QUAL, PP or None)."""
    cols = line.split("\t")
    info, pp = [], None
    for kv in cols[7].split(";"):
        if kv.startswith("PP="):
            pp = float(kv[3:])
        else:
            info.append(kv)
    qual = float(cols[5])
    rest = cols[:5] + cols[6:7] + [";".join(info)] + cols[8:]
    return "\t".join(rest), qual, pp


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
    out, _, somatic = vcfs
    want, got = records(out["reference"]), records(out["port"])
    assert len(got) == len(want) > 0
    for w, g in zip(want, got):
        w_rest, w_qual, w_pp = split_record(w)
        g_rest, g_qual, g_pp = split_record(g)
        assert g_rest == w_rest
        assert (g_pp is None) == (w_pp is None), (w, g)
        if w_pp is None or w_pp < PP_RESOLVED:
            assert abs(g_qual - w_qual) <= TOL + 1e-9, (w, g)
            if w_pp is not None:
                assert abs(g_pp - w_pp) <= TOL + 1e-9, (w, g)
    called = [int(line.split("\t")[1]) - 1 for line in got
              if "SOMATIC" in line.split("\t")[7]]
    assert all(any(abs(s - c) <= 5 for c in called) for s in somatic)
