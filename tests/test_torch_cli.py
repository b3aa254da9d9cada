"""The port's CLI end to end: BAM in, read pipe, inline threshold CSR, VCF out.

A simulated 5 kb diploid at 30x goes through the reference package's CLI
(JAX on the CPU) and through the port's with --device cpu: the VCF record
lines must be identical, and the headers too except lines carrying a date
or a command line. The reference CLI pins its host paths below 1 Mb by
writing OCTOPUS_TPU_HOST_HMM_MAX and OCTOPUS_TPU_HOST_LATENTS into the
environment and leaving them there; the port reads the first, so both are
cleared before every port run. The reference's records are made under
octopus's rule for tied reads (`reference_tie_rule`), which the port
follows and the JAX package does not.
"""

import filecmp
import os
import subprocess
import sys
from pathlib import Path

import pytest

import reference_tie_rule as tie_rule
from octopus_tpu import cli as ref_cli
from octopus_tpu_torch import cli, run
from octopus_tpu_torch.core.likelihood import likelihood_array as la
from octopus_tpu_torch.utils.synthetic import simulate_diploid

ROOT = Path(__file__).resolve().parent.parent
PINNED = ("OCTOPUS_TPU_HOST_HMM_MAX", "OCTOPUS_TPU_HOST_LATENTS")


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    fa, bam, truth, n = simulate_diploid(str(d), kb=5, depth=30, seed=5,
                                         spacing=(150, 450))
    return d, fa, bam, truth


@pytest.fixture(scope="module")
def reference_vcf(sample):
    d, fa, bam, _ = sample
    out = str(d / "reference.vcf")
    saved = {k: os.environ.get(k) for k in PINNED}
    try:
        with tie_rule.applied():
            assert ref_cli.main(["-R", fa, "-I", bam, "-o", out]) == 0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


def split_vcf(path):
    lines = Path(path).read_text().splitlines()
    header = [line for line in lines if line.startswith("##")
              and not line.startswith(("##fileDate", "##commandline",
                                       "##source"))]
    return header, [line for line in lines if not line.startswith("##")]


def run_port(sample, monkeypatch, name, *extra, env=None):
    """The port CLI on the CPU with the pinned variables cleared and `env`
    set; returns the output path."""
    d, fa, bam, _ = sample
    for k in PINNED:
        monkeypatch.delenv(k, raising=False)
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    out = str(d / name)
    la.ROUTING.reset()
    assert cli.main(["-R", fa, "-I", bam, "-o", out, "--device", "cpu",
                     *extra]) == 0
    return out


ROUTINGS = {
    "default": {},
    "lanes_all_scorer": {"OCTOPUS_TPU_UNROLLED_HMM": "1",
                         "OCTOPUS_TPU_HOST_HMM_MAX": "0"},
}


@pytest.mark.parametrize("routing", sorted(ROUTINGS))
def test_port_cli_writes_the_reference_records(sample, reference_vcf,
                                               monkeypatch, routing):
    out = run_port(sample, monkeypatch, f"port_{routing}.vcf",
                   env=ROUTINGS[routing])
    want_header, want = split_vcf(reference_vcf)
    got_header, got = split_vcf(out)
    assert got == want
    assert got_header == want_header
    records = [line.split("\t") for line in got[1:]]
    assert len(records) >= len(sample[3]) - 1
    assert any(r[6] == "PASS" for r in records)
    if routing == "lanes_all_scorer":
        assert set(la.ROUTING.job_sets) == {
            ("populate", "pairhmm_lanes_plain"),
            ("assignment", "pairhmm_lanes_plain")}


def test_port_cli_writes_a_tabix_indexed_vcf_gz(sample, reference_vcf,
                                                monkeypatch):
    import gzip
    out = run_port(sample, monkeypatch, "calls.vcf.gz")
    assert os.path.exists(out + ".tbi")
    got = [line for line in gzip.open(out, "rt").read().splitlines()
           if not line.startswith("##")]
    assert got == split_vcf(reference_vcf)[1]


PROBE = r"""
import sys
from octopus_tpu_torch.cli import main
rc = main(sys.argv[1:])
leaked = sorted(m for m in sys.modules
                if m in ("jax", "jaxlib") or m.startswith(("jax.", "jaxlib."))
                or m == "octopus_tpu" or m.startswith("octopus_tpu."))
print("RC", rc)
print("LEAKED", leaked)
"""


def test_port_cli_process_loads_no_jax_and_no_reference_module(sample):
    d, fa, bam, _ = sample
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and k not in PINNED}
    out = str(d / "probe.vcf")
    proc = subprocess.run(
        [sys.executable, "-c", PROBE, "-R", fa, "-I", bam, "-o", out,
         "--device", "cpu"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "RC 0" in proc.stdout and "LEAKED []" in proc.stdout, proc.stdout
    assert split_vcf(out)[1][1:]


FOREST = str(ROOT / "resources" / "forests" / "germline.npz")
# the flags the port once refused as not ported; {calls} is the reference
# CLI's VCF, {who} the package that runs
UNPORTED = {
    "bamout": ["--bamout", "{who}_evidence.bam"],
    "filter_vcf": ["--filter-vcf", "{calls}"],
    "forest_model": ["--forest-model", FOREST],
    "filter_vcf_threads": ["--filter-vcf", "{calls}", "--threads", "4"],
    "training_csr": ["--disable-call-filtering", "--annotations", "AD"],
}


def run_reference(sample, name, *extra):
    """The reference CLI with the variables it pins restored afterwards;
    returns the output path."""
    d, fa, bam, _ = sample
    out = str(d / name)
    saved = {k: os.environ.get(k) for k in PINNED}
    try:
        with tie_rule.applied():
            assert ref_cli.main(["-R", fa, "-I", bam, "-o", out, *extra]) == 0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out


@pytest.mark.parametrize("flag", sorted(UNPORTED))
def test_unported_flag_raises_user_error(sample, reference_vcf, flag,
                                         monkeypatch):
    """The flags the port once refused (exit 2, "not ported") now run: exit
    0 and the reference CLI's output on the same input, the evidence BAM
    byte for byte."""
    d = sample[0]

    def argv(who):
        return [a.format(who=str(d / f"{flag}_{who}"), calls=reference_vcf)
                for a in UNPORTED[flag]]

    want = run_reference(sample, f"{flag}_reference.vcf", *argv("reference"))
    got = run_port(sample, monkeypatch, f"{flag}_port.vcf", *argv("port"))
    assert split_vcf(got) == split_vcf(want)
    assert len(split_vcf(got)[1]) > 3
    if flag == "bamout":
        for ext in ("", ".bai"):
            assert filecmp.cmp(str(d / f"{flag}_port_evidence.bam") + ext,
                               str(d / f"{flag}_reference_evidence.bam") + ext,
                               shallow=False)


def test_trio_caller_on_one_sample_raises_user_error(sample, capsys):
    d, fa, bam, _ = sample
    out = str(d / "trio_one_sample.vcf")
    rc = cli.main(["-R", fa, "-I", bam, "-o", out, "--device", "cpu",
                   "--caller", "trio"])
    assert rc == 2
    assert "needs exactly 3 samples" in " ".join(
        capsys.readouterr().err.split())
    assert not os.path.exists(out)


def test_population_caller_on_one_sample_writes_the_reference_records(
        sample, monkeypatch):
    """One sample takes the individual caller under --caller population, in
    the reference as in the port."""
    d, fa, bam, _ = sample
    want = str(d / "reference_population.vcf")
    saved = {k: os.environ.get(k) for k in PINNED}
    try:
        with tie_rule.applied():
            assert ref_cli.main(["-R", fa, "-I", bam, "-o", want,
                                 "--caller", "population"]) == 0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    out = run_port(sample, monkeypatch, "port_population.vcf",
                   "--caller", "population")
    assert split_vcf(out) == split_vcf(want)
    assert len(split_vcf(out)[1]) > 2


def test_cram_input_raises_user_error(sample, capsys):
    """CRAM input is ported (tests/test_torch_cram.py calls a CRAM): a
    missing .cram is the user error, as in the reference CLI, and a
    truncated one fails the run with the reference CLI's exit code."""
    d, fa, _, _ = sample
    missing = str(d / "missing.cram")
    rc = cli.main(["-R", fa, "-I", missing, "-o", str(d / "c.vcf"),
                   "--device", "cpu"])
    err = " ".join(capsys.readouterr().err.split())
    assert rc == 2 and "user error" in err and missing in err
    cram = d / "reads.cram"
    cram.write_bytes(b"CRAM")
    argv = ["-R", fa, "-I", str(cram), "-o", str(d / "c.vcf")]
    want = ref_cli.main(argv)
    assert cli.main([*argv, "--device", "cpu"]) == want != 0
    assert not os.path.exists(d / "c.vcf")


def test_thread_pool_writes_the_serial_records(sample, monkeypatch):
    regions = ["-T", "chr1:0-2500", "chr1:2500-5000"]
    serial = run_port(sample, monkeypatch, "serial.vcf", *regions)
    threads = run_port(sample, monkeypatch, "threads.vcf", *regions,
                       "--threads", "2", "--thread-workers")
    assert split_vcf(threads)[1] == split_vcf(serial)[1]
    assert len(split_vcf(serial)[1]) > 3


@pytest.mark.parametrize("path", ["grouped", "lazy"])
def test_scorer_error_in_read_assignment_fails_the_run(sample, monkeypatch,
                                                       capsys, path):
    """A scorer that raises inside read assignment (the grouped
    precompute, or the facets' lazy per-block path when there is no
    precompute) ends the run with an error and writes no records."""
    real = la.HaplotypeLikelihoodArray._device_scores

    def scorer(self, *args, **kwargs):
        if self.source == "assignment":
            raise RuntimeError("CUDA error: an illegal memory access")
        return real(self, *args, **kwargs)

    monkeypatch.setattr(la.HaplotypeLikelihoodArray, "_device_scores", scorer)
    monkeypatch.setenv("OCTOPUS_TPU_HOST_HMM_MAX", "0")
    if path == "lazy":
        monkeypatch.setattr(run, "_precompute_read_assignments",
                            lambda bundles, scoring=None: None)
    d, fa, bam, _ = sample
    out = str(d / f"failed_{path}.vcf")
    rc = cli.main(["-R", fa, "-I", bam, "-o", out, "--device", "cpu"])
    assert rc != 0
    assert "illegal memory access" in " ".join(capsys.readouterr().err.split())
    assert not os.path.exists(out)
