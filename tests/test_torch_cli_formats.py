"""The port's CLI on the output formats, ploidies and flags the reference's
tests/test_cli_formats.py and test_cli_e2e.py exercise, held line for line
against the reference CLI.

One simulated 10 kb diploid at 30x (seed 9) goes through the reference
package's CLI (JAX on the CPU) and through the port's with --device cpu for
each case: BCF output (byte-identical), a tabix-indexed .vcf.gz, --refcall
in both forms, ploidy 4 and 1, a -T sub-region, --fast, and the flags of
test_new_flag_surface. The reference CLI pins its host paths below 1 Mb by
writing OCTOPUS_TPU_HOST_HMM_MAX and OCTOPUS_TPU_HOST_LATENTS into the
environment; both are restored after it and cleared before the port runs.
"""

import gzip
import os
from pathlib import Path

import pytest

from octopus_tpu import cli as ref_cli
from octopus_tpu_torch import cli
from octopus_tpu_torch.utils.synthetic import simulate_diploid

PINNED = ("OCTOPUS_TPU_HOST_HMM_MAX", "OCTOPUS_TPU_HOST_LATENTS")
FLAG_SURFACE = ["-K", "chr1:900-1100", "--sites-only",
                "--annotations", "AF", "SB",
                "--contig-output-order", "LEXICOGRAPHICAL_ASCENDING",
                "--mask-low-quality-tails", "5", "--min-read-length", "30"]
# case -> (output file name, arguments after -R/-I/-o; -T chr1 unless given)
CASES = {
    "bcf": ("calls.bcf", []),
    "vcf_gz": ("calls.vcf.gz", []),
    "refcall": ("calls.vcf", ["--refcall"]),
    "refcall_positional": ("calls.vcf", ["--refcall", "POSITIONAL"]),
    "ploidy_4": ("calls.vcf", ["--organism-ploidy", "4"]),
    "ploidy_1": ("calls.vcf", ["--organism-ploidy", "1"]),
    "sub_region": ("calls.vcf", ["-T", "chr1:2001-7000"]),
    "fast": ("calls.vcf", ["--fast"]),
    "flag_surface": ("calls.vcf", FLAG_SURFACE),
}


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_formats")
    fa, bam, truth, n = simulate_diploid(str(d), kb=10, depth=30, seed=9)
    return d, fa, bam


def run_reference(argv):
    saved = {k: os.environ.get(k) for k in PINNED}
    try:
        assert ref_cli.main(argv) == 0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def text_of(path: Path) -> list[str]:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        return f.read().splitlines()


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_cli_formats_write_the_reference_records(sample, monkeypatch,
                                                      tmp_path, case):
    d, fa, bam = sample
    name, extra = CASES[case]
    region = [] if "-T" in extra else ["-T", "chr1"]
    outs = {}
    for who in ("reference", "port"):
        out = tmp_path / who / name
        out.parent.mkdir()
        argv = ["-R", fa, "-I", bam, "-o", str(out), *region, *extra]
        if who == "reference":
            run_reference(argv)
        else:
            for k in PINNED:
                monkeypatch.delenv(k, raising=False)
            assert cli.main(argv + ["--device", "cpu"]) == 0
        outs[who] = out
    if case == "bcf":
        assert outs["port"].read_bytes() == outs["reference"].read_bytes()
        assert outs["port"].read_bytes()[:2] == b"\x1f\x8b"   # BGZF
        return
    if case == "vcf_gz":
        assert all(Path(f"{p}.tbi").exists() for p in outs.values())
    want, got = text_of(outs["reference"]), text_of(outs["port"])
    records = [line.split("\t") for line in got if not line.startswith("#")]
    assert records, "no records"
    assert got == want
    if case == "ploidy_4":
        assert all(len(r[9].split(":")[0].replace("/", "|").split("|")) == 4
                   for r in records)
    if case == "flag_surface":
        # sites only, AF on every record
        assert all(len(r) == 8 and "AF=" in r[7] for r in records)
        assert any("SB=" in r[7] for r in records)
