"""octopus_tpu_torch.bench_e2e against the reference repository's
bench_e2e.py, on the CPU:

* for two seeds, `simulate` writes the original's FASTA, BAM and BAI byte
  for byte, and the same truth, for 150 bp reads and for the `long` mode's
  5-15 kb reads (err 0.004, base quality 30, error bases 13);
* `phasing_stats` and `qual_calibration` give the original's dicts on the
  same records, each package reading the VCF with its own reader;
* `main` at 20 kb with --device cpu prints one JSON line with the
  original's keys, in a process that loads no JAX module;
* the long-read case: the port's `simulate(kb=20, depth=30)` in the
  `long` mode through both packages' CLIs with `-T chr1 --config
  resources/configs/PacBioCCS.config` at the default host-DP gate gives
  identical record lines.

The reference CLI pins its host paths below 1 Mb by leaving
OCTOPUS_TPU_HOST_HMM_MAX and OCTOPUS_TPU_HOST_LATENTS in the environment;
both are cleared before every port run.
"""

import ast
import filecmp
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from octopus_tpu import cli as ref_cli
from octopus_tpu.io.vcf import VcfReader as RefVcfReader
from octopus_tpu_torch import bench_e2e, cli
from octopus_tpu_torch.io.vcf import VcfReader

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import bench_e2e as ref_bench  # noqa: E402

PINNED = ("OCTOPUS_TPU_HOST_HMM_MAX", "OCTOPUS_TPU_HOST_LATENTS")


@pytest.mark.parametrize("mode", [None, "long"])
@pytest.mark.parametrize("seed", [3, 11])
def test_simulate_writes_the_originals_files(tmp_path, mode, seed):
    kw = bench_e2e.LONG_MODES.get(mode, {})
    a, b = tmp_path / "ref", tmp_path / "port"
    a.mkdir()
    b.mkdir()
    want = ref_bench.simulate(str(a), 20, 30, seed=seed, **kw)
    got = bench_e2e.simulate(str(b), 20, 30, seed=seed, **kw)
    assert got[2] == want[2] and got[3] == want[3] and len(got[2]) >= 10
    for name in ("ref.fa", "s.bam", "s.bam.bai"):
        assert filecmp.cmp(a / name, b / name, shallow=False), name


# two phase sets over simulated truth: a switch between the second and
# third het of the first set, an unphased record, a hom record, a false call
PHASED_VCF = """##fileformat=VCFv4.3
##contig=<ID=chr1,length=20000>
#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS
chr1\t1001\t.\tA\tC\t55.2\tPASS\tPP=40\tGT:PS\t0|1:1001
chr1\t2001\t.\tA\tC\t12.0\tPASS\tPP=7.5\tGT:PS\t1|0:1001
chr1\t3001\t.\tA\tC\t35\tPASS\tPP=35\tGT:PS\t1|0:1001
chr1\t4001\t.\tA\tC\t99\tPASS\tPP=20\tGT:PS\t0|1:1001
chr1\t5001\t.\tA\tC\t150\tPASS\t.\tGT:PS\t1|1:1001
chr1\t7001\t.\tA\tC\t60\tPASS\tPP=60\tGT:PS\t0/1:.
chr1\t9001\t.\tA\tC\t61\tPASS\tPP=61\tGT:PS\t0|1:9001
chr1\t9501\t.\tA\tC\t3\tPASS\tPP=3\tGT:PS\t0|1:9001
chr1\t12001\t.\tA\tC\t44\tPASS\tPP=44\tGT:PS\t1|0:9001
"""
TRUTH = {1000: (("snv", "C"), "het", (0,)), 2000: (("snv", "C"), "het", (1,)),
         3000: (("snv", "C"), "het", (0,)), 4000: (("snv", "C"), "het", (1,)),
         5000: (("snv", "C"), "hom", (0, 1)),
         7000: (("snv", "C"), "het", (1,)),
         9000: (("snv", "C"), "het", (1,)), 12000: (("snv", "C"), "het", (0,))}


def test_phasing_stats_and_qual_calibration_equal_the_originals(tmp_path):
    path = tmp_path / "phased.vcf"
    path.write_text(PHASED_VCF)
    want_records = RefVcfReader(str(path)).records()
    got_records = VcfReader(str(path)).records()
    want = ref_bench.phasing_stats(want_records, TRUTH)
    assert want["phased_pairs"] == 4 and want["switch_errors"] == 1
    assert bench_e2e.phasing_stats(got_records, TRUTH) == want
    for field in (None, "PP"):
        want = ref_bench.qual_calibration(want_records, TRUTH, field=field)
        assert bench_e2e.qual_calibration(got_records, TRUTH,
                                          field=field) == want
        assert sum(b["err"] for b in want.values()) == 1


def original_keys() -> set:
    """The keys of the dict the original's main prints: its literal keys
    and phasing_stats'."""
    tree = ast.parse((ROOT / "bench_e2e.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    dump = next(n for n in ast.walk(main) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "dumps")
    keys = {k.value for k in dump.args[0].keys if k is not None}
    return keys | set(ref_bench.phasing_stats([], {}))


PROBE = r"""
import runpy, sys
sys.argv = ["bench_e2e", *sys.argv[1:]]
try:
    runpy.run_module("octopus_tpu_torch.bench_e2e", run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
leaked = sorted(m for m in sys.modules
                if m in ("jax", "jaxlib") or m.startswith(("jax.", "jaxlib."))
                or m == "octopus_tpu" or m.startswith("octopus_tpu.")
                or m == "bench_e2e")
print("LEAKED", leaked)
"""


def test_main_prints_the_originals_keys_without_jax(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "PYTHONPATH" and k not in PINNED}
    env["TMPDIR"] = str(tmp_path)
    proc = subprocess.run([sys.executable, "-c", PROBE, "20", "30",
                           "--device", "cpu"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "LEAKED []", proc.stdout
    result = json.loads(lines[-2])
    assert set(result) == original_keys()
    assert result["metric"] == "e2e_synthetic_calling" and result["kb"] == 20
    assert result["recall"] >= 0.9 and result["precision"] >= 0.9
    assert not list(tmp_path.iterdir())     # its temporary files are gone


def test_main_refuses_cuda_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_e2e.main(["20", "30"])


def record_lines(path):
    return [line for line in Path(path).read_text().splitlines()
            if not line.startswith("#")]


def test_long_reads_give_the_reference_records(tmp_path, monkeypatch):
    """ROADMAP Queue 3 item 7's long-read case, held in tier-1."""
    fa, bam, truth, _, extra = bench_e2e.simulate_mode(str(tmp_path), 20, 30,
                                                       "long")
    assert extra == ["--config", str(bench_e2e.PACBIO_CONFIG)]
    want, got = str(tmp_path / "ref.vcf"), str(tmp_path / "port.vcf")
    argv = ["-R", fa, "-I", bam, "-T", "chr1", *extra]
    for k in PINNED:
        monkeypatch.delenv(k, raising=False)
    assert ref_cli.main([*argv, "-o", want]) == 0
    for k in PINNED:
        monkeypatch.delenv(k, raising=False)
    assert cli.main([*argv, "-o", got, "--device", "cpu"]) == 0
    lines = record_lines(got)
    assert len(lines) == 14 and len(truth) == 14
    assert lines == record_lines(want)
