"""octopus_tpu_torch.bench_e2e_multi against the reference repository's
bench_e2e_multi.py, on the CPU:

* each mode's input (trio, cancer, population, polyclone, cell) at a small
  size writes the original's FASTA, BAMs and BAIs byte for byte for its
  seed (the original's bench function is stopped where it would call the
  CLI);
* the trio mode at 15 kb, 30x, through each package's `_run_cli` (the CLI
  in-process with --threads 4, the port with --device cpu): identical VCF
  record lines and the same accuracy line but for the wall time;
* main prints the original's keys, the compile counts null.
"""

import ast
import filecmp
import json
import os
import sys
from pathlib import Path

import pytest

from octopus_tpu_torch import bench_e2e_multi

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import bench_e2e_multi as ref_multi  # noqa: E402

PINNED = ("OCTOPUS_TPU_HOST_HMM_MAX", "OCTOPUS_TPU_HOST_LATENTS")
# mode -> (the original's bench function, small sizes)
SMALL = {"trio": (ref_multi.bench_trio, dict(kb=12, depth=10)),
         "cancer": (ref_multi.bench_cancer, dict(kb=12, depth=20)),
         "population": (ref_multi.bench_population, dict(kb=12, depth=10)),
         "polyclone": (ref_multi.bench_polyclone, dict(kb=8, depth=20)),
         "cell": (ref_multi.bench_cell, dict(kb=8, depth=6))}


class _Stop(Exception):
    pass


def original_cli_inputs(monkeypatch, fn, **sizes):
    """(fasta, BAMs, output VCF) the original's bench function hands its
    CLI, which is not run."""
    got = {}

    def stop(fa, bams, out, extra, timeout=3600):
        got.update(fa=fa, bams=bams, out=out)
        raise _Stop

    monkeypatch.setattr(ref_multi, "_run_cli", stop)
    with pytest.raises(_Stop):
        fn(**sizes)
    return got["fa"], got["bams"], got["out"]


def same(a, b):
    return filecmp.cmp(a, b, shallow=False)


@pytest.mark.parametrize("mode", sorted(SMALL))
def test_inputs_are_the_originals_files(monkeypatch, tmp_path, mode):
    fn, sizes = SMALL[mode]
    fa, bams, _ = original_cli_inputs(monkeypatch, fn, **sizes)
    got_fa, got_bams, truth = bench_e2e_multi.MODES[mode][0](str(tmp_path),
                                                             **sizes)
    assert truth
    assert same(fa, got_fa)
    assert [os.path.basename(b) for b in bams] == [
        os.path.basename(b) for b in got_bams]
    for a, b in zip(bams, got_bams):
        assert same(a, b) and same(a + ".bai", b + ".bai")


def record_lines(path):
    return [line for line in Path(path).read_text().splitlines()
            if not line.startswith("#")]


def test_trio_gives_the_reference_records(monkeypatch, tmp_path):
    real = ref_multi._run_cli
    seen = {}

    def keep(fa, bams, out, extra, timeout=3600):
        seen["out"] = out
        return real(fa, bams, out, extra)

    for k in PINNED:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(ref_multi, "_run_cli", keep)
    want = ref_multi.bench_trio(kb=15, depth=30)
    for k in PINNED:
        monkeypatch.delenv(k, raising=False)
    got = bench_e2e_multi.bench("trio", str(tmp_path), "cpu", kb=15, depth=30)
    assert record_lines(tmp_path / "trio.vcf") == record_lines(seen["out"])
    assert want.pop("wall_s") >= 0 and got.pop("wall_s") >= 0
    assert all(got.pop(k) is None
               for k in ("n_compiles", "compile_s", "warm_compiles"))
    assert got == want
    assert got["n_denovo"] >= 5 and got["caller_denovo_recall"] > 0


def original_keys(fn_name):
    tree = ast.parse((ROOT / "bench_e2e_multi.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return)][-1]
    return {k.value for k in ret.value.keys}


def test_main_prints_the_originals_keys(monkeypatch, capsys):
    """The polyclone and cell modes' lines, their runs replaced by the
    scoring of an empty VCF."""
    def fake_cli(fa, bams, out, extra, device="cuda"):
        Path(out).write_text("##fileformat=VCFv4.3\n#CHROM\tPOS\tID\tREF\t"
                             "ALT\tQUAL\tFILTER\tINFO\n")

    monkeypatch.setattr(bench_e2e_multi, "_run_cli", fake_cli)
    counts = {"n_compiles", "compile_s", "warm_compiles"}
    for mode in ("polyclone", "cell"):
        sizes = SMALL[mode][1]
        monkeypatch.setattr(bench_e2e_multi, "mode_sizes",
                            lambda m, kb, depth, s=sizes: s)
        assert bench_e2e_multi.main([mode, "--device", "cpu"]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert set(line) == original_keys(f"bench_{mode}") | counts
        assert all(line[k] is None for k in counts)
