"""octopus_tpu_torch.bench_scaling on the CPU: one and two work-queue
processes of the port's CLI (--device cpu, two threads each) on a
simulated 60 kb diploid give an identical VCF body, and each line has the
keys of the reference repository's bench_scaling.py.
"""

import ast
import os
from pathlib import Path

from octopus_tpu_torch import bench_scaling
from octopus_tpu_torch.bench_e2e import simulate

ROOT = Path(__file__).resolve().parent.parent


def original_keys():
    tree = ast.parse((ROOT / "bench_scaling.py").read_text())
    dump = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "dumps")
    return {k.value for k in dump.args[0].keys}


def test_two_shards_merge_the_single_process_body(tmp_path):
    fa, bam, truth, _ = simulate(str(tmp_path), 60, 30)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("OCTOPUS_TPU_")}
    env["OMP_NUM_THREADS"] = "2"
    rows = list(bench_scaling.scaling(fa, bam, str(tmp_path), 0, 30, [1, 2],
                                      device="cpu", env=env))
    assert [r["workers"] for r in rows] == [1, 2]
    assert all(set(r) == original_keys() for r in rows)
    assert rows[0]["identical_to_single"] is None
    assert rows[1]["identical_to_single"] is True
    assert rows[0]["n_records"] == rows[1]["n_records"] >= len(truth) - 2
    body = bench_scaling.body(str(tmp_path / "out_2.vcf"))
    assert body[0].startswith("#CHROM") and len(body) > len(truth)
