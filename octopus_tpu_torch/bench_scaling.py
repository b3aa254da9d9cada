"""Multi-worker scaling benchmark (--work-queue over one shared directory).

Simulates an N-Mb diploid sample once, then runs the SAME calling job as
1, 2, and 4 parallel OS processes of the port's CLI sharing the work queue
(`--work-queue --num-shards K --shard-index i`, the multi-host execution
model; octopus.cpp:1226-1342 is the reference's in-process analogue).
Reports wall per configuration, scaling efficiency, and whether the merged
VCF is identical to the single-process run.

    python -m octopus_tpu_torch.bench_scaling [mb=10] [depth=30]
                                              [workers="1,2,4"]
                                              [--device cuda|cpu]

Prints one JSON line per configuration, with the keys of the reference
package's bench_scaling.py. On one card every process opens its own CUDA
context on it. --device defaults to cuda and raises without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run_shards(fa, bam, out, n_shards, env, device="cuda"):
    procs = []
    for i in range(n_shards):
        args = [sys.executable, "-m", "octopus_tpu_torch.cli",
                "-R", fa, "-I", bam, "-o", out, "-T", "chr1",
                "--device", device,
                "--work-queue", "--num-shards", str(n_shards),
                "--shard-index", str(i)]
        procs.append(subprocess.Popen(
            args, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            env=env))
    rcs = [p.wait() for p in procs]
    if any(rcs):
        raise RuntimeError(f"work-queue processes exited with {rcs}")
    if not os.path.exists(out):
        raise RuntimeError("the merge did not produce the output VCF")


def body(path):
    with open(path) as fh:
        return [line for line in fh.read().splitlines()
                if not line.startswith("##")]


def scaling(fa, bam, tmp, mb, depth, workers, device="cuda", env=None):
    """Yields one JSON line's dict per worker count: the same call as k
    work-queue processes, walls against the first count's."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    baseline_wall = None
    single_body = None
    for k in workers:
        out = os.path.join(tmp, f"out_{k}.vcf")
        t0 = time.time()
        run_shards(fa, bam, out, k, env, device)
        wall = time.time() - t0
        b = body(out)
        identical = None
        if single_body is None:
            single_body = b
            baseline_wall = wall
        else:
            identical = b == single_body
        n_records = sum(1 for line in b if not line.startswith("#"))
        yield {
            "metric": "e2e_scaling", "mb": mb, "depth": depth,
            "workers": k, "wall_s": round(wall, 1),
            "kb_per_s": round(mb * 1000 / wall, 1),
            "speedup": round(baseline_wall / wall, 2),
            "efficiency": round(baseline_wall / wall / k, 2),
            "n_records": n_records,
            "identical_to_single": identical,
        }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mb", nargs="?", type=int, default=10)
    p.add_argument("depth", nargs="?", type=int, default=30)
    p.add_argument("workers", nargs="?", default="1,2,4")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    from .device import resolve_device
    resolve_device(args.device)
    from .bench_e2e import simulate
    workers = [int(x) for x in args.workers.split(",")]
    tmp = tempfile.mkdtemp(prefix="bench_scaling_")
    try:
        fa, bam, _, _ = simulate(tmp, args.mb * 1000, args.depth)
        for row in scaling(fa, bam, tmp, args.mb, args.depth, workers,
                           args.device):
            print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
