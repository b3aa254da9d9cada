#!/usr/bin/env python3
"""Where the port's process pool pays: its start-up, and serial against
pool walls as the input grows, on the card's host.

    python3 scripts/torch_pool_scaling.py [--kb 300 1000 2000] [--workers W]
                                          [--device cuda] [--out FILE]

Three measurements, each printed as one JSON line (and appended to --out):

1. import: seconds to import octopus_tpu_torch.run in one fresh interpreter,
   and in W fresh interpreters started together (what each pool worker
   pays before it can take a window);
2. start-up: seconds from creating the CLI's own process pool (spawn, the
   product's worker initialiser on a parsed command line, W workers) until
   each of W tasks that sleep 0.5 s has returned, less the 0.5 s;
3. walls: for each --kb, a simulated diploid at 30x (150 bp reads, seed
   2024, chip_smoke.py's cli input) through octopus_tpu_torch.cli.main
   serially and with --threads W, in turns (serial, pool, pool, serial),
   default gates; the records of every run must be identical.

W defaults to min(8, os.cpu_count()). The device defaults to cuda (needs a
card); --device cpu runs the same on the CPU.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

IMPORT = "import octopus_tpu_torch.run"


def emit(obj, out):
    line = json.dumps(obj)
    print(line, flush=True)
    if out:
        with open(out, "a") as fh:
            fh.write(line + "\n")


def import_seconds(n: int) -> list[float]:
    """Wall seconds of n interpreters started together, each importing the
    CLI's run module."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", IMPORT], cwd=ROOT,
                              env=env) for _ in range(n)]
    ends = []
    for p in procs:
        p.wait(timeout=600)
        ends.append(time.perf_counter() - t0)
        if p.returncode:
            raise RuntimeError(f"import failed: {p.returncode}")
    return ends


def pool_start_up(argv: list[str], workers: int) -> list[float]:
    """Seconds until each of `workers` pool workers, started as the CLI
    starts them, has returned one task of 0.5 s (less the 0.5 s)."""
    import multiprocessing as mp
    from octopus_tpu_torch import run
    from octopus_tpu_torch.config.options import build_parser
    args = build_parser().parse_args(argv)
    env = {"CUDA_VISIBLE_DEVICES": "", "OCTOPUS_TPU_HOST_HMM_MAX": "1000000000"}
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        t0 = time.perf_counter()
        with cf.ProcessPoolExecutor(
                max_workers=workers, mp_context=mp.get_context("spawn"),
                initializer=run._process_worker_init,
                initargs=(dict(vars(args), device="cpu", defer_heavy=8),
                          env)) as ex:
            futs = [ex.submit(time.sleep, 0.5) for _ in range(workers)]
            ends = []
            for f in cf.as_completed(futs):
                f.result()
                ends.append(time.perf_counter() - t0 - 0.5)
    finally:
        if saved is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved
    return ends


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kb", type=int, nargs="+", default=[300, 1000, 2000])
    ap.add_argument("--workers", type=int,
                    default=min(8, os.cpu_count() or 1))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    import torch
    from octopus_tpu_torch import cli, run
    from octopus_tpu_torch.utils.synthetic import simulate_diploid
    if a.device == "cuda":
        torch.cuda.init()
    W = a.workers
    emit({"phase": "import", "cpu_count": os.cpu_count(), "workers": W,
          "one_s": import_seconds(1)[0], "together_s": import_seconds(W)},
         a.out)
    tmp = tempfile.mkdtemp(prefix="pool_scaling_")
    try:
        for kb in a.kb:
            t0 = time.perf_counter()
            d = os.path.join(tmp, str(kb))
            os.makedirs(d)
            fa, bam, truth, n = simulate_diploid(
                d, kb=kb, depth=30, read_len=150, seed=2024,
                spacing=(600, 1800), err=0.001)
            simulate_s = time.perf_counter() - t0
            base = ["-R", fa, "-I", bam, "--device", a.device]
            if kb == a.kb[0]:
                emit({"phase": "start_up", "workers": W,
                      "ready_s": pool_start_up(base, W)}, a.out)
            walls, records, pool = {"serial": [], "pool": []}, set(), []
            for label in ("serial", "pool", "pool", "serial"):
                out = os.path.join(d, f"{label}.vcf")
                extra = ["--threads", str(W)] if label == "pool" else []
                run.POOL.reset()
                if a.device == "cuda":
                    torch.cuda.synchronize()
                t = time.perf_counter()
                if cli.main([*base, "-o", out, *extra]) != 0:
                    raise RuntimeError(f"{kb} kb {label}: the CLI failed")
                if a.device == "cuda":
                    torch.cuda.synchronize()
                walls[label].append(time.perf_counter() - t)
                if label == "pool":
                    if run.POOL.fallbacks:
                        raise RuntimeError(f"{kb} kb: the pool fell back")
                    pool.append({"worker_windows": run.POOL.worker_windows,
                                 "deferred_windows": run.POOL.deferred_windows})
                with open(out) as fh:
                    records.add(tuple(l for l in fh if not l.startswith("#")))
            if len(records) != 1:
                raise RuntimeError(f"{kb} kb: serial and pool records differ")
            emit({"phase": "walls", "kb": kb, "workers": W,
                  "simulate_s": simulate_s, "records": len(next(iter(records))),
                  "wall_s": walls, "pool": pool}, a.out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
