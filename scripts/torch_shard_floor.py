#!/usr/bin/env python3
"""Where sharding over the local cards pays: the pair-HMM batch and the
genotype reduction, sharded over 1..n cards against one card, and the CLI
with sharding forced on against sharding off.

    python3 scripts/torch_shard_floor.py [--kb 100] [--reps 7] [--out FILE]

Needs a CUDA card. k runs from 2 to the card count, or to 4 on a host with
fewer cards, where the k shards share card 0 (the host's serial copies,
launches and gathers, without the cards' overlap; "cards" in each line
says which). Three measurements, each printed as one JSON line (and
appended to --out):

1. pairhmm: for each batch B (chip_smoke.py's random_batch, R 150, band
   8), host-clock milliseconds of one product call from host arrays to
   scores on the host: pairhmm_scores on card 0 with sharding off, and
   pairhmm_batch._pairhmm_scores_sharded over k cards for every k that
   divides B; median of --reps calls, the k taken in turns. Scores
   must be bit-equal to the one-card call.
2. genotype: the same for a genotype reduction of (H haplotypes, R reads,
   ploidy 2): the one-card float32 reduction against
   genotype_likelihoods._genotype_lls_sharded over k cards, with the
   largest absolute difference from one card.
3. cli: a simulated diploid (--kb at 30x, 150 bp reads, seed 2024,
   chip_smoke.py's cli input) through octopus_tpu_torch.cli.main on the
   card, host-DP gate 0 (every job set on the card), with
   OCTOPUS_TPU_NO_SHARD=1 ("off"), with the committed floors
   ("product") and with both floors at 0 so that every job set and
   reduction shards ("forced"), in turns (off, forced, product, product,
   forced, off); walls, #1 launches, card reductions and how many record
   lines differ from "off".

Each line carries the card's name and power limit and the card count.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

BATCHES = (8, 64, 512, 1232, 4096, 16384, 65536, 262144)
REDUCTIONS = ((16, 64), (64, 319), (128, 319), (128, 1232), (256, 4096))
SEED = 2024


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def emit(obj, out):
    line = json.dumps(obj)
    print(line, flush=True)
    if out:
        with open(out, "a") as fh:
            fh.write(line + "\n")


def timed_turns(fns: dict, reps: int):
    """{label: (median ms, last result)} over `reps` rounds, every label
    once a round in turn, after one untimed warm-up round."""
    import torch
    times = {k: [] for k in fns}
    last = {}
    for r in range(reps + 1):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last[k] = fn()
            ms = (time.perf_counter() - t0) * 1e3
            if r:
                times[k].append(ms)
    return {k: (statistics.median(v), last[k]) for k, v in times.items()}


def shard_counts() -> list[int]:
    import torch
    return list(range(2, max(torch.cuda.device_count(), 4) + 1))


def mesh(k: int):
    """k distinct cards where the host has them, else card 0 k times."""
    import torch
    from octopus_tpu_torch.parallel import make_mesh
    if k <= torch.cuda.device_count():
        return make_mesh(k)
    return [torch.device("cuda", 0)] * k


def pairhmm_sweep(reps: int, base: dict, out) -> None:
    import numpy as np
    import torch
    from chip_smoke import random_batch
    from octopus_tpu_torch.core.likelihood import pairhmm_batch as pb
    rng = np.random.default_rng(SEED)
    for B in BATCHES:
        args = [np.ascontiguousarray(a, np.int32)
                for a in random_batch(rng, B, 150, 8)]
        fns = {1: lambda: pb.pairhmm_scores(*args, pad=8, device="cuda:0")}
        for k in shard_counts():
            if B % k == 0:
                fns[k] = (lambda devs=mesh(k):
                          pb._pairhmm_scores_sharded(
                              devs, *args, pad=8,
                              nuc_prior=pb.DEFAULT_NUC_PRIOR))
        os.environ["OCTOPUS_TPU_NO_SHARD"] = "1"
        try:
            res = timed_turns(fns, reps)
        finally:
            os.environ.pop("OCTOPUS_TPU_NO_SHARD")
        one = res[1][1].cpu()
        emit({**base, "phase": "pairhmm", "B": B,
              "ms_by_cards": {k: ms for k, (ms, _) in res.items()},
              "bit_equal": all(torch.equal(r.cpu(), one)
                               for _, r in res.values())}, out)


def genotype_sweep(reps: int, base: dict, out) -> None:
    import numpy as np
    import torch
    from octopus_tpu_torch.core.models import genotype_likelihoods as gl
    rng = np.random.default_rng(SEED)
    for H, R in REDUCTIONS:
        lnL = -rng.exponential(3.0, (H, R))
        gts = np.array([(i, j) for i in range(H) for j in range(i, H)])
        counts = gl.genotype_counts_matrix(gts, H)

        def one():
            return gl.genotype_log_likelihoods_torch(
                torch.as_tensor(lnL, dtype=torch.float32, device="cuda:0"),
                torch.as_tensor(counts, dtype=torch.float32,
                                device="cuda:0"), 2).cpu()
        fns = {1: one}
        for k in shard_counts():
            fns[k] = (lambda devs=mesh(k):
                      gl._genotype_lls_sharded(devs, lnL, counts, 2))
        res = timed_turns(fns, reps)
        ref = res[1][1]
        emit({**base, "phase": "genotype", "H": H, "R": R, "G": len(gts),
              "elements": len(gts) * 2 * R,
              "ms_by_cards": {k: ms for k, (ms, _) in res.items()},
              "max_abs_diff_by_cards": {
                  k: float((r - ref).abs().max()) for k, (_, r) in res.items()}},
             out)


def cli_runs(kb: int, base: dict, out) -> None:
    from octopus_tpu_torch import cli
    from octopus_tpu_torch.core.likelihood import pairhmm_batch as pb
    from octopus_tpu_torch.core.models import genotype_likelihoods as gl
    from octopus_tpu_torch.utils.synthetic import simulate_diploid
    floors = (pb.SHARD_MIN_PAIRS, gl.SHARD_MIN_ELEMENTS)
    tmp = tempfile.mkdtemp(prefix="shard_floor_")
    try:
        fa, bam, _, _ = simulate_diploid(tmp, kb=kb, depth=30, read_len=150,
                                         seed=SEED)
        lines = {}
        walls = {}
        launches = {}
        reductions = {}
        os.environ["OCTOPUS_TPU_HOST_HMM_MAX"] = "0"
        for i, label in enumerate(("off", "forced", "product", "product",
                                   "forced", "off")):
            if label == "off":
                os.environ["OCTOPUS_TPU_NO_SHARD"] = "1"
            pb.SHARD_MIN_PAIRS, gl.SHARD_MIN_ELEMENTS = (
                (0, 0) if label == "forced" else floors)
            vcf = os.path.join(tmp, f"{label}{i}.vcf")
            pb.COUNTS.reset()
            gl.COUNTS.device = 0
            t0 = time.perf_counter()
            try:
                rc = cli.main(["-R", fa, "-I", bam, "-o", vcf,
                               "--device", "cuda"])
            finally:
                os.environ.pop("OCTOPUS_TPU_NO_SHARD", None)
                pb.SHARD_MIN_PAIRS, gl.SHARD_MIN_ELEMENTS = floors
            walls.setdefault(label, []).append(time.perf_counter() - t0)
            launches.setdefault(label, []).append(pb.COUNTS.launches)
            reductions.setdefault(label, []).append(gl.COUNTS.device)
            if rc:
                raise RuntimeError(f"cli {label}: exit {rc}")
            with open(vcf) as fh:
                lines[label] = [x for x in fh if not x.startswith("#")]
        differ = {k: sum(a != b for a, b in zip(v, lines["off"]))
                  + abs(len(v) - len(lines["off"])) for k, v in lines.items()}
        emit({**base, "phase": "cli", "kb": kb, "wall_s": walls,
              "pairhmm_launches": launches, "card_reductions": reductions,
              "records": len(lines["off"]),
              "lines_differ_from_off": differ,
              "floors": {"SHARD_MIN_PAIRS": floors[0],
                         "SHARD_MIN_ELEMENTS": floors[1]}}, out)
    finally:
        os.environ.pop("OCTOPUS_TPU_HOST_HMM_MAX", None)
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kb", type=int, default=100)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_shard_floor: needs CUDA", file=sys.stderr)
        return 2
    base = {"card": card_line(), "cards": torch.cuda.device_count(),
            "cpu_count": os.cpu_count()}
    pairhmm_sweep(a.reps, base, a.out)
    genotype_sweep(a.reps, base, a.out)
    cli_runs(a.kb, base, a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
