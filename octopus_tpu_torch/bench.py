"""Driver benchmark: batched pair-HMM throughput on one NVIDIA card.

    python -m octopus_tpu_torch.bench [--device cuda|cpu]
                                      [--batches 16384,65536] [--reps 5]

Prints ONE JSON line, with the keys of the reference package's bench.py:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": ...}

value: pair-HMM throughput (read x haplotype pairs scored per second) for
Illumina-shaped work (R=150, band 8) on the production kernel, #1
(csrc/pairhmm.cu; OCTOPUS_TPU_UNROLLED_HMM=1 selects #3,
csrc/pairhmm_lanes.cu, as the reference's dispatcher does), at the largest
of --batches, by the marginal-batch method: a queue of QUEUE launches less
one launch, over QUEUE - 1, removes the fixed cost of a call. Times are
CUDA-event medians (`device.cuda_ms`). Inputs are drawn on the card by an
explicit torch.Generator over the reference's ranges, fresh for every
launch of a queue and every repetition, before it is timed: the card has
no memoising execution service to defeat, and drawing them inside the
timed region (as the reference's jitted step does) would add the
generator's time to the kernel's. --device cpu runs the kernel's plain twin on CPU tensors, timed
by the host clock (tests).

vs_baseline: ratio against the REFERENCE's own SSE2 kernel
(tests/golden/golden_bench, prebuilt, which #includes the reference pair-HMM
headers), measured on this host's CPU and scaled to the 8 CPU threads of
the baseline configuration (BASELINE.md); null when it cannot run. It is
never rebuilt here.

detail: `gcups`, the H100 bound (`pairhmm_batch.pairhmm_bound`: int32
operations a cell over the int32 rate, tracks over the memory rate) as
`bound_ms`, `bound_by`, `bound_pairs_per_s` and `fraction_of_bound` (the
bound's time over the measured marginal time). The reference's TPU
ceilings (`speed_of_light_gcups_est`, `fraction_of_sol`,
`measured_issue_ceiling_gcups`, `fraction_of_issue_ceiling`) model a TPU
v5e's vector unit and are null here.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

R = 150
PAD = 8
BASELINE_THREADS = 8
QUEUE = 9          # batches per timed queue (one sync point)
PIPE = 5           # queues back to back for the pipelined measure
REPS = 5           # independent repetitions -> median + spread
SEED = 42
ROOT = Path(__file__).resolve().parent.parent
GOLDEN_BENCH = ROOT / "tests" / "golden" / "golden_bench"


def bench_inputs(B: int, device, generator: torch.Generator) -> list:
    """Batch-major int32 tracks of B pairs, drawn on `device` over the
    reference bench's ranges: tgt, qual (B, R); win, opn, ext, mask, prior
    (B, W)."""
    W = R + 2 * PAD - 1
    ranges = ((R, 0, 4), (R, 10, 40), (W, 0, 4), (W, 10, 50), (W, 1, 8),
              (W, 0, 4), (W, 3, 40))
    return [torch.randint(lo, hi, (B, n), generator=generator, device=device,
                          dtype=torch.int32) for n, lo, hi in ranges]


def _ms(fn, device) -> float:
    """Time of one call of fn after a warm-up: CUDA events on the card, the
    host clock on the CPU."""
    if device.type == "cuda":
        from .device import cuda_ms
        return cuda_ms(fn, reps=1)
    fn()
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def bench_card(batches=(16384, 65536), device="cuda", reps=REPS,
               seed=SEED) -> dict:
    """Scorer throughput at B = max(batches) pairs: marginal, single-launch
    and pipelined pairs/s over `reps` repetitions."""
    from .core.likelihood import pairhmm_batch as pb
    from .device import resolve_device
    dev = resolve_device(device)
    scorer = pb._scorer(dev)
    B = max(batches)
    gen = torch.Generator(device=dev).manual_seed(seed)
    inputs = []

    def step(K):
        total = torch.zeros((), dtype=torch.int64, device=dev)
        for k in range(K):
            total += scorer(*inputs[k], pad=PAD).sum()
        return total

    marginals, singles, pipelined = [], [], []
    for _ in range(reps):
        inputs[:] = [bench_inputs(B, dev, gen) for _ in range(QUEUE)]
        t1 = _ms(lambda: step(1), dev)
        tq = _ms(lambda: step(QUEUE), dev)
        # a rep whose queue is not slower than its single launch gives no
        # marginal time: drop it rather than emit a non-finite value
        per_batch = (tq - t1) / (QUEUE - 1)
        if per_batch > 0:
            marginals.append(B / per_batch * 1e3)
        singles.append(B / t1 * 1e3)
        # PIPE queues issued back to back, read once at the end: the launch
        # shape of a big window's populate, one sync for many launches
        tp = _ms(lambda: [step(QUEUE) for _ in range(PIPE)], dev)
        pipelined.append(PIPE * QUEUE * B / tp * 1e3)
    inputs.clear()

    def stats(xs):
        xs = [x for x in xs if np.isfinite(x)] or [float("nan")]
        return {"median": float(np.median(xs)), "min": float(np.min(xs)),
                "max": float(np.max(xs))}

    return {
        "marginal": stats(marginals),
        "single_launch": stats(singles),
        "pipelined": stats(pipelined),
        "queue": QUEUE,
        "pipeline_depth": PIPE,
        "B": B,
        "kernel": pb.scorer_name(dev),
        "backend": dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }


def bench_reference_kernel(reps: int = 5) -> dict:
    """Single-thread pairs/s of the reference SSE2 kernel on this host:
    median + spread over `reps` independent runs."""
    vals = []
    for _ in range(reps):
        out = subprocess.run([str(GOLDEN_BENCH), str(R), "40000"],
                             capture_output=True, text=True, check=True,
                             timeout=300)
        vals.append(float(json.loads(out.stdout)["pairs_per_s"]))
    return {"median": float(np.median(vals)), "min": float(np.min(vals)),
            "max": float(np.max(vals))}


def result(card: dict, baseline: float, baseline_spread) -> dict:
    """The JSON line's dict from bench_card's measures and the baseline's
    pairs/s (NaN when it could not run)."""
    from .core.likelihood.pairhmm_batch import pairhmm_bound
    value = card["marginal"]["median"]
    vs = value / baseline if baseline == baseline else None
    # GCUPS: banded DP cell updates/s = pairs/s x (R rows x 2*pad diagonals)
    D = 2 * PAD
    gcups = value * R * D / 1e9
    bound_ms, bound_by = pairhmm_bound(card["B"], R, PAD)
    bound_pairs = card["B"] / bound_ms * 1e3
    rnd = lambda s: {k: round(v, 1) for k, v in s.items()}  # noqa: E731
    return {
        "metric": "pairhmm_pairs_per_s_per_chip",
        "value": round(value, 1),
        "unit": "read-haplotype pairs/s (R=150, band 8; median of 5 reps)",
        "vs_baseline": round(vs, 3) if vs is not None else None,
        "detail": {
            "gcups": round(gcups, 1),
            "speed_of_light_gcups_est": None,
            "fraction_of_sol": None,
            "measured_issue_ceiling_gcups": None,
            "fraction_of_issue_ceiling": None,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "bound_pairs_per_s": round(bound_pairs, 1),
            "fraction_of_bound": round(value / bound_pairs, 4),
            "marginal_pairs_per_s": rnd(card["marginal"]),
            "total_pairs_per_s_incl_dispatch": round(
                card["pipelined"]["median"], 1),
            "pipelined_staged_pairs_per_s": rnd(card["pipelined"]),
            "single_launch_pairs_per_s": rnd(card["single_launch"]),
            "staging": {"queue": card["queue"],
                        "pipeline_depth": card["pipeline_depth"]},
            "baseline_ref_sse2_x8threads_pairs_per_s": (
                round(baseline, 1) if baseline == baseline else None),
            "baseline_spread": ([round(x, 1) for x in baseline_spread]
                                if baseline_spread else None),
            "kernel": card["kernel"],
            "backend": card["backend"],
            "device": card["device"],
        },
    }


def run(batches=(16384, 65536), device="cuda", reps=REPS) -> dict:
    """The JSON line's dict: the scorer timed on `device`, the reference
    SSE2 kernel on this host's CPU."""
    card = bench_card(batches, device, reps)
    try:
        ref = bench_reference_kernel()
        baseline = ref["median"] * BASELINE_THREADS
        baseline_spread = [ref["min"] * BASELINE_THREADS,
                           ref["max"] * BASELINE_THREADS]
    except (OSError, subprocess.SubprocessError, ValueError, KeyError):
        baseline = float("nan")
        baseline_spread = None
    return result(card, baseline, baseline_spread)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--batches", default="16384,65536",
                   help="comma-separated batch sizes; the largest is timed")
    p.add_argument("--reps", type=int, default=REPS)
    args = p.parse_args(argv)
    line = run(tuple(int(b) for b in args.batches.split(",")), args.device,
               args.reps)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
