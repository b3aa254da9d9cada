#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (octopus_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Twenty-two phases, each printing JSON lines:

1. build: g++ builds the host extension and nvcc builds the three CUDA
   kernels (csrc/pairhmm.cu, pairhmm_lanes.cu, pairhmm_cost.cu), all from
   the sources in the checkout, all at the same time; ptxas registers and
   spills per kernel, band and variant, and each variant's shared memory;
   a spill in any variant of csrc/pairhmm_cost.cu fails the run;
2. kernels: every kernel runs on random batches made from a numpy seed, at
   bench.py's shape, at bands 16 and 32, at R = 2000 and at the main path's
   own shapes (1 to 519 pairs, R = 160), and must equal its plain PyTorch
   twin on the same CUDA tensors bit for bit, in every variant the kernels
   are built with (csrc/pairhmm.cu: T threads a pair, split chain or
   wavefront; csrc/pairhmm_lanes.cu: two lane widths;
   csrc/pairhmm_cost.cu: T threads a pair);
   kernel, call, plain twin and each variant are timed with CUDA events
   (median of 7 runs after a warm-up, plain of 5), beside the variant the
   wrapper's rule chose, one trivial launch (launch_floor_ms), 20 launches
   back to back (stream_ms), the host's cost of one launch (host_ms) and,
   below 4096 pairs, 20 launches replayed from a CUDA graph (graph_ms: card
   time only). A sweep of launch sizes from 1024 to 32768 pairs (R = 160,
   bands 8 and 16) times the latency variants (wavefront, full lane width)
   against the throughput ones (split chain, half lane width, fewer threads
   a pair), which sets the wrapper's WAVE_BELOW and COST_THREADS_BY_B
   (variant_sweep);
2b. kernel_experiments: the ports of the five Pallas experiments in
   experiments/ (octopus_tpu_torch/kernel_experiments/, csrc/exp_*.cu,
   built in phase 1 beside the others), on no product path, at their bench
   shape (65,536 pairs, R = 150, band 8, their random tracks; i16 at
   (16, 1,048,576) int16): every K/pack variant of each experiment's
   __main__, and v11's and v13's Hopper designs beside their first ports,
   against its plain version and the four scorers against kernel #1 on
   the same tracks, error 0 (v11 and v13 also on the edge inputs of
   kernel_experiments._common.EDGE_CASES); kernel and wrapper times, #1's
   beside them, plain times, bounds; each scorer variant's registers,
   spills, SASS size, its row loop's shared- and device-memory loads
   (cuobjdump) and what one SM holds (occupancy); the i16 loop's SASS:
   packed .S16x2 instructions and instructions an element a round;
3. gate_sweep: job sets of 1 to 1024 pairs (R = 160, band 8) scored by the
   host DP and by the card call with its copies; the crossover;
4. main_path: a simulated 30x diploid sample is called in memory through
   IndividualCaller on the card, window by window. A first, untimed run
   with the host-DP gate at 0 keeps every kernel launch and holds each
   one's scores against the plain version on the same tensors bit for bit.
   Then timed runs in turns, with the default host-DP gate and with the
   gate at 0, so that every HMM job set goes to the kernel (default, 0, 0,
   default). Every run must write the same VCF records, each run at gate 0
   must launch the kernel, and recall and precision against the simulated
   truth must reach 0.95;
5. cli: a simulated 30x diploid BAM (written untimed by the port's own
   writer) is called through octopus_tpu_torch.cli.main on the card, with
   inline threshold CSR. First two untimed runs with the host-DP gate at 0,
   one through csrc/pairhmm.cu and one with OCTOPUS_TPU_UNROLLED_HMM=1
   through csrc/pairhmm_lanes.cu, keep every launch (from populate and from
   read assignment) and hold each against its plain twin. Then timed runs
   in turns: default gate, gate 0, gate 0 unrolled, default gate. Every
   run must write the same VCF records, reach recall and precision 0.95 on
   PASS records and leave FACET_MISSES at 0; each gate-0 run must launch
   its kernel from both populate and read assignment;
6. vb_gate_sweep: SubcloneModel.evaluate (K = 3, 2 seeds, 40 iterations,
   the cancer caller's) at 128 reads and 1 to 4096 genotypes, on
   CPU torch and on the card with its copies; host-clock medians of 7 runs
   in turns (the host's capped at 5 s a size), and the crossover in real
   elements (G*S*K*N), which sets subclone_vb.VB_DEVICE_MIN;
7. cancer_cli: a simulated tumour (60x) and normal (30x), 100 kb, about 14
   somatic SNVs at VAF 0.25 (the cancer mode of bench_e2e_multi, written
   untimed), through octopus_tpu_torch.cli.main with --caller cancer
   --normal-sample NORMAL. An untimed checked run with both gates at 0
   (OCTOPUS_TPU_HOST_HMM_MAX and OCTOPUS_TPU_VB_DEVICE_MIN) keeps every
   pair-HMM launch and every VB evaluation and holds them against the plain
   twin and the same evaluation on the CPU (bit for bit; the rows
   of the largest on a sample, check_vb). Then one timed run at the
   default gates (a second timed gates-0 run was cut for the time limit).
   Both runs must write the same records; the gates-0 run must launch
   kernel #1 from populate and read assignment and run VB on the card;
   germline recall and precision must reach 0.95 and somatic 0.9;
8. polyclone_cli and cell_cli: the BAMs of the reference package's
   tests/test_e2e_polyclone_cell.py (12 kb, 3 clones, 100x; 9 kb, 6 cells,
   15x) through the CLI once on the card with both gates at 0, every VB
   evaluation held against the CPU's, and those tests' truth checks.
9. population_cli and trio_cli: bench_e2e_multi's population (3
   samples) and trio (MOM, DAD, KID with 10 de novo SNVs) inputs, 100 kb at
   30x, uncut (written untimed), through
   the CLI with --caller population and with -M MOM -F DAD. An untimed
   checked run with the host-DP gate at 0 keeps every kernel #1 launch
   (from populate and read assignment) and holds it against the plain twin
   bit for bit; then timed runs in turns: default gate, gate 0, default
   gate. Every run must write the same records, each gate-0 run must
   launch kernel #1 from both sources, and the accuracy must equal the
   reference CLI's on the same BAMs (MULTI_BARS).

10. pool_cli: the cli phase's BAM through the CLI serially, on the process
   pool (--threads W, W = min(8, cores); CPU-only workers, the parent keeps
   the card) and on the thread pool (--thread-workers), default gates, one
   run each (serial, processes, threads); every run must write the
   serial card run's records, and no pool may fall back to threads;
11. pool_cli_deferred: the process pool with every window of a variant
   handed back to the parent (OCTOPUS_TPU_DEFER_HEAVY_AT=1) and the
   parent's host-DP gate at 0: the parent must launch kernel #1, each
   launch held against the plain twin, and write the same records;
12. shard_cli: two OS processes share the run through --work-queue
   --num-shards 2 on the card (gate 0); each must launch kernel #1, and the
   last to finish merges a VCF byte-identical to the serial card run's;
13. sharded_kernels: parallel.sharded_pairhmm_scores over [cuda:0, cuda:0]
   and over every visible card, at the bench shape and at B = 4,099,
   bit-equal to the unsharded kernel and its plain twin, one launch a
   shard; sharded_genotype_step within (rtol 2e-4, atol 2e-3) of the
   unsharded torch reduction.
14. csr_tools_cli: the cli phase's BAM and serial VCF through inline
   forest CSR (--forest-model resources/forests/germline.npz), --filter-vcf
   of the serial VCF (threshold, and with the forest) and --bamout, each at
   gate 0 and the default gate, --bamout also through kernel #3 at gate 0;
   every launch of the gate-0 runs held against its plain twin bit for bit.
   A tool's records (and BAM) must be identical at every gate; the
   threshold --filter-vcf and --bamout's calls must equal the serial run's
   records (the inline threshold CSR);
15. cram_cli: the same reads rewritten as a CRAM by the port's cram_writer,
   called at the default gate in turns with the BAM (bam, cram, bam); every
   run must write the serial run's records.

The ported entry points (octopus_tpu_torch.bench, bench_e2e,
bench_e2e_multi, bench_scaling, scripts/), each phase printing the
module's own JSON line before its row:

16. bench: the bench module at its batches (the largest, 65,536 pairs,
   timed), then its inputs at 16,384 pairs through the scorer it times
   against the plain twin, error 0;
17. scripts: long_phase on the cli phase's BAM (pass 1 writes the serial
   run's records, pass 2 a subset of its sites at recall 0.95),
   split_realigned_bam and filter_assigned_reads on csr_tools_cli's
   evidence BAM, train_forest --synthetic at 30 kb and its forest in
   --forest-model on the cli BAM;
18. bench_e2e: the README's 200 kb at 30x, the module's own run (--threads
   8, default gate) and a serial run at gate 0 that must launch #1 after
   the warm-up; identical records, recall and precision 0.95, the pool's
   start-up beside the walls;
19. bench_e2e_long: the long mode (5-15 kb reads, the PacBioCCS preset) at
   30 kb (the README's 100 kb, cut for the time limit), 30x, at the
   default gate and gate 0: identical records, #1 launched at gate 0, its
   longest R printed; then #1 in every variant on 256 pairs of 5 kb and
   of 15 kb reads against the plain twin (long_read_kernel);
20. bench_scaling: 1 Mb at 30x as one and two --work-queue processes; the
   merged body identical;
21. bench_multi: bench_e2e_multi.bench, the module's own path (--threads
   4), for its polyclone, cell and trio modes; the accuracy must equal the
   reference CLI's on the same seed. Phases 7 and 9 take their inputs and
   accuracy lines from the same module.

Phases 10-12, 14, 15 and 17 run after the cli phase, in the order above,
then 18-20 and 13; 16 runs after gate_sweep, 21 last.

Then it prints the card's name and power limit, the kernel table, and as
its last line {"ok": true, "device": {...}}. Any failure raises, and the
script exits non-zero without that line. It needs a CUDA card and the
repository checkout around it.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np

# the H100's rates and the pair-HMM's bound, one copy for this script and
# the bench module
from octopus_tpu_torch.core.likelihood.pairhmm_batch import (
    DRAM_BYTES_PER_S, INT32_OPS_PER_S, MATCH_COST_OPS, OPS_PER_CELL,
    pairhmm_bound)

SEED = 2024
REGION_KB = 100          # of a whole genome: cut for the run's time limit
CLI_REGION_KB = 300      # the CLI phase's contig: cut for the time limit
DEPTH = 30
READ_LEN = 150
WINDOW_TARGET_READS = 5000
WINDOW_BIN = 1 << 14     # density bins of the windowing, as a BAI's
WINDOW_MIN = 5_000
READ_PAD = 200           # reads fetched beyond each window edge
# the cost kernel's own work per cell: the wavefront without the match
# cost, which ran when the cost tensor was built
COST_OPS_PER_CELL = OPS_PER_CELL - MATCH_COST_OPS
# the main path's job sets: 150 bp reads in the 32-wide length bucket (R =
# 160), a few to a few hundred pairs a launch, bands 8 and 16
MAIN_PATH_SHAPES = [(B, 160, pad) for pad in (8, 16)
                    for B in (1, 9, 37, 300, 519)]
KERNELS = ("pairhmm", "pairhmm_lanes", "pairhmm_cost")
REPLACES = {
    "pairhmm": "octopus_tpu/core/likelihood/pairhmm_batch.py:531",
    "pairhmm_lanes": "octopus_tpu/core/likelihood/pairhmm_batch.py:319",
    "pairhmm_cost": "octopus_tpu/core/likelihood/pairhmm_batch.py:233",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

# each kernel's template parameters, in order
TEMPLATE_PARAMS = {"pairhmm": ("D", "T"),
                   "pairhmm_wave": ("D", "W"),
                   "pairhmm_lanes": ("D", "LW"),
                   "pairhmm_cost": ("D", "T"),
                   # the kernel experiments (phase kernel_experiments): K
                   # pairs a thread, L lanes a block, the row schedule
                   "exp_dual_chain": ("K", "L", "S"),
                   "exp_v13": ("K", "L", "S"),
                   "exp_v10": ("K", "L"),
                   "exp_v10_regs": ("L", "P"),
                   "exp_v10_rings": ("L", "C"),
                   "exp_v11": ("BLK",),
                   "exp_v11_regs": ("L", "P"),
                   "exp_i16": ("PACK",)}


def template_key(function: str, kernel: str) -> str:
    """A mangled kernel instantiation's name from its template arguments
    ("D16_T4", "K4_L32_S0"); "" without template arguments."""
    m = re.search(r"I((?:L[ib]\d+E)+)E", function)
    values = re.findall(r"L[ib](\d+)E", m.group(1)) if m else []
    if "_wave_kernel" in function:
        kernel += "_wave"
    if "regs_kernel" in function:
        kernel += "_regs"
    if "rings_kernel" in function:
        kernel += "_rings"
    return "_".join(f"{k}{v}" for k, v in zip(TEMPLATE_PARAMS[kernel], values))


def ptxas_table(log: str, kernel: str) -> dict:
    """Registers, stack frame and spill bytes per instantiation (e.g.
    "D16_T4") from nvcc's -Xptxas -v log; a device function compiled out
    of line (a "Function properties" block of no entry function) is not
    counted in the kernel's."""
    ptxas = {}
    current = props = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = template_key(line, kernel) or None
            props = None
        elif "Function properties for" in line:
            props = template_key(line, kernel) or None
        elif current and props == current and "spill stores" in line:
            parts = line.split()
            ptxas.setdefault(current, {}).update(
                stack_frame_bytes=int(parts[0]),
                spill_store_bytes=int(parts[4]),
                spill_load_bytes=int(parts[8]))
        elif current and "Used" in line and "registers" in line:
            ptxas.setdefault(current, {})["registers"] = int(
                line.split("Used")[1].split()[0])
    return ptxas


def smem_table(pb) -> dict:
    """Dynamic shared memory of one block (one warp) per kernel, band and
    variant."""
    out = {}
    for pad in pb.PADS:
        D = 2 * pad
        for T in pb.THREADS:
            if T <= D:
                out[f"pairhmm_D{D}_T{T}"] = pb.smem_bytes("pairhmm", pad, T, 0)
            if pb.wave_ok(T, pad):
                out[f"pairhmm_D{D}_W{T}"] = pb.smem_bytes("pairhmm", pad, T, 1)
        for LW in pb.lanes_widths(pad):
            out[f"pairhmm_lanes_D{D}_LW{LW}"] = pb.smem_bytes("pairhmm_lanes",
                                                              pad, LW)
        for T in pb.THREADS:
            if pb.cost_threads_ok(T, pad):
                out[f"pairhmm_cost_D{D}_T{T}"] = pb.smem_bytes("pairhmm_cost",
                                                               pad, T)
    return out


def phase_build():
    from octopus_tpu_torch import _build
    from octopus_tpu_torch.core.likelihood import pairhmm_batch as pb
    from octopus_tpu_torch.kernel_experiments import _common as xc
    with concurrent.futures.ThreadPoolExecutor(
            1 + len(KERNELS) + len(xc.ENTRIES)) as pool:
        jobs = [pool.submit(_build.require_native)]
        jobs += [pool.submit(pb.kernel_library, name) for name in KERNELS]
        # the kernel experiments' libraries, reported by their own phase
        jobs += [pool.submit(xc.library, name) for name in xc.ENTRIES]
        for job in jobs:
            job.result()
    ptxas = {n: ptxas_table(_build.BUILDS[n]["log"], n) for n in KERNELS}
    emit({"phase": "build",
          "host_extension_loaded": "octopus_tpu_torch._native" in sys.modules,
          "host_extension_s": _build.BUILDS["_native"]["seconds"],
          "nvcc_s": {n: _build.BUILDS[n]["seconds"] for n in KERNELS},
          "ptxas": ptxas,
          "smem_bytes": smem_table(pb)})
    # the cost kernel's design keeps every band in registers (no spills)
    spills = {v: r for v, r in ptxas["pairhmm_cost"].items()
              if r["spill_store_bytes"] or r["spill_load_bytes"]}
    if spills or not ptxas["pairhmm_cost"]:
        raise AssertionError(f"pairhmm_cost spills or is missing: {spills}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def random_batch(rng, B, R, pad, heavy_indel=False):
    """Ragged reads drawn from their windows with SNVs and indels, window
    Ns, SNV masks and priors; heavy_indel lowers the gap penalties."""
    W = R + 2 * pad - 1
    win = rng.integers(0, 4, (B, W))
    win[rng.random((B, W)) < 0.01] = 4                           # window Ns
    lens = rng.integers(max(R // 2, 1), R + 1, B)
    start = np.clip(pad + rng.integers(-3, 4, B), 0, W - lens)
    col = np.arange(R)
    src = np.minimum(start[:, None] + col[None, :], W - 1)
    tgt = np.take_along_axis(win, src, axis=1) % 4
    snv = rng.random((B, R)) < 0.02
    tgt = np.where(snv, (tgt + rng.integers(1, 4, (B, R))) % 4, tgt)
    # indels: shift the tail of a read by a few bases at a random row
    shift = rng.integers(-3, 4, B)
    at = rng.integers(0, R, B)
    src2 = np.clip(src + np.where(col[None, :] >= at[:, None], shift[:, None], 0),
                   0, W - 1)
    tgt = np.where(rng.random(B)[:, None] < 0.3,
                   np.take_along_axis(win, src2, axis=1) % 4, tgt)
    valid = col[None, :] < lens[:, None]
    tgt = np.where(valid, tgt, 5)
    qual = np.where(valid, rng.integers(5, 42, (B, R)), 0)
    lo_o, lo_e = (3, 1) if heavy_indel else (10, 1)
    opn = rng.integers(lo_o, 55, (B, W))
    ext = rng.integers(lo_e, 10, (B, W))
    mask = rng.integers(0, 6, (B, W))
    prior = rng.integers(3, 50, (B, W))
    return [np.ascontiguousarray(a, np.int32)
            for a in (tgt, qual, win, opn, ext, mask, prior)]


def cuda_ms(fn, reps=7):
    """Median CUDA-event ms of fn over `reps` runs after a warm-up."""
    from octopus_tpu_torch.device import cuda_ms as median_ms
    return median_ms(fn, reps)


def stream_ms(fn, n=20):
    """CUDA-event time a launch over n back-to-back launches: the body's
    time wherever it exceeds the host's cost of one launch."""
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def graph_ms(fn, n=20):
    """Card time of one launch: n launches captured in a CUDA graph and
    replayed, timed with CUDA events, over n. No host work between launches,
    so this is the kernel body where stream_ms is held back by the host."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_ms(graph.replay) / n


def host_ms(fn, n=20):
    """Host-clock time of one call that only enqueues work, over n calls."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return t


def cost_bound(B, R, pad):
    """Least time for the cost kernel's own work on B pairs: the (R*D, B)
    cost tensor and the opn/ext tracks read once and the scores written
    once over the memory rate, against COST_OPS_PER_CELL int32 ops per
    cell (plus row 0 and the band minimum, 6 per lane) over the int32
    rate."""
    D = 2 * pad
    W = R + 2 * pad - 1
    ops = (COST_OPS_PER_CELL * R + 6) * D * B
    nbytes = (R * D + 2 * W) * 4 * B + 4 * B
    t_ops = ops / INT32_OPS_PER_S * 1e3
    t_bytes = nbytes / DRAM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def cost_inputs(pb, args, pad):
    """The cost kernel's prepared inputs for batch-major CUDA tracks: the
    (R*D, B) match-cost tensor and opn/ext in (W, B) layout."""
    cm = pb.match_cost_tensor(args[0], args[1], args[2], args[5], args[6],
                              pad=pad)
    opnT, extT = (a.t().contiguous() for a in args[3:5])
    return cm, opnT, extT


def kernel_variants(pb, args, pad, cost):
    """kernel -> (one launch on prepared inputs, the call, its plain twin,
    the bound function) for batch-major CUDA tracks `args`."""
    cm, opnT, extT = cost
    return {
        "pairhmm": (lambda: pb.launch_kernel(args, pad=pad),
                    lambda: pb.pairhmm_scores_cuda(*args, pad=pad),
                    lambda: pb.pairhmm_scores_plain(*args, pad=pad),
                    pairhmm_bound),
        "pairhmm_lanes": (lambda: pb.launch_lanes(args, pad=pad),
                          lambda: pb.pairhmm_scores_lanes_cuda(*args, pad=pad),
                          lambda: pb.pairhmm_scores_lanes_plain(*args,
                                                                pad=pad),
                          pairhmm_bound),
        "pairhmm_cost": (lambda: pb.launch_cost(cm, opnT, extT, pad=pad),
                         lambda: pb.pairhmm_scores_cost_cuda(*args, pad=pad),
                         lambda: pb.pairhmm_scores_cost_plain(*args, pad=pad),
                         cost_bound),
    }


def build_variants(pb, args, pad, cost):
    """kernel -> {variant name: one launch}: every T (threads a pair) of
    csrc/pairhmm.cu, split chain ("T4") and wavefront ("W4"), every LW
    (lanes a pair) of csrc/pairhmm_lanes.cu ("LW16"), and every T of
    csrc/pairhmm_cost.cu ("T4") on the cost tensor `cost` = (cm, opn, ext)
    in kernel layout."""
    D = 2 * pad
    out = {"pairhmm": {}, "pairhmm_lanes": {}, "pairhmm_cost": {}}
    cm, opnT, extT = cost
    for T in pb.THREADS:
        if pb.cost_threads_ok(T, pad):
            out["pairhmm_cost"][f"T{T}"] = (
                lambda T=T: pb.launch_cost(cm, opnT, extT, pad=pad,
                                           threads=T))
    for T in pb.THREADS:
        if T <= D:
            out["pairhmm"][f"T{T}"] = (
                lambda T=T: pb.launch_kernel(args, pad=pad, threads=T))
        if pb.wave_ok(T, pad):
            out["pairhmm"][f"W{T}"] = (
                lambda T=T: pb.launch_kernel(args, pad=pad, threads=T,
                                             wave=True))
    for LW in pb.lanes_widths(pad):
        out["pairhmm_lanes"][f"LW{LW}"] = (
            lambda LW=LW: pb.launch_lanes(args, pad=pad, lanes=LW))
    return out


def chosen_variant(pb, kernel, B, pad):
    if kernel == "pairhmm_cost":
        return f"T{pb.cost_threads(B, pad)}"
    if kernel == "pairhmm":
        T = pb.pairhmm_threads(B, pad)
        return f"{'W' if pb.pairhmm_wave(B, pad) else 'T'}{T}"
    return f"LW{pb.lanes_width(B, pad)}"


def launch_floor_ms():
    """CUDA-event time of one trivial launch (a one-word fill)."""
    import torch
    x = torch.zeros(1, dtype=torch.int32, device="cuda")
    return cuda_ms(lambda: x.fill_(0), reps=15)


KERNEL_CASES = [("bench_R150_band8", 65536, 150, 8, False),
                ("R150_band16", 65536, 150, 16, True),
                ("R150_band32", 65536, 150, 32, True),
                ("long_R2000_band8", 4096, 2000, 8, False)]
# the main path's own shapes, ragged batch edges (B % 32 != 0) included
KERNEL_CASES += [(f"main_B{B}_R{R}_band{pad}", B, R, pad, B % 2 == 1)
                 for B, R, pad in MAIN_PATH_SHAPES]
# launch sizes between the main path's and the bench shape's, for the
# wrapper's WAVE_BELOW
SWEEP_SIZES = (1024, 2048, 4096, 8192, 16384, 32768)
KERNEL_CASES += [(f"sweep_B{B}_R160_band{pad}", B, 160, pad, False)
                 for pad in (8, 16) for B in SWEEP_SIZES]


def variant_sweep(results):
    """Per band, the fastest latency variant (csrc/pairhmm.cu's wavefront,
    csrc/pairhmm_lanes.cu at full lane width, csrc/pairhmm_cost.cu at 16
    threads a pair) against the fastest throughput variant (split chain,
    half lane width, fewer threads a pair) at each launch size of the sweep
    and the bench shape, and the fastest variant of all; the least size
    from which the throughput variant is faster at every larger size.
    WAVE_BELOW and COST_THREADS_BY_B are set from it."""
    def latency(kernel, variant, variants):
        if kernel == "pairhmm":
            return variant.startswith("W")
        return variant == max(variants, key=lambda v: int(v.lstrip("LWT")))

    rows = {}
    for kernel in ("pairhmm", "pairhmm_lanes", "pairhmm_cost"):
        for r in results[kernel]:
            if not (r["case"].startswith("sweep_") or r["R"] == 150):
                continue
            vm = r["variant_ms"]
            split = collections.defaultdict(list)
            for v, ms in vm.items():
                split[latency(kernel, v, vm)].append(ms)
            rows.setdefault((kernel, r["pad"]), []).append(
                {"B": r["B"], "R": r["R"], "latency_ms": min(split[True]),
                 "throughput_ms": min(split[False]), "chosen": r["chosen"],
                 "fastest": min(vm, key=vm.get)})
    out = []
    for (kernel, pad), rs in sorted(rows.items()):
        rs.sort(key=lambda x: x["B"])
        from_B = None
        for i, x in enumerate(rs):
            if all(y["throughput_ms"] < y["latency_ms"] for y in rs[i:]):
                from_B = x["B"]
                break
        out.append({"kernel": kernel, "pad": pad, "rows": rs,
                    "throughput_faster_from_B": from_B})
    emit({"phase": "variant_sweep", "sweeps": out})
    return out


def phase_kernels(cases=KERNEL_CASES):
    import torch
    from octopus_tpu_torch.core.likelihood import pairhmm_batch as pb
    rng = np.random.default_rng(SEED)
    results = {k: [] for k in KERNELS}
    floor_ms = launch_floor_ms()
    for name, B, R, pad, heavy in cases:
        host = random_batch(rng, B, R, pad, heavy_indel=heavy)
        args = [torch.from_numpy(a).cuda() for a in host]
        cost = cost_inputs(pb, args, pad)
        variants = build_variants(pb, args, pad, cost)
        for kernel, (launch, call, plain, bound) in kernel_variants(
                pb, args, pad, cost).items():
            got = call()
            want = plain()
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            variant_ms, variant_graph_ms = {}, {}
            for vname, vlaunch in variants.get(kernel, {}).items():
                vgot = vlaunch()
                torch.cuda.synchronize()
                err = max(err, int((vgot.long() - want.long()).abs().max()))
                variant_ms[vname] = cuda_ms(vlaunch)
                if B < 4096:
                    variant_graph_ms[vname] = graph_ms(vlaunch)
            if err != 0:
                raise AssertionError(f"{kernel} {name}: kernel differs from "
                                     f"its plain twin by {err}")
            kernel_ms = cuda_ms(launch)
            wrapper_ms = cuda_ms(call)
            plain_ms = cuda_ms(plain, reps=5)
            bound_ms, bound_by = bound(B, R, pad)
            row = {"kernel": kernel, "case": name, "B": B, "R": R, "pad": pad,
                   "max_abs_err": err, "kernel_ms": kernel_ms,
                   "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                   "pairs_per_s": B / (wrapper_ms / 1e3),
                   "cells_per_s": B * R * 2 * pad / (wrapper_ms / 1e3),
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "launch_floor_ms": floor_ms}
            if variant_ms:
                row["chosen"] = chosen_variant(pb, kernel, B, pad)
                row["variant_ms"] = variant_ms
                row["stream_ms"] = stream_ms(launch)
                row["host_ms"] = host_ms(launch)
                if variant_graph_ms:
                    row["variant_graph_ms"] = variant_graph_ms
                    row["graph_ms"] = graph_ms(launch)
            emit({"phase": "kernels", **row})
            results[kernel].append(row)
        del args, variants, cost
        torch.cuda.empty_cache()
    return results


GATE_SWEEP_SIZES = (1, 4, 16, 64, 128, 256, 384, 512, 1024)


def phase_gate_sweep(device="cuda", sizes=GATE_SWEEP_SIZES, reps=7):
    """Job sets of n pairs (R = 160, band 8) scored both ways that
    likelihood_array._device_scores can take them: the host DP
    (_native.flank_banded_scores, no flanks) and the card call with its
    copies (numpy in, pairhmm_scores, numpy out). Host-clock medians; the
    crossover is the least n at which the card call is faster. Both give
    the same scores."""
    from octopus_tpu_torch._build import require_native
    from octopus_tpu_torch.core.likelihood import pairhmm_batch as pb
    native = require_native()
    rng = np.random.default_rng(SEED + 1)
    pad, R = 8, 160
    rows = []
    for n in sizes:
        host = random_batch(rng, n, R, pad)
        tgt, qual, win, opn, ext, mask, prior = host
        W = win.shape[1]
        lens = (tgt != pb.PAD_CODE).sum(1).astype(np.int32)
        zeros = np.zeros(n, np.int32)

        def host_dp():
            return np.frombuffer(native.flank_banded_scores(
                n, R, W, pad, pb.DEFAULT_NUC_PRIOR, tgt, qual, win, opn, ext,
                mask, prior, lens, zeros, zeros), np.int32)

        def card():
            return pb.pairhmm_scores(*host, pad=pad,
                                     device=device).cpu().numpy()

        if not np.array_equal(host_dp(), card()):
            raise AssertionError(f"gate_sweep n={n}: host DP and card differ")
        times = {}
        for label, fn in (("host_ms", host_dp), ("card_ms", card),
                          ("card_ms", card), ("host_ms", host_dp)):
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                times.setdefault(label, []).append(
                    (time.perf_counter() - t0) * 1e3)
        row = {"pairs": n, "R": R, "pad": pad,
               "host_ms": statistics.median(times["host_ms"]),
               "card_ms": statistics.median(times["card_ms"]),
               "threads": pb.pairhmm_threads(n, pad)}
        rows.append(row)
    crossover = next((r["pairs"] for r in rows
                      if r["card_ms"] < r["host_ms"]), None)
    emit({"phase": "gate_sweep", "device": device, "rows": rows,
          "crossover_pairs": crossover})
    return crossover


# ---------------------------------------------------------------------------
# phase: the kernel experiments (off every product path)
# ---------------------------------------------------------------------------

# experiment library -> the TPU kernel's pl.pallas_call
EXPERIMENTS = {
    "exp_dual_chain": "experiments/dual_chain.py:115",
    "exp_v10": "experiments/v10_kernel.py:135",
    "exp_v11": "experiments/v11_kernel.py:112",
    "exp_v13": "experiments/v13_unroll2.py:123",
    "exp_i16": "experiments/i16_probe.py:35",
}
# the variant of each experiment in the kernels line: its experiment's
# default keyword, or (v10, v11, v13) the Hopper design its entry point
# launches
EXP_DEFAULT = {"exp_dual_chain": "K2", "exp_v10": "regs_p16",
               "exp_v11": "regs_ring_p4", "exp_v13": "shared_K1",
               "exp_i16": "pack2"}
# rows a row-loop iteration as the source writes it, for each Schedule of
# csrc/exp_rows.cuh: UNROLL2, TWO_ROWS, ONE_ROW, SHARED2
SCHEDULE_ROWS = {0: 2, 1: 2, 2: 1, 3: 2}


def exp_build(lib: str, variant: str):
    """A scorer variant's instantiation key in the ptxas report and the
    SASS, the rows and pairs an iteration of its row loop as the source
    writes it, and its occupancy query (experiment and arguments), from the
    wrappers' own variant tables; None for i16."""
    from octopus_tpu_torch.kernel_experiments import (v10_kernel, v11_kernel,
                                                      v13_unroll2)
    if lib == "exp_dual_chain":
        K = int(variant.lstrip("K"))
        return f"K{K}_L32_S0", SCHEDULE_ROWS[0], K, ("dual_chain", K)
    if lib == "exp_v13":
        K, S = v13_unroll2.VARIANTS[variant]
        return f"K{K}_L32_S{S}", SCHEDULE_ROWS[S], K, ("v13", K, S)
    if lib == "exp_v11":
        arg = v11_kernel.VARIANTS[variant]
        kind, n = re.fullmatch(r"(regs_ring_p|shfl_blk)(\d+)",
                               variant).groups()
        if kind == "shfl_blk":
            return f"BLK{n}", 1, 1, ("v11", arg)
        return f"L32_P{n}", int(n), 1, ("v11", arg)
    if lib == "exp_v10":
        arg = v10_kernel.VARIANTS[variant]
        if variant.startswith("tracks10"):
            K = int(variant.rsplit("K", 1)[1])
            return (f"K{K}_L{16 if K == 8 else 32}", SCHEDULE_ROWS[0], K,
                    ("v10", arg))
        if variant == "rings":
            return "L32_C4", SCHEDULE_ROWS[0], 1, ("v10", arg)
        P = int(variant.rsplit("p", 1)[1])
        return f"L32_P{P}", P, 1, ("v10", arg)
    return None


# pairs of the edge checks: a multiple of every variant's 128 K
EDGE_B = 3072
# the i16 probe's least int work an element, a fused DPX form counted as
# one operation as in OPS_PER_CELL: 7 a round (m + a and its min, the min
# with the shifted m, i + 2, the select, three prefix mins), and once the
# compare and the final min
I16_OPS_PER_ROUND = 7
I16_OPS_ONCE = 2
I16_SHAPE = (16, 1 << 20)


# v10's cell: nuc_prior folded into the insertion sum, the N cap one min
V10_OPS_PER_CELL = OPS_PER_CELL - 2


def v10_bounds(B, R, pad, tracks10=False) -> dict:
    """v10's least time, ms: V10_OPS_PER_CELL int32 ops a cell (as
    pairhmm_bound counts OPS_PER_CELL) against its tracks read once and the
    scores written once, over the memory rate: the seven raw tracks (2 of R
    rows, 5 of W), or the first port's ten (2 of R, 8 of W). Beside it the
    function's bound at OPS_PER_CELL ops a cell and the ten tracks'
    bytes."""
    D, W = 2 * pad, R + 2 * pad - 1
    ops_ms = (V10_OPS_PER_CELL * R + 6) * D * B / INT32_OPS_PER_S * 1e3

    def bytes_ms(window_tracks):
        return (((2 * R + window_tracks * W) * 4 * B + 4 * B)
                / DRAM_BYTES_PER_S * 1e3)

    mem_ms = bytes_ms(8 if tracks10 else 5)
    return {"bound_ms": max(ops_ms, mem_ms),
            "bound_by": "operations" if ops_ms >= mem_ms else "bytes",
            "function_bound_14op_ms": pairhmm_bound(B, R, pad)[0],
            "ten_track_bytes_ms": bytes_ms(8)}


def sass_functions(path: str) -> dict:
    """function name -> [(address, instruction)] from cuobjdump -sass of a
    built library."""
    import os
    from octopus_tpu_torch._build import nvcc_path
    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    out, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = out.setdefault(line.split("Function :")[1].strip(), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if current is not None and m:
            current.append((int(m.group(1), 16), m.group(2).strip()))
    return out


def sass_loop(body) -> dict:
    """The innermost backward-branch loop of one function's SASS: its
    instructions, mnemonic counts, and how many are .S16x2."""
    loops = []
    for addr, text in body:
        b = re.search(r"\bBRA\s+(0x[0-9a-f]+)", text)
        if b and int(b.group(1), 16) < addr:
            loops.append((int(b.group(1), 16), addr))
    if not loops:
        raise AssertionError("no loop in the SASS")
    lo, hi = min(loops, key=lambda r: r[1] - r[0])
    ops = [t.split()[1] if t.startswith("@") else t.split()[0]
           for a, t in body if lo <= a <= hi]
    return {"instructions": len(ops),
            "s16x2": sum("S16x2" in o for o in ops),
            "mnemonics": dict(collections.Counter(ops).most_common())}


def mnemonic(text: str) -> str:
    return text.split()[1] if text.startswith("@") else text.split()[0]


def sass_counts(ops) -> dict:
    """Instructions, shared-memory loads (LDS), device-memory loads (LDG),
    cp.async copies (LDGSTS), register moves (MOV) and barriers (BAR)
    among SASS mnemonics, and the most common mnemonics."""
    ops = list(ops)
    return {"instructions": len(ops),
            "lds": sum(o.startswith("LDS") for o in ops),
            "ldg": sum(o.startswith("LDG") and not o.startswith("LDGSTS")
                       for o in ops),
            "ldgsts": sum(o.startswith("LDGSTS") for o in ops),
            "mov": sum(o.split(".")[0] == "MOV" or o.startswith("IMAD.MOV")
                       for o in ops),
            "bar": sum(o.startswith("BAR") for o in ops),
            "top": dict(collections.Counter(ops).most_common(10))}


def sass_row_loop(body) -> dict:
    """The backward-branch loop of one function's SASS with the most
    instructions of its own (none of a loop nested in it): a scorer's row
    loop. Its counts (sass_counts)."""
    loops = []
    for addr, text in body:
        b = re.search(r"\bBRA\s+(0x[0-9a-f]+)", text)
        if b and int(b.group(1), 16) < addr:
            loops.append((int(b.group(1), 16), addr))

    def own(lo, hi):
        inner = [r for r in loops if r != (lo, hi) and lo <= r[0]
                 and r[1] <= hi]
        return [t for a, t in body if lo <= a <= hi
                and not any(x <= a <= y for x, y in inner)]

    if not loops:
        raise AssertionError("no loop in the SASS")
    return sass_counts(mnemonic(t) for t in max((own(*r) for r in loops),
                                                key=len)
                       if not t.startswith("@!PT"))


def i16_sass(functions: dict) -> dict:
    """Per pack, the 50-round loop's SASS: instructions, .S16x2 ones, and
    instructions an element a round (16 rows x pack columns a thread)."""
    out = {}
    for name, body in functions.items():
        key = template_key(name, "exp_i16")
        loop = sass_loop(body)
        loop["per_element_round"] = loop["instructions"] / (
            16 * int(key.lstrip("PACK")))
        out[key.lower()] = loop
    return out


def phase_kernel_experiments(seed=SEED):
    """The five kernel experiments at their bench shape (65,536 pairs, R =
    150, band 8; i16 at (16, 1,048,576)): every variant of each
    experiment's __main__ (v10, v11 and v13: their Hopper designs and first
    ports) against its plain version and, for the four scorers, against
    kernel #1 on the same tracks, error 0, also (v10, v11, v13) on
    EDGE_CASES; kernel and wrapper CUDA-event medians of 7, #1's beside
    them (and dual_chain K1's and K2's beside each v10, v11 and v13
    variant), plain of 5; v10's own bounds; each variant's registers,
    spills, SASS size, row loop's loads and occupancy; the i16 loop's
    SASS."""
    import torch
    from octopus_tpu_torch import _build
    from octopus_tpu_torch.core.likelihood import pairhmm_batch as pb
    from octopus_tpu_torch.kernel_experiments import (
        _common as xc, dual_chain, i16_probe, v10_kernel, v11_kernel,
        v13_unroll2)
    for counts in xc.COUNTS.values():
        counts.reset()
    B, R, pad, nuc = xc.BENCH_B, xc.R, xc.PAD, pb.DEFAULT_NUC_PRIOR
    bound_ms, bound_by = pairhmm_bound(B, R, pad)
    rows = []

    def scorers():
        """library -> {variant: (kernel launch, wrapper call)}, each a
        function of kernel-layout CUDA tracks, for the v9 scorers."""
        out = {"exp_dual_chain": {
            f"K{K}": (lambda t, K=K: dual_chain.scores_dual_cuda(*t, K=K),
                      lambda t, K=K: dual_chain.scores_dual(*t, K=K))
            for K in dual_chain.KERNEL_K}}
        # v11: the new designs without a prologue (the entry point runs the
        # default); the first port's shfl variants with the wrapper's
        # prologue, pre made once for the kernel time
        out["exp_v11"] = {}
        last_pre = []                 # [ext track, its pre]

        def pre_of(t):
            if not last_pre or last_pre[0] is not t[4]:
                last_pre[:] = [t[4], v11_kernel.v11_pre(t[4])]
            return last_pre[1]

        for v in v11_kernel.VARIANTS:
            if v.startswith("shfl"):
                def kernel(t, v=v):
                    return v11_kernel.launch_v11(t, pre_of(t), pad=pad,
                                                 nuc_prior=nuc, variant=v)

                def call(t, v=v):
                    return v11_kernel.shfl_call(t, variant=v)
            else:
                def kernel(t, v=v):
                    return v11_kernel.launch_v11(t, pad=pad, nuc_prior=nuc,
                                                 variant=v)
                call = ((lambda t: v11_kernel.scores_v11(*t))
                        if v == v11_kernel.DEFAULT_VARIANT else kernel)
            out["exp_v11"][v] = (kernel, call)
        out["exp_v13"] = {}
        for v in v13_unroll2.VARIANTS:
            def kernel(t, v=v):
                return v13_unroll2.launch_v13(t, pad=pad, nuc_prior=nuc,
                                              variant=v)
            call = ((lambda t: v13_unroll2.scores_v13(*t))
                    if v == v13_unroll2.DEFAULT_VARIANT else kernel)
            out["exp_v13"][v] = (kernel, call)
        # v10: the Hopper designs on the raw tracks (the entry point runs
        # the default); the first port's tracks10 with the wrapper's
        # prologue, the ten tracks made once for the kernel time
        out["exp_v10"] = {}
        for v in v10_kernel.VARIANTS:
            if v.startswith("tracks10"):
                def kernel(t, v=v):
                    return v10_kernel.launch_v10(tracks10_of(t), pad=pad,
                                                 variant=v)

                def call(t, v=v):
                    return v10_kernel.tracks10_call(t, variant=v)
            else:
                def kernel(t, v=v):
                    return v10_kernel.launch_v10(t, pad=pad, nuc_prior=nuc,
                                                 variant=v)
                call = ((lambda t: v10_kernel.scores_v10(*t))
                        if v == v10_kernel.DEFAULT_VARIANT else kernel)
            out["exp_v10"][v] = (kernel, call)
        return out

    last_tracks10 = []            # [tracks, their prologue's ten]

    def tracks10_of(t):
        if not last_tracks10 or any(a is not b for a, b in
                                    zip(last_tracks10[0], t)):
            last_tracks10[:] = [list(t), v10_kernel.v10_tracks(*t,
                                                               nuc_prior=nuc)]
        return last_tracks10[1]

    def pairs_of(lib, variant, Bt):
        """The most pairs up to Bt that the variant's 128 K divides (K = 6
        takes 65,280 of the bench's pairs)."""
        K = (v13_unroll2.VARIANTS[variant][0] if lib == "exp_v13" else 1)
        return Bt - Bt % (xc.LANES * K)

    variants = scorers()
    # the edge inputs (EDGE_CASES) through every v10, v11 and v13 variant:
    # error 0 against the plain version and #1 on the same tracks
    edge = {}
    for rows_e, kind in xc.EDGE_CASES:
        t = xc.as_tracks(xc.edge_inputs(EDGE_B, rows_e, kind, seed=seed),
                         "cuda")
        one = pb.pairhmm_scores_cuda(*(a.t() for a in t), pad=pad)
        for lib in ("exp_v10", "exp_v11", "exp_v13"):
            want = (v10_kernel.v10_rows_plain(tracks10_of(t), pad=pad)
                    if lib == "exp_v10" else xc.plain_v9(t, pad, nuc))
            for variant, (kernel, _) in variants[lib].items():
                got = kernel(t)
                torch.cuda.synchronize()
                e = edge.setdefault((lib, variant), [0, 0, []])
                e[0] = max(e[0], int((got.long() - want.long()).abs().max()))
                e[1] = max(e[1], int((got.long() - one.long()).abs().max()))
                e[2].append(f"R{rows_e}_{kind}")

    # dual_chain's bench draws window bases from [0, 4), the others from
    # [0, 5) (N included)
    for win_hi, libs in ((4, ("exp_dual_chain",)),
                         (5, ("exp_v11", "exp_v13", "exp_v10"))):
        t = xc.bench_inputs(B, win_hi, seed=seed)
        bm = [a.t().contiguous() for a in t]       # #1's batch-major copies
        one = pb.pairhmm_scores_cuda(*bm, pad=pad)
        one_ms = cuda_ms(lambda: pb.launch_kernel(bm, pad=pad))
        one_call_ms = cuda_ms(lambda: pb.pairhmm_scores_cuda(*bm, pad=pad))
        plains = {}
        for lib in libs:
            for variant, (kernel, wrapper) in variants[lib].items():
                Bv = pairs_of(lib, variant, B)
                tk = t if Bv == B else [a[:, :Bv].contiguous() for a in t]
                key = (lib == "exp_v10", Bv)
                if key not in plains:
                    plain = ((lambda tk=tk: v10_kernel.v10_rows_plain(
                        tracks10_of(tk), pad=pad))
                             if lib == "exp_v10" else
                             (lambda tk=tk: xc.plain_v9(tk, pad, nuc)))
                    plains[key] = (plain(), cuda_ms(plain, reps=5))
                want, plain_ms = plains[key]
                got_k, got_w = kernel(tk), wrapper(tk)
                torch.cuda.synchronize()
                err = max(int((g.long() - want.long()).abs().max())
                          for g in (got_k, got_w))
                err_one = int((got_w.long() - one[:Bv].long()).abs().max())
                row = {"kernel": lib, "variant": variant, "B": Bv, "R": R,
                       "pad": pad, "max_abs_err": err,
                       "max_abs_err_vs_1": err_one,
                       "kernel_ms": cuda_ms(lambda: kernel(tk)),
                       "wrapper_ms": cuda_ms(lambda: wrapper(tk)),
                       "pairhmm_1_kernel_ms": one_ms,
                       "pairhmm_1_call_ms": one_call_ms,
                       "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by}
                if lib in ("exp_v10", "exp_v11", "exp_v13"):
                    # the base the redesigns are held to, timed right
                    # after the variant on the same tracks: walls drift
                    # ~10-20% between the phase's passes
                    for K in (1, 2):
                        row[f"dual_K{K}_kernel_ms"] = cuda_ms(
                            lambda K=K: dual_chain.scores_dual_cuda(*tk, K=K))
                row["m_pairs_per_s"] = Bv / row["wrapper_ms"] / 1e3
                if Bv != B:
                    row["bound_ms"], row["bound_by"] = pairhmm_bound(Bv, R, pad)
                if lib == "exp_v10":
                    # v10's own: 12 ops a cell, the tracks it reads
                    row.update(v10_bounds(Bv, R, pad,
                                          variant.startswith("tracks10")))
                row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
                if (lib, variant) in edge:
                    e_err, e_one, cases = edge[(lib, variant)]
                    row.update(edge_max_abs_err=e_err,
                               edge_max_abs_err_vs_1=e_one, edge_cases=cases,
                               edge_B=EDGE_B)
                    err = max(err, e_err, e_one)
                rows.append(row)
                if err or err_one:
                    raise AssertionError(f"kernel_experiments: {row}")
        del t, bm, plains
        last_tracks10.clear()
        torch.cuda.empty_cache()

    # the i16 probe: the experiment's own input, a wrapping one, the bench
    a = torch.ones((16, 128), dtype=torch.int16, device="cuda")
    probe_ok = int(i16_probe.run(a, a * 2)[0, 0]) == 51
    gen = torch.Generator(device="cuda").manual_seed(seed)
    wide = [torch.randint(-32768, 32767, (16, 4096), generator=gen,
                          device="cuda", dtype=torch.int16) for _ in range(2)]
    wide[1][:, ::3] = wide[0][:, ::3]
    a, b = i16_probe.bench_inputs(I16_SHAPE, seed=seed)
    elements = a.numel()
    ops = elements * (I16_OPS_PER_ROUND * i16_probe.ROUNDS + I16_OPS_ONCE)
    ops_one_ms = ops / INT32_OPS_PER_S * 1e3
    bytes_ms = 3 * 2 * elements / DRAM_BYTES_PER_S * 1e3
    want = i16_probe.kern_plain(a, b)
    want_wide = i16_probe.kern_plain(*wide)
    plain_ms = cuda_ms(lambda: i16_probe.kern_plain(a, b), reps=5)
    for pack in i16_probe.PACKS:
        err = max(int((i16_probe.run_cuda(x, y, pack=pack).int()
                       - w.int()).abs().max())
                  for x, y, w in ((a, b, want), (*wide, want_wide)))
        row = {"kernel": "exp_i16", "variant": f"pack{pack}",
               "shape": list(I16_SHAPE), "max_abs_err": err,
               "probe_out_0_0_is_51": probe_ok,
               "kernel_ms": cuda_ms(lambda: i16_probe.run_cuda(a, b,
                                                               pack=pack)),
               "wrapper_ms": cuda_ms(lambda: i16_probe.run(a, b, pack=pack)),
               "plain_ms": plain_ms,
               "ops_bound_one_a_lane_ms": ops_one_ms,
               "ops_bound_two_a_lane_ms": ops_one_ms / 2,
               "bytes_bound_ms": bytes_ms,
               "bound_ms": max(ops_one_ms / 2, bytes_ms),
               "bound_by": "operations" if ops_one_ms / 2 >= bytes_ms
               else "bytes"}
        rows.append(row)
        if err or not probe_ok:
            raise AssertionError(f"kernel_experiments: {row}")
    # each instantiation's registers and spills, and its code size in SASS
    # instructions (16 bytes each), against the instruction caches
    builds, sass = {}, {}
    for lib in EXPERIMENTS:
        sass[lib] = sass_functions(_build.BUILDS[lib]["path"])
        builds[lib] = {"nvcc_s": _build.BUILDS[lib]["seconds"],
                       "ptxas": ptxas_table(_build.BUILDS[lib]["log"], lib),
                       "sass_instructions": {template_key(f, lib): len(body)
                                             for f, body in sass[lib].items()}}
    # each scorer variant's build beside its times: registers, spills, SASS
    # size, its row loop's loads, what one SM holds
    for row in rows:
        build = exp_build(row["kernel"], row["variant"])
        if build is None:
            continue
        key, rows_an_iteration, pairs, (experiment, *query) = build
        lib = row["kernel"]
        ptx = builds[lib]["ptxas"][key]
        body = next(b for f, b in sass[lib].items()
                    if template_key(f, lib) == key)
        loop = sass_row_loop(body)
        loop.update(rows_an_iteration=rows_an_iteration,
                    pairs_a_thread=pairs)
        # a row of one pair: its 16 cells
        for k in ("instructions", "lds", "ldg"):
            loop[f"{k}_a_pair_row"] = loop[k] / (rows_an_iteration * pairs)
        row.update(registers=ptx["registers"],
                   spill_bytes=ptx["spill_store_bytes"]
                   + ptx["spill_load_bytes"],
                   stack_frame_bytes=ptx["stack_frame_bytes"],
                   sass_instructions=len(body),
                   sass=sass_counts(mnemonic(t) for _, t in body
                                    if not t.startswith("@!PT")),
                   row_loop=loop, **xc.occupancy(experiment, *query))
    launches = exp_launches()
    emit({"phase": "kernel_experiments", "rows": rows, "builds": builds,
          "i16_sass": i16_sass(sass["exp_i16"]), "launches": launches})
    # from here on the counts are the product paths' (read in main)
    for counts in xc.COUNTS.values():
        counts.reset()
    return rows, launches


def exp_launches() -> dict:
    """library -> this process's launches of each kernel experiment since
    its counts were last set to 0."""
    from octopus_tpu_torch.kernel_experiments import _common as xc
    return {f"exp_{n}": c.launches for n, c in xc.COUNTS.items()}


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def propose_windows(read_begins, n):
    """Windows sized by read count from 16 kb density bins, as the CLI's
    propose_windows does from a BAI (target 5000 reads, at least 5 kb)."""
    density = np.bincount(read_begins // WINDOW_BIN,
                          minlength=n // WINDOW_BIN + 1)
    out, pos = [], 0
    while pos < n:
        acc, cur = 0.0, pos
        while cur < n and acc < WINDOW_TARGET_READS:
            b = cur // WINDOW_BIN
            acc += density[b] if b < len(density) else 0.0
            cur = min((b + 1) * WINDOW_BIN, n)
        cur = max(cur, pos + WINDOW_MIN)
        out.append((pos, min(cur, n)))
        pos = min(cur, n)
    return out


def call_sample(reference, batch, windows, config):
    """Records of every window, as the CLI's window loop makes them
    (without the read pipe and call set refinement)."""
    from octopus_tpu_torch.core.callers.individual import IndividualCaller
    from octopus_tpu_torch.core.tools.vcf_record_factory import (
        annotate_read_stats, apply_spanning_alleles, site_call_to_record)
    caller = IndividualCaller(reference, "chr1", config)
    lines = []
    for begin, end in windows:
        reads = batch.overlapping(max(begin - READ_PAD, 0), end + READ_PAD)
        if not len(reads):
            continue
        calls = [c for c in caller.call(begin, end, [reads]) if c.begin < end]
        pairs = [(c, site_call_to_record(c, "chr1", reference)) for c in calls]
        annotate_read_stats(pairs, [reads])
        apply_spanning_alleles(pairs)
        lines.extend(r.to_line() for _, r in pairs)
    return lines


def accuracy(lines, truth, tol=5):
    """Recall and precision by position within `tol` bases, as the repo's
    end-to-end benchmark scores calls against the simulated truth."""
    called = []
    for line in lines:
        f = line.split("\t")
        if f[6] == "PASS":
            called.append(int(f[1]) - 1)
    t = np.asarray(sorted(truth))

    def near(points, targets):
        if not len(points) or not len(targets):
            return 0
        ts = np.asarray(sorted(targets))
        ps = np.asarray(points)
        j = np.searchsorted(ts, ps)
        hit = np.zeros(len(ps), bool)
        for off in (-1, 0):
            k = np.clip(j + off, 0, len(ts) - 1)
            hit |= np.abs(ts[k] - ps) <= tol
        return int(hit.sum())

    called_set = sorted(set(called) | {p + 1 for p in called})
    recall = near(t, called_set) / max(len(t), 1)
    precision = near(called, t) / max(len(called), 1)
    return recall, precision


# kernel -> its launcher in pairhmm_batch (both take batch-major tracks)
LAUNCHERS = {"pairhmm": "launch_kernel", "pairhmm_lanes": "launch_lanes"}


@contextlib.contextmanager
def kept_launches(pb, into, kernel="pairhmm", la=None):
    """Keeps a copy of every launch of `kernel` in `into`: (tracks, pad,
    nuc_prior, scores, source), where source is the likelihood array's
    ("populate" or "assignment") when `la` is given."""
    name = LAUNCHERS[kernel]
    launch = getattr(pb, name)
    source = [None]

    def keeping(tracks, *, pad, nuc_prior=pb.DEFAULT_NUC_PRIOR, **variant):
        out = launch(tracks, pad=pad, nuc_prior=nuc_prior, **variant)
        into.append(([t.clone() for t in tracks], pad, nuc_prior, out.clone(),
                     source[0]))
        return out

    setattr(pb, name, keeping)
    if la is not None:
        scores = la.HaplotypeLikelihoodArray._device_scores

        def tagged(self, *args, **kwargs):
            source[0] = self.source
            return scores(self, *args, **kwargs)

        la.HaplotypeLikelihoodArray._device_scores = tagged
    try:
        yield
    finally:
        setattr(pb, name, launch)
        if la is not None:
            la.HaplotypeLikelihoodArray._device_scores = scores


# pairs a plain-twin call of check_launches holds at most
CHECK_PAIRS = 1 << 16


def check_launches(pb, kept, phase, kernel="pairhmm"):
    """Every kept launch's scores against the kernel's plain twin on the
    same CUDA tensors; each launch timed alone, and all of them replayed,
    against their bounds, per source. The plain twin scores each pair on
    its own, so launches of one shape are checked in one call of up to
    CHECK_PAIRS pairs, their tracks concatenated."""
    import torch
    plain = {"pairhmm": pb.pairhmm_scores_plain,
             "pairhmm_lanes": pb.pairhmm_scores_lanes_plain}[kernel]
    launch = getattr(pb, LAUNCHERS[kernel])
    err = 0
    same_shape = collections.defaultdict(list)
    for tracks, pad, nuc_prior, got, _ in kept:
        same_shape[(tracks[0].shape[1], pad, nuc_prior)].append((tracks, got))
    for (_, pad, nuc_prior), launches in same_shape.items():
        group, pairs = [], 0
        for i, (tracks, got) in enumerate(launches):
            group.append((tracks, got))
            pairs += tracks[0].shape[0]
            if pairs < CHECK_PAIRS and i + 1 < len(launches):
                continue
            want = plain(*(torch.cat(t) for t in zip(*(g[0] for g in group))),
                         pad=pad, nuc_prior=nuc_prior)
            got = torch.cat([g[1] for g in group])
            err = max(err, int((got.long() - want.long()).abs().max()))
            group, pairs = [], 0
    by_source = collections.defaultdict(list)
    for tracks, pad, nuc_prior, got, source in kept:
        B, R = tracks[0].shape
        ms = cuda_ms(lambda: launch(tracks, pad=pad, nuc_prior=nuc_prior),
                     reps=3)
        by_source[source].append((B, R, pad, ms, pairhmm_bound(B, R, pad)[0],
                                  chosen_variant(pb, kernel, B, pad)))
    if err != 0:
        raise AssertionError(f"{phase}: {kernel} launches differ from the "
                             f"plain twin by {err}")

    def replay():
        for tracks, pad, nuc_prior, _, _ in kept:
            launch(tracks, pad=pad, nuc_prior=nuc_prior)

    summary = {}
    for source, rows in sorted(by_source.items(), key=str):
        Bs = [r[0] for r in rows]
        ms = [r[3] for r in rows]
        summary[str(source)] = {
            "launches": len(rows), "pairs": sum(Bs),
            "B_min": min(Bs), "B_median": statistics.median(Bs),
            "B_max": max(Bs),
            "shapes": dict(collections.Counter(
                f"R{r[1]}_pad{r[2]}" for r in rows)),
            "launch_ms_min": min(ms), "launch_ms_median": statistics.median(ms),
            "launch_ms_max": max(ms), "launch_ms_sum": sum(ms),
            "bound_ms_sum": sum(r[4] for r in rows),
            "variants": dict(collections.Counter(r[5] for r in rows)),
            "largest_launch": max(rows)[:4]}
    emit({"phase": phase, "kernel": kernel, "launches": len(kept),
          "max_abs_err": err, "by_source": summary,
          "kernel_ms_all": cuda_ms(replay),
          "bound_ms_all": sum(v["bound_ms_sum"] for v in summary.values())})
    return err


def phase_main_path(device="cuda", kb=REGION_KB):
    import torch
    from octopus_tpu_torch.basics.reads import make_read_batch
    from octopus_tpu_torch.core.callers.base import BaseCallerConfig
    from octopus_tpu_torch.core.likelihood import likelihood_array as la
    from octopus_tpu_torch.core.likelihood import pairhmm_batch as pb
    from octopus_tpu_torch.core.models import genotype_likelihoods as gl
    from octopus_tpu_torch.io.fasta import InMemoryReference, ReferenceGenome
    from octopus_tpu_torch.utils import timers
    from octopus_tpu_torch.utils.synthetic import simulate_diploid_reads

    seq, read_tuples, truth, n = simulate_diploid_reads(
        kb=kb, depth=DEPTH, read_len=READ_LEN, seed=SEED,
        spacing=(600, 1800), err=0.001)
    batch = make_read_batch("chr1", read_tuples).sorted_by_begin()
    reference = ReferenceGenome(InMemoryReference({"chr1": seq}))
    windows = propose_windows(batch.begins, n)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def config_at(host_max):
        config = BaseCallerConfig(device=device)
        config.likelihood = dataclasses.replace(config.likelihood,
                                                host_hmm_max=host_max)
        return config

    # An untimed all-kernel run, which also pays the first-use costs (lazy
    # imports, memo tables): every launch's scores are held against the
    # plain version on the same tensors.
    kept = []
    with kept_launches(pb, kept):
        checked_lines = call_sample(reference, batch, windows, config_at(0))
    err = 0
    if device == "cuda":
        if not kept:
            raise AssertionError("the checked all-kernel run never launched "
                                 "the kernel")
        err = check_launches(pb, kept, "main_path_launches")
    timers.enabled = True
    runs = [("checked", checked_lines, len(kept))]
    # in turns, so that neither routing gains from running second
    for label, host_max in (("default_gate", 384), ("all_kernel", 0),
                            ("all_kernel", 0), ("default_gate", 384)):
        config = config_at(host_max)
        la._PENALTY_CACHE.clear()
        timers.reset()
        pb.COUNTS.reset()
        la.ROUTING.reset()
        gl.COUNTS.reset()
        sync()
        t0 = time.perf_counter()
        lines = call_sample(reference, batch, windows, config)
        sync()
        wall = time.perf_counter() - t0
        launches = pb.COUNTS.launches
        recall, precision = accuracy(lines, truth)
        runs.append((label, lines, launches))
        emit({"phase": "main_path", "run": label, "host_hmm_max": host_max,
              "device": device, "region_kb": kb, "depth": DEPTH,
              "reads": len(batch), "windows": len(windows), "wall_s": wall,
              "kernel_launches": launches,
              "kernel_pairs": pb.COUNTS.pairs,
              "job_sets_host": la.ROUTING.host_job_sets,
              "pairs_host": la.ROUTING.host_pairs,
              "job_sets_card": la.ROUTING.device_job_sets,
              "pairs_card": la.ROUTING.device_pairs,
              "genotype_reductions_host": gl.COUNTS.host,
              "genotype_reductions_card": gl.COUNTS.device,
              "phase_s": timers.totals(),
              "records": len(lines), "truth": len(truth),
              "recall": recall, "precision": precision})
        if recall < 0.95 or precision < 0.95:
            raise AssertionError(f"{label}: recall {recall} precision {precision}")
        if host_max == 0 and device == "cuda" and launches == 0:
            raise AssertionError("the all-kernel run never launched the kernel")
    timers.enabled = False
    if any(lines != runs[0][1] for _, lines, _ in runs):
        raise AssertionError("default-gate and all-kernel records differ")
    all_kernel_launches = next(n for label, _, n in runs if label == "all_kernel")
    return all_kernel_launches, err


# ---------------------------------------------------------------------------
# phase 4: the CLI
# ---------------------------------------------------------------------------

CLI_ENV_KEYS = ("OCTOPUS_TPU_HOST_HMM_MAX", "OCTOPUS_TPU_UNROLLED_HMM",
                "OCTOPUS_TPU_HOST_LATENTS", "OCTOPUS_TPU_VB_DEVICE_MIN",
                "OCTOPUS_TPU_DEFER_HEAVY_AT")
# label -> (environment, the kernel its gate-0 job sets must launch)
CLI_RUNS = {
    "default_gate": ({}, None),
    "gate0": ({"OCTOPUS_TPU_HOST_HMM_MAX": "0"}, "pairhmm"),
    "gate0_lanes": ({"OCTOPUS_TPU_HOST_HMM_MAX": "0",
                     "OCTOPUS_TPU_UNROLLED_HMM": "1"}, "pairhmm_lanes"),
}


def phase_cli(device="cuda", kb=CLI_REGION_KB, tmp=None):
    """The port CLI on a simulated BAM: untimed checked runs at gate 0 for
    each kernel, then timed runs in turns. Returns (launches of each kernel
    in its timed gate-0 run, max_abs_err of each kernel's kept launches,
    the input: fa, bam, truth, kb and `serial`, the output of the timed
    default-gate run). The files go to `tmp`, which the caller then owns,
    else to a directory removed on return. device="cpu" rehearses the
    phase with the plain twins."""
    import os
    import shutil
    import tempfile
    import torch
    from octopus_tpu_torch import cli
    from octopus_tpu_torch.core.csr import measures
    from octopus_tpu_torch.core.likelihood import likelihood_array as la
    from octopus_tpu_torch.core.likelihood import pairhmm_batch as pb
    from octopus_tpu_torch.core.models import genotype_likelihoods as gl
    from octopus_tpu_torch.utils import timers
    from octopus_tpu_torch.utils.synthetic import simulate_diploid

    owned = tmp is None
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_") if owned else tmp
    try:
        t0 = time.perf_counter()
        fa, bam, truth, n = simulate_diploid(
            tmp, kb=kb, depth=DEPTH, read_len=READ_LEN, seed=SEED,
            spacing=(600, 1800), err=0.001)
        emit({"phase": "cli_input", "region_kb": kb, "depth": DEPTH,
              "read_len": READ_LEN, "truth": len(truth),
              "bam_bytes": os.path.getsize(bam),
              "simulate_and_write_s": time.perf_counter() - t0})

        sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

        def run(label, timed):
            env, kernel = CLI_RUNS[label]
            scorer = (kernel if device == "cuda" or kernel is None
                      else kernel + "_plain")
            for k in CLI_ENV_KEYS:
                os.environ.pop(k, None)
            os.environ.update(env)
            la._PENALTY_CACHE.clear()
            timers.reset()
            for counts in pb.KERNEL_COUNTS.values():
                counts.reset()
            la.ROUTING.reset()
            gl.COUNTS.reset()
            misses = measures.FACET_MISSES
            out = os.path.join(tmp, f"{label}_{'timed' if timed else 'checked'}.vcf")
            sync()
            t = time.perf_counter()
            rc = cli.main(["-R", fa, "-I", bam, "-o", out, "--device", device,
                           "--benchmark"])
            sync()
            wall = time.perf_counter() - t
            if rc != 0:
                raise AssertionError(f"cli {label}: exit code {rc}")
            with open(out) as fh:
                lines = [line.rstrip("\n") for line in fh
                         if not line.startswith("#")]
            recall, precision = accuracy(lines, truth)
            phase_s = timers.totals()
            row = {"phase": "cli", "run": label, "timed": timed,
                   "device": device,
                   "wall_s": wall, "wall_s_per_kb": wall / kb,
                   "launches": {k: c.launches
                                for k, c in pb.KERNEL_COUNTS.items()},
                   "pairs": {k: c.pairs for k, c in pb.KERNEL_COUNTS.items()},
                   "job_sets": {f"{src}/{sc}": v for (src, sc), v
                                in sorted(la.ROUTING.job_sets.items())},
                   "route_pairs": {f"{src}/{sc}": v for (src, sc), v
                                   in sorted(la.ROUTING.pairs.items())},
                   "genotype_reductions_host": gl.COUNTS.host,
                   "genotype_reductions_card": gl.COUNTS.device,
                   "facet_misses": measures.FACET_MISSES - misses,
                   "phase_s": phase_s,
                   "read_assignment_share": (phase_s.get("read_assignment", 0.0)
                                             / wall),
                   "records": len(lines),
                   "pass_records": sum(line.split("\t")[6] == "PASS"
                                       for line in lines),
                   "recall": recall, "precision": precision}
            emit(row)
            if recall < 0.95 or precision < 0.95:
                raise AssertionError(f"cli {label}: recall {recall} "
                                     f"precision {precision}")
            if row["facet_misses"]:
                raise AssertionError(f"cli {label}: {row['facet_misses']} "
                                     "facet misses")
            if scorer is not None:
                for src in ("populate", "assignment"):
                    if not la.ROUTING.job_sets[(src, scorer)]:
                        raise AssertionError(f"cli {label}: {scorer} never "
                                             f"ran from {src}")
                others = [k for k, c in pb.KERNEL_COUNTS.items()
                          if k != scorer and c.launches]
                if others:
                    raise AssertionError(f"cli {label}: launched {others}")
            return lines, row

        errs = {}
        runs = []
        for label in ("gate0", "gate0_lanes"):
            kernel = CLI_RUNS[label][1]
            kept = []
            with kept_launches(pb, kept, kernel, la):
                lines, _ = run(label, timed=False)
            runs.append(lines)
            if device == "cuda":
                errs[kernel] = check_launches(pb, kept, "cli_launches", kernel)
        launches = {}
        # in turns, so that no routing gains from running later
        for label in ("default_gate", "gate0", "gate0_lanes", "default_gate"):
            lines, row = run(label, timed=True)
            runs.append(lines)
            kernel = CLI_RUNS[label][1]
            if kernel is not None:
                launches[kernel] = row["launches"][kernel]
        if any(lines != runs[0] for lines in runs):
            raise AssertionError("cli runs wrote different records")
        return launches, errs, {
            "fa": fa, "bam": bam, "truth": truth, "kb": kb,
            "serial": os.path.join(tmp, "default_gate_timed.vcf")}
    finally:
        for k in CLI_ENV_KEYS:
            os.environ.pop(k, None)
        if owned:
            shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 6: the VB size gate
# ---------------------------------------------------------------------------

# the card's VB evaluations must equal the CPU's bit for bit (vb_math)
VB_TOL = 0.0
VB_SWEEP_READS = (128,)
VB_SWEEP_GENOTYPES = (1, 4, 16, 64, 256, 1024, 4096)


def vb_close(got, want, tol=VB_TOL) -> float:
    """Largest error of `got` against `want`, relative where |want| > 1; it
    must not exceed tol."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if not want.size:
        return 0.0
    return float((np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max())


def phase_vb_gate_sweep(reps=7, host_budget_s=5.0):
    """SubcloneModel.evaluate on CPU torch and on the card (copies in and
    out included, numpy in and out as the callers call it), K = 3, 2 seeds,
    40 iterations, the cancer caller's tumour concentrations. Host-clock
    medians of `reps` runs each, host and card in turns; the host stops
    early once its runs of a size have taken `host_budget_s` (one run of
    4096 genotypes takes ~7 s there), and the row says how
    many it made. The crossover is the least count of real elements
    G*S*K*N from which the card is faster at every larger size."""
    import os
    from octopus_tpu_torch.core.models import subclone_vb as vb
    rng = np.random.default_rng(SEED + 2)
    K, S, n_iter, H = 3, 2, 40, 6
    a0 = np.asarray([1.5, 1.5, 1.0], np.float32)
    rows = []
    os.environ["OCTOPUS_TPU_VB_DEVICE_MIN"] = "0"
    try:
        for N in VB_SWEEP_READS:
            lnL = -rng.exponential(2.0, (H, N))
            lnL[rng.integers(0, H, N), np.arange(N)] = -0.05
            for G in VB_SWEEP_GENOTYPES:
                tuples = np.stack([rng.choice(H, K, replace=False)
                                   for _ in range(G)])
                models = {d: vb.SubcloneModel(n_seeds=S, n_iter=n_iter,
                                              device=d)
                          for d in ("cpu", "cuda")}

                def run(d):
                    return models[d].evaluate(tuples, lnL, alpha0_vec=a0)

                run("cuda")                          # first use
                times = {"cpu": [], "cuda": []}
                out = {}
                for _ in range(reps):
                    for d in ("cpu", "cuda"):
                        if d == "cpu" and sum(times[d]) > host_budget_s * 1e3:
                            continue
                        t0 = time.perf_counter()
                        out[d] = run(d)
                        times[d].append((time.perf_counter() - t0) * 1e3)
                err = max(vb_close(out["cuda"].genotype_log_evidences,
                                   out["cpu"].genotype_log_evidences),
                          vb_close(out["cuda"].map_alphas,
                                   out["cpu"].map_alphas))
                if err > VB_TOL:
                    raise AssertionError(f"vb_gate_sweep G={G} N={N}: card "
                                         f"and CPU differ by {err}")
                rows.append({"G": G, "N": N, "elements": G * S * K * N,
                             "host_ms": statistics.median(times["cpu"]),
                             "card_ms": statistics.median(times["cuda"]),
                             "host_runs": len(times["cpu"]),
                             "max_rel_err": err})
    finally:
        os.environ.pop("OCTOPUS_TPU_VB_DEVICE_MIN", None)
    rows.sort(key=lambda r: r["elements"])
    crossover = next((r["elements"] for i, r in enumerate(rows)
                      if all(x["card_ms"] < x["host_ms"] for x in rows[i:])),
                     None)
    emit({"phase": "vb_gate_sweep", "K": K, "seeds": S, "n_iter": n_iter,
          "rows": rows, "crossover_elements": crossover,
          "gate_elements": vb.VB_DEVICE_MIN})
    return crossover


# ---------------------------------------------------------------------------
# phases 7 and 8: the VB callers through the CLI
# ---------------------------------------------------------------------------

CANCER_KB = 100
CANCER_DEPTH = 60
CANCER_SEED = 7
CANCER_VAF = 0.25
VB_GATES = {"default_gates": {},
            "gates0": {"OCTOPUS_TPU_HOST_HMM_MAX": "0",
                       "OCTOPUS_TPU_VB_DEVICE_MIN": "0"}}


@contextlib.contextmanager
def kept_vb(into):
    """Keeps every VB evaluation (engine name, CPU copies of its inputs and
    of its outputs) in `into`."""
    from octopus_tpu_torch.core.models import mixture_mixture_vb as mm
    from octopus_tpu_torch.core.models import subclone_vb as vb
    engines = [(vb, "vb_subclone"), (mm, "vb_mixture_mixture")]
    real = [getattr(mod, name) for mod, name in engines]

    def keeping(fn, name):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            into.append((name, [a.cpu().clone() if hasattr(a, "cpu") else a
                                for a in args], kwargs,
                         [o.cpu().clone() for o in out],
                         str(out[0].device)))
            return out
        return run

    for (mod, name), fn in zip(engines, real):
        setattr(mod, name, keeping(fn, name))
    try:
        yield
    finally:
        for (mod, name), fn in zip(engines, real):
            setattr(mod, name, fn)


# genotype rows of a subclone evaluation that check_vb runs again on the
# CPU: all up to this many, else the first and last half of it
VB_CHECK_ROWS = 2048


def check_vb(kept, phase):
    """Every kept evaluation run again on the CPU: ELBO, Dirichlet
    parameters and responsibilities equal bit for bit (VB_TOL = 0).
    Genotype rows are independent and vb_math reduces each in a fixed
    order, so a subclone evaluation of more than VB_CHECK_ROWS rows (the
    cancer caller's somatic tuples of a dense region reach 31,002, ~1 min
    on the host) is checked on its first and last VB_CHECK_ROWS / 2."""
    import torch
    from octopus_tpu_torch.core.models import mixture_mixture_vb as mm
    from octopus_tpu_torch.core.models import subclone_vb as vb
    engines = {"vb_subclone": vb.vb_subclone,
               "vb_mixture_mixture": mm.vb_mixture_mixture}
    errs = collections.defaultdict(float)
    devices = collections.Counter()
    sampled = 0
    for name, args, kwargs, outs, device in kept:
        devices[device] += 1
        if name == "vb_subclone" and args[0].shape[0] > VB_CHECK_ROWS:
            half = VB_CHECK_ROWS // 2
            rows = torch.cat([torch.arange(half),
                              torch.arange(args[0].shape[0] - half,
                                           args[0].shape[0])])
            args = [args[0][rows], *args[1:]]
            outs = [o[rows] for o in outs]
            sampled += 1
        want = engines[name](*args, **kwargs)
        for i, (g, w) in enumerate(zip(outs, want)):
            prob = (name, i) in (("vb_subclone", 2), ("vb_mixture_mixture", 1))
            e = (float((g - w).abs().max()) if prob and g.numel()
                 else vb_close(g.numpy(), w.numpy()))
            errs[f"{name}/{i}"] = max(errs[f"{name}/{i}"], e)
    worst = max(errs.values(), default=0.0)
    emit({"phase": phase, "evaluations": len(kept),
          "devices": dict(devices), "row_sampled": sampled,
          "max_err": dict(errs), "tol": VB_TOL})
    if worst > VB_TOL:
        raise AssertionError(f"{phase}: card VB differs from the CPU's by "
                             f"{worst}")
    return worst


def reset_counts():
    """Every pair-HMM kernel's counts, the routing and the pool at 0, the
    likelihood array's penalty cache empty."""
    from octopus_tpu_torch import run
    from octopus_tpu_torch.core.likelihood import likelihood_array as la
    from octopus_tpu_torch.core.likelihood import pairhmm_batch as pb
    for counts in pb.KERNEL_COUNTS.values():
        counts.reset()
    la.ROUTING.reset()
    la._PENALTY_CACHE.clear()
    run.POOL.reset()


def read_counts() -> dict:
    """Launches, pairs and longest rows of each kernel since reset_counts,
    the job sets by (source, scorer) and the pool's windows."""
    from octopus_tpu_torch import run
    from octopus_tpu_torch.core.likelihood import likelihood_array as la
    from octopus_tpu_torch.core.likelihood import pairhmm_batch as pb
    return {"launches": {k: c.launches for k, c in pb.KERNEL_COUNTS.items()},
            "pairs": {k: c.pairs for k, c in pb.KERNEL_COUNTS.items()},
            "max_rows": {k: c.max_rows for k, c in pb.KERNEL_COUNTS.items()},
            "job_sets": {f"{src}/{sc}": v for (src, sc), v
                         in sorted(la.ROUTING.job_sets.items())},
            "pool": dataclasses.asdict(run.POOL)}


def caller_vcf(tmp, label, timed):
    """The VCF that run_caller_cli writes for a run."""
    import os
    return os.path.join(tmp, f"{label}_{'timed' if timed else 'checked'}.vcf")


def run_caller_cli(tmp, phase, label, argv, env, device, timed,
                   sources=("populate", "assignment")):
    """One CLI run: the environment set, every counter reset; returns
    (record lines, the JSON row). On the card, a run with the host-DP gate
    at 0 must launch its kernel (#3 under OCTOPUS_TPU_UNROLLED_HMM, else
    #1) from each of `sources`, and one with the VB gate at 0 must run
    every VB evaluation there."""
    import os
    import torch
    from octopus_tpu_torch import cli
    from octopus_tpu_torch.core.csr import measures
    from octopus_tpu_torch.core.likelihood import likelihood_array as la
    from octopus_tpu_torch.core.likelihood import pairhmm_batch as pb
    from octopus_tpu_torch.core.models import genotype_likelihoods as gl
    from octopus_tpu_torch.core.models import subclone_vb as vb
    from octopus_tpu_torch.utils import timers
    for k in CLI_ENV_KEYS:
        os.environ.pop(k, None)
    os.environ.update(env)
    reset_counts()
    timers.reset()
    gl.COUNTS.reset()
    vb.COUNTS.reset()
    misses = measures.FACET_MISSES
    out = caller_vcf(tmp, label, timed)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    t = time.perf_counter()
    rc = cli.main([*argv, "-o", out, "--device", device, "--benchmark"])
    sync()
    wall = time.perf_counter() - t
    if rc != 0:
        raise AssertionError(f"{label}: exit code {rc}")
    with open(out) as fh:
        lines = [line.rstrip("\n") for line in fh if not line.startswith("#")]
    phase_s = timers.totals()
    row = {"phase": phase, "run": label, "timed": timed, "device": device,
           "wall_s": wall,
           "phase_s": phase_s,
           "launches": {k: c.launches for k, c in pb.KERNEL_COUNTS.items()},
           "pairs": {k: c.pairs for k, c in pb.KERNEL_COUNTS.items()},
           "job_sets": {f"{src}/{sc}": v for (src, sc), v
                        in sorted(la.ROUTING.job_sets.items())},
           "genotype_reductions_host": gl.COUNTS.host,
           "genotype_reductions_card": gl.COUNTS.device,
           "vb_evaluations_host": vb.COUNTS.host,
           "vb_evaluations_card": vb.COUNTS.device,
           "vb_elements_host": vb.COUNTS.host_elements,
           "vb_elements_card": vb.COUNTS.device_elements,
           "facet_misses": measures.FACET_MISSES - misses,
           "records": len(lines),
           "pass_records": sum(line.split("\t")[6] == "PASS"
                               for line in lines)}
    if device == "cuda" and env.get("OCTOPUS_TPU_HOST_HMM_MAX") == "0":
        scorer = ("pairhmm_lanes" if env.get("OCTOPUS_TPU_UNROLLED_HMM")
                  else "pairhmm")
        for src in sources:
            if not la.ROUTING.job_sets[(src, scorer)]:
                raise AssertionError(f"{label}: {scorer} never ran from "
                                     f"{src}")
    if device == "cuda" and env.get("OCTOPUS_TPU_VB_DEVICE_MIN") == "0":
        if not vb.COUNTS.device or vb.COUNTS.host:
            raise AssertionError(f"{label}: VB ran {vb.COUNTS.host} times on "
                                 f"the host, {vb.COUNTS.device} on the card")
    return lines, row


def somatic_lines(lines, somatic=True):
    return [line for line in lines
            if ("SOMATIC" in line.split("\t")[7].split(";")) == somatic]


def phase_cancer_cli(device="cuda", kb=CANCER_KB):
    """The cancer caller through the CLI on the cancer mode of
    octopus_tpu_torch.bench_e2e_multi (its input, and its accuracy line
    for the timed default-gates run): an untimed checked run with both
    gates at 0, then a timed run at the default gates. Returns (the
    launches of kernel #1 in the gates-0 run, the kept launches' and
    evaluations' largest errors). device="cpu" rehearses the phase (no kernel, no card
    VB)."""
    import os
    import shutil
    import tempfile
    from octopus_tpu_torch import bench_e2e_multi
    from octopus_tpu_torch.core.likelihood import likelihood_array as la
    from octopus_tpu_torch.core.likelihood import pairhmm_batch as pb

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cancer_")
    try:
        t0 = time.perf_counter()
        fa, (bam_n, bam_t), (germline, somatic) = (
            bench_e2e_multi.cancer_input(tmp, kb=kb, depth=CANCER_DEPTH,
                                         seed=CANCER_SEED, vaf=CANCER_VAF))
        emit({"phase": "cancer_cli_input", "region_kb": kb,
              "tumour_depth": CANCER_DEPTH, "normal_depth": CANCER_DEPTH // 2,
              "vaf": CANCER_VAF, "germline": len(germline),
              "somatic": len(somatic),
              "bam_bytes": os.path.getsize(bam_n) + os.path.getsize(bam_t),
              "simulate_and_write_s": time.perf_counter() - t0})
        argv = ["-R", fa, "-I", bam_n, bam_t, "--caller", "cancer",
                "--normal-sample", "NORMAL"]

        def run(label, timed):
            lines, row = run_caller_cli(tmp, "cancer_cli", label, argv,
                                        VB_GATES[label], device, timed)
            germ_r, germ_p = accuracy(somatic_lines(lines, False), germline)
            som_r, som_p = accuracy(somatic_lines(lines, True), somatic)
            row.update({
                "region_kb": kb,
                "wall_s_per_kb": row["wall_s"] / kb,
                "somatic_pass_records": sum(
                    line.split("\t")[6] == "PASS"
                    for line in somatic_lines(lines, True)),
                "germline_recall": germ_r, "germline_precision": germ_p,
                "somatic_recall": som_r, "somatic_precision": som_p})
            emit(row)
            if min(germ_r, germ_p) < 0.95 or min(som_r, som_p) < 0.9:
                raise AssertionError(f"cancer_cli {label}: germline {germ_r} "
                                     f"{germ_p}, somatic {som_r} {som_p}")
            return lines, row

        kept, kept_evals = [], []
        with kept_launches(pb, kept, "pairhmm", la), kept_vb(kept_evals):
            checked, row = run("gates0", timed=False)
        launches = row["launches"]["pairhmm"]
        errs = {}
        if device == "cuda":
            errs["pairhmm"] = check_launches(pb, kept, "cancer_cli_launches")
            errs["vb"] = check_vb(kept_evals, "cancer_cli_vb")
        lines, row = run("default_gates", timed=True)
        # the bench module's accuracy line for this run
        print(json.dumps(bench_e2e_multi.cancer_result(
            caller_vcf(tmp, "default_gates", True), (germline, somatic), kb,
            CANCER_DEPTH, row["wall_s"], CANCER_VAF)), flush=True)
        if lines != checked:
            raise AssertionError("cancer_cli runs wrote different records")
        return launches, errs
    finally:
        for k in CLI_ENV_KEYS:
            os.environ.pop(k, None)
        shutil.rmtree(tmp, ignore_errors=True)


def near_all(lines, targets, tol=5):
    called = [int(line.split("\t")[1]) - 1 for line in lines]
    return all(any(abs(t - p) <= tol for p in called) for t in targets)


def phase_vb_sample_cli(kind, device="cuda"):
    """The polyclone or cell caller through the CLI on the BAMs of
    tests/test_e2e_polyclone_cell.py, once with both gates at 0; every VB
    evaluation held against the CPU's; those tests' truth checks."""
    import os
    import shutil
    import tempfile
    from octopus_tpu_torch.utils import synthetic

    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{kind}_")
    try:
        if kind == "polyclone":
            fa, bam, trunk, private, n = synthetic.simulate_polyclone(tmp)
            bams, truth = [bam], trunk + list(private)
            args = ["--caller", "polyclone", "--organism-ploidy", "1",
                    "--max-clones", "4"]
        else:
            fa, bams, truth, som, n = synthetic.simulate_cells(tmp)
            args = ["--caller", "cell", "--max-phylogeny-size", "2"]
        kept = []
        with kept_vb(kept):
            lines, row = run_caller_cli(
                tmp, f"{kind}_cli", "gates0",
                ["-R", fa, "-I", *bams, "-T", "chr1", *args],
                VB_GATES["gates0"], device, timed=True)
        called = [line for line in lines if line.split("\t")[4] != "."]
        row.update({"region_kb": n / 1000,
                    "samples": len(bams), "truth": len(truth),
                    "truth_called": near_all(called, truth)})
        ok = row["truth_called"]
        if kind == "cell":
            carriers = [line for line in somatic_lines(called)
                        if abs(int(line.split("\t")[1]) - 1 - som) <= 5]
            info = (dict(kv.split("=") for kv in carriers[0].split("\t")[7]
                         .split(";") if "=" in kv) if carriers else {})
            row["somatic_cells"] = int(info.get("CELLS", -1))
            ok = ok and 1 <= row["somatic_cells"] <= 5
        emit(row)
        if device == "cuda":
            check_vb(kept, f"{kind}_cli_vb")
        if not ok:
            raise AssertionError(f"{kind}_cli: truth check failed: {row}")
        return row
    finally:
        for k in CLI_ENV_KEYS:
            os.environ.pop(k, None)
        shutil.rmtree(tmp, ignore_errors=True)


# octopus_tpu_torch.bench_e2e_multi's population and trio modes, uncut: 100
# kb, three samples at 30x, the modes' own seeds and CLI arguments
MULTI_KB = 100
MULTI_DEPTH = 30
MULTI = ("population", "trio")
# what the reference CLI (octopus_tpu, JAX on the CPU) reaches on the same
# BAMs, by bench_e2e_multi.py's own measures, which round to 4 places
# (`JAX_PLATFORMS=cpu python bench_e2e_multi.py population|trio 100 30`):
# 60 of 61 population sites, no false positive, every genotype right; all 10
# de novo SNVs flagged and none else, 1 of them PASS at 30x, every germline
# site called
MULTI_BARS = {"population": {"recall": round(60 / 61, 4), "fp": 0,
                             "gt_concordance": 1.0},
              "trio": {"caller_denovo_recall": 1.0, "caller_denovo_fp": 0,
                       "denovo_recall": 0.1, "denovo_fp": 0,
                       "germline_recall": 1.0}}
MULTI_GATES = {"default_gate": {}, "gate0": {"OCTOPUS_TPU_HOST_HMM_MAX": "0"}}


def phase_multi_cli(kind, device="cuda", kb=MULTI_KB):
    """The population or trio caller through the CLI on the mode of
    octopus_tpu_torch.bench_e2e_multi (its 100 kb three-sample input, and
    its accuracy line for every run): an untimed checked run with the
    host-DP gate at 0, every kernel #1 launch held against its plain twin,
    then timed runs in turns (default gate, gate 0, default gate). Every
    run must write the same records and reach the reference's accuracy.
    Returns (the launches of kernel #1 in the timed gate-0 run, the kept
    launches' largest error). device="cpu" rehearses the phase (no
    kernel)."""
    import os
    import shutil
    import tempfile
    from octopus_tpu_torch import bench_e2e_multi
    from octopus_tpu_torch.core.likelihood import likelihood_array as la
    from octopus_tpu_torch.core.likelihood import pairhmm_batch as pb

    phase = f"{kind}_cli"
    make_input, mode_argv, result = bench_e2e_multi.MODES[kind]
    tmp = tempfile.mkdtemp(prefix=f"chip_smoke_{kind}_")
    try:
        t0 = time.perf_counter()
        fa, bams, truth = make_input(tmp, kb=kb, depth=MULTI_DEPTH)
        sites = ({"truth_sites": len(truth)} if kind == "population" else
                 {"germline": len(truth[0]), "denovo": len(truth[1])})
        emit({"phase": f"{phase}_input", "region_kb": kb,
              "depth": MULTI_DEPTH, "samples": len(bams),
              **sites, "bam_bytes": sum(os.path.getsize(b) for b in bams),
              "simulate_and_write_s": time.perf_counter() - t0})
        argv = ["-R", fa, "-I", *bams, *mode_argv]

        def run(label, timed):
            lines, row = run_caller_cli(tmp, phase, label, argv,
                                        MULTI_GATES[label], device, timed)
            acc = result(caller_vcf(tmp, label, timed), truth, kb,
                         MULTI_DEPTH, row["wall_s"])
            print(json.dumps(acc), flush=True)     # the bench module's line
            row.update({"region_kb": kb, "wall_s_per_kb": row["wall_s"] / kb,
                        **{k: acc[k] for k in MULTI_BARS[kind]}})
            emit(row)
            short = {k: (acc[k], bar) for k, bar in MULTI_BARS[kind].items()
                     if acc[k] != bar}
            if short:
                raise AssertionError(f"{phase} {label}: accuracy (got, the "
                                     f"reference's) {short}")
            return lines, row

        kept = []
        with kept_launches(pb, kept, "pairhmm", la):
            checked, _ = run("gate0", timed=False)
        err = (check_launches(pb, kept, f"{phase}_launches")
               if device == "cuda" else 0)
        runs = [checked]
        launches = None
        for label in ("default_gate", "gate0", "default_gate"):
            lines, row = run(label, timed=True)
            runs.append(lines)
            if label == "gate0":
                launches = row["launches"]["pairhmm"]
        if any(lines != checked for lines in runs):
            raise AssertionError(f"{phase} runs wrote different records")
        return launches, err
    finally:
        for k in CLI_ENV_KEYS:
            os.environ.pop(k, None)
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phases 10-13: the process pool, shards and sharding
# ---------------------------------------------------------------------------

def pool_workers() -> int:
    import os
    return min(8, os.cpu_count() or 1)


# label -> CLI arguments past the input
POOL_MODES = {
    "serial": [],
    "processes": ["--threads", "{W}"],
    "threads": ["--threads", "{W}", "--thread-workers"],
}


def _pool_row(row):
    from octopus_tpu_torch import run
    row.update({"pool": dataclasses.asdict(run.POOL)})
    return row


def phase_pool_cli(inputs, tmp, device="cuda"):
    """The cli phase's BAM through the CLI serially, on the process pool
    and on the thread pool, W = min(8, cores) workers, default gates, one
    run each. Every run must write the serial card run's records;
    no pool may fall back. Returns the parent's kernel #1 launches."""
    import os
    from octopus_tpu_torch import run
    W = pool_workers()
    with open(inputs["serial"]) as fh:
        want = [line.rstrip("\n") for line in fh if not line.startswith("#")]
    argv = ["-R", inputs["fa"], "-I", inputs["bam"]]
    walls = {}
    launches = 0
    for label in ("serial", "processes", "threads"):
        run.POOL.reset()
        lines, row = run_caller_cli(
            tmp, "pool_cli", label,
            argv + [a.format(W=W) for a in POOL_MODES[label]], {}, device,
            True)
        row.update({"workers": W, "cpu_count": os.cpu_count(),
                    "region_kb": inputs["kb"], "records": len(lines)})
        emit(_pool_row(row))
        walls[label] = row["wall_s"]
        if label == "processes":
            launches += row["launches"]["pairhmm"]
        if lines != want:
            raise AssertionError(f"pool_cli {label}: records differ from "
                                 "the serial card run")
        if label == "processes" and (run.POOL.fallbacks
                                     or not run.POOL.worker_windows):
            raise AssertionError(f"pool_cli {label}: {run.POOL}")
    emit({"phase": "pool_cli_walls", "workers": W, "cpu_count": os.cpu_count(),
          "wall_s": walls})
    return launches


def phase_pool_cli_deferred(inputs, tmp, device="cuda"):
    """The process pool with every window of a variant handed back
    (OCTOPUS_TPU_DEFER_HEAVY_AT=1) and the parent's host-DP gate at 0: the
    parent runs the deferred windows through kernel #1, every launch held
    against the plain twin. Returns (the parent's #1 launches, the kept
    launches' largest error)."""
    import os
    from octopus_tpu_torch import run
    from octopus_tpu_torch.core.likelihood import likelihood_array as la
    from octopus_tpu_torch.core.likelihood import pairhmm_batch as pb
    W = pool_workers()
    with open(inputs["serial"]) as fh:
        want = [line.rstrip("\n") for line in fh if not line.startswith("#")]
    run.POOL.reset()
    kept = []
    with kept_launches(pb, kept, "pairhmm", la):
        lines, row = run_caller_cli(
            tmp, "pool_cli_deferred", "deferred",
            ["-R", inputs["fa"], "-I", inputs["bam"], "--threads", str(W)],
            {"OCTOPUS_TPU_DEFER_HEAVY_AT": "1", "OCTOPUS_TPU_HOST_HMM_MAX": "0"},
            device, True)
    row.update({"workers": W, "cpu_count": os.cpu_count(),
                "records": len(lines)})
    emit(_pool_row(row))
    launches = row["launches"]["pairhmm"]
    err = (check_launches(pb, kept, "pool_cli_deferred_launches")
           if device == "cuda" else 0)
    if lines != want:
        raise AssertionError("pool_cli_deferred: records differ from the "
                             "serial card run")
    if (not run.POOL.deferred_windows or run.POOL.fallbacks
            or (device == "cuda" and not launches)):
        raise AssertionError(f"pool_cli_deferred: {run.POOL}, parent #1 "
                             f"launches {launches}")
    return launches, err


SHARD_PROBE = r"""
import json, sys
from octopus_tpu_torch import cli
from octopus_tpu_torch.core.likelihood import pairhmm_batch as pb
from octopus_tpu_torch.kernel_experiments import _common as xc
rc = cli.main(sys.argv[1:])
print(json.dumps({"rc": rc, "launches": {k: c.launches
                                         for k, c in pb.KERNEL_COUNTS.items()},
                  "exp_launches": {f"exp_{n}": c.launches
                                   for n, c in xc.COUNTS.items()}}))
"""


def phase_shard_cli(inputs, tmp, device="cuda"):
    """Two OS processes share the cli phase's BAM through --work-queue
    --num-shards 2 on one card, host-DP gate 0: the last to finish merges,
    and the merged VCF must equal the serial card run's byte for byte; each
    process must launch kernel #1. Returns the two processes' #1 launches
    and their kernel experiments' launches (library -> count)."""
    import os
    out = os.path.join(tmp, "shard_cli.vcf")
    env = {k: v for k, v in os.environ.items() if k not in CLI_ENV_KEYS}
    # two processes on the host's cores: half of them each
    env.update(OCTOPUS_TPU_HOST_HMM_MAX="0",
               OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 2) // 2)))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", SHARD_PROBE, "-R", inputs["fa"], "-I",
         inputs["bam"], "-o", out, "--device", device, "--work-queue",
         "--num-shards", "2", "--shard-index", str(i)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)]
    results = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=600)
        if p.returncode != 0:
            raise AssertionError(f"shard_cli: exit {p.returncode}: "
                                 f"{stderr[-2000:]}")
        results.append(json.loads(stdout.strip().splitlines()[-1]))
    wall = time.perf_counter() - t0
    with open(out, "rb") as a, open(inputs["serial"], "rb") as b:
        same = a.read() == b.read()
    launches = [r["launches"]["pairhmm"] for r in results]
    emit({"phase": "shard_cli", "device": device, "processes": 2,
          "wall_s": wall, "launches": [r["launches"] for r in results],
          "byte_identical": same})
    if not same:
        raise AssertionError("shard_cli: the merged VCF differs from the "
                             "serial card run")
    if device == "cuda" and not all(launches):
        raise AssertionError(f"shard_cli: #1 launches per process {launches}")
    return sum(launches), {k: sum(r["exp_launches"][k] for r in results)
                           for k in results[0]["exp_launches"]}


# ---------------------------------------------------------------------------
# phases 14-15: the CSR tools, the evidence BAM and CRAM input
# ---------------------------------------------------------------------------

# label -> environment; each CSR tool runs at every label it lists
CSR_GATES = {"gate0": {"OCTOPUS_TPU_HOST_HMM_MAX": "0"},
             "gate0_lanes": {"OCTOPUS_TPU_HOST_HMM_MAX": "0",
                             "OCTOPUS_TPU_UNROLLED_HMM": "1"},
             "default_gate": {}}
# tool -> (CLI arguments past the input, gates, the sources kernel #1 (or
# #3) must serve at gate 0); {forest}, {serial} and {bamout} are filled in
CSR_TOOLS = {
    "forest": (["--forest-model", "{forest}"], ("gate0", "default_gate"),
               ("populate", "assignment")),
    "filter_vcf": (["--filter-vcf", "{serial}"], ("gate0", "default_gate"),
                   ("assignment",)),
    "filter_vcf_forest": (["--filter-vcf", "{serial}", "--forest-model",
                           "{forest}"], ("gate0", "default_gate"),
                          ("assignment",)),
    "bamout": (["--bamout", "{bamout}"],
               ("gate0", "gate0_lanes", "default_gate"),
               ("populate", "assignment")),
}


# the shipped germline forest, from the checkout's root
FOREST = "resources/forests/germline.npz"


def phase_csr_tools_cli(inputs, tmp, device="cuda"):
    """The cli phase's BAM and its serial VCF through the CSR tools: inline
    forest CSR, --filter-vcf of the serial VCF (threshold, and with the
    forest) and --bamout, each at gate 0 and the default gate (--bamout also
    through kernel #3). Every launch of the gate-0 runs is held against its
    plain twin. A tool's outputs must be identical at every gate, the
    threshold --filter-vcf and --bamout's calls must equal the serial run's
    records, and every BAM must be identical. Returns ({kernel: launches in
    the gate-0 runs}, {kernel: the largest error of its kept launches})."""
    import os
    from octopus_tpu_torch.core.likelihood import likelihood_array as la
    from octopus_tpu_torch.core.likelihood import pairhmm_batch as pb
    with open(inputs["serial"]) as fh:
        serial = [line.rstrip("\n") for line in fh if not line.startswith("#")]
    inline_forest = None
    launches = {"pairhmm": 0, "pairhmm_lanes": 0}
    kept = {"pairhmm": [], "pairhmm_lanes": []}
    for tool, (argv, gates, sources) in CSR_TOOLS.items():
        outputs = {}
        for label in gates:
            env = CSR_GATES[label]
            kernel = ("pairhmm_lanes" if env.get("OCTOPUS_TPU_UNROLLED_HMM")
                      else "pairhmm")
            bamout = os.path.join(tmp, f"{tool}_{label}.bam")
            args = ["-R", inputs["fa"], "-I", inputs["bam"],
                    *(a.format(forest=FOREST, serial=inputs["serial"],
                               bamout=bamout) for a in argv)]
            gate0 = "OCTOPUS_TPU_HOST_HMM_MAX" in env
            keep = (kept_launches(pb, kept[kernel], kernel, la)
                    if gate0 and device == "cuda"
                    else contextlib.nullcontext())
            with keep:
                lines, row = run_caller_cli(tmp, "csr_tools_cli",
                                            f"{tool}_{label}", args, env,
                                            device, True, sources)
            if gate0:
                launches[kernel] += row["launches"][kernel]
            if tool == "bamout":
                with open(bamout, "rb") as fh:
                    outputs[label] = (lines, fh.read())
                row["bam_bytes"] = len(outputs[label][1])
            else:
                outputs[label] = (lines, b"")
            row.update({"tool": tool, "region_kb": inputs["kb"]})
            if tool == "forest":
                inline_forest = lines
            elif tool == "filter_vcf_forest" and inline_forest is not None:
                # the reference's standalone pass adds the threshold filter
                # to the forest's and scores from the VCF's records
                row["lines_differing_from_inline_forest"] = sum(
                    a != b for a, b in zip(lines, inline_forest))
            emit(row)
        first = next(iter(outputs.values()))
        if any(out != first for out in outputs.values()):
            raise AssertionError(f"csr_tools_cli {tool}: outputs differ "
                                 f"across {list(outputs)}")
        if tool in ("filter_vcf", "bamout") and first[0] != serial:
            raise AssertionError(f"csr_tools_cli {tool}: records differ from "
                                 "the serial run's (inline threshold CSR)")
        if tool.endswith("forest") and not all(
                "RFGQ" in line.split("\t")[8] for line in first[0]):
            raise AssertionError(f"csr_tools_cli {tool}: a record lacks RFGQ")
    errs = {k: (check_launches(pb, v, "csr_tools_cli_launches", k)
                if device == "cuda" else 0) for k, v in kept.items()}
    if device == "cuda" and not all(launches.values()):
        raise AssertionError(f"csr_tools_cli: launches {launches}")
    return launches, errs


CRAM_RUNS = ("bam", "cram", "bam")


def phase_cram_cli(inputs, tmp, device="cuda"):
    """The cli phase's BAM rewritten as a CRAM by the port's cram_writer
    (timed apart), then called at the default gate in turns with the BAM
    (bam, cram, bam): every run must write the serial run's records.
    Returns kernel #1's launches in the CRAM runs."""
    import os
    from octopus_tpu_torch.io.bam import BamFile
    from octopus_tpu_torch.io.cram_writer import CramWriter
    from octopus_tpu_torch.io.fasta import IndexedFasta, ReferenceGenome
    with open(inputs["serial"]) as fh:
        serial = [line.rstrip("\n") for line in fh if not line.startswith("#")]
    t0 = time.perf_counter()
    reference = ReferenceGenome(IndexedFasta(inputs["fa"]))
    contig = reference.contig_names()[0]
    n = reference.contig_size(contig)
    got = BamFile(inputs["bam"]).fetch(contig, 0, n, keep_names=True)
    (sample, batch), = got.items()
    cram = os.path.join(tmp, "reads.cram")
    with CramWriter(cram, [contig], [n], samples=[sample],
                    reference=reference) as w:
        w.write_batch(batch, sample=sample)
    emit({"phase": "cram_input", "reads": len(batch),
          "cram_bytes": os.path.getsize(cram),
          "bam_bytes": os.path.getsize(inputs["bam"]),
          "write_s": time.perf_counter() - t0})
    walls = collections.defaultdict(list)
    launches = 0
    for i, kind in enumerate(CRAM_RUNS):
        src = cram if kind == "cram" else inputs["bam"]
        lines, row = run_caller_cli(tmp, "cram_cli", f"{kind}_{i}",
                                    ["-R", inputs["fa"], "-I", src], {},
                                    device, True)
        row.update({"input": kind, "region_kb": inputs["kb"]})
        emit(row)
        walls[kind].append(row["wall_s"])
        if kind == "cram":
            launches += row["launches"]["pairhmm"]
        if lines != serial:
            raise AssertionError(f"cram_cli {kind}: records differ from the "
                                 "serial run's")
    emit({"phase": "cram_cli_walls", "wall_s": dict(walls)})
    return launches


def phase_sharded_kernels(device="cuda"):
    """sharded_pairhmm_scores over [cuda:0, cuda:0] and over every visible
    card, at the bench shape and at a ragged B: bit-equal to the unsharded
    kernel and its plain twin, one launch a shard; sharded_genotype_step
    within the CPU tests' tolerance of the unsharded torch reduction."""
    import torch
    from octopus_tpu_torch.core.likelihood import pairhmm_batch as pb
    from octopus_tpu_torch.core.models import genotype_likelihoods as gl
    from octopus_tpu_torch.parallel import (make_mesh, sharded_genotype_step,
                                            sharded_pairhmm_scores)
    meshes = {"cuda0_x2": [torch.device(device, 0)] * 2,
              "visible": (make_mesh() if device == "cuda"
                          else [torch.device("cpu")])}
    rng = np.random.default_rng(SEED)
    rows = []
    for B in SHARD_BATCHES:
        args = random_batch(rng, B, READ_LEN, 8)
        on_card = [torch.from_numpy(a).to(device) for a in args]
        whole = pb.pairhmm_scores_cuda(*on_card, pad=8) if device == "cuda" \
            else pb.pairhmm_scores_plain(*on_card, pad=8)
        plain = pb.pairhmm_scores_plain(*on_card, pad=8)
        for name, devices in meshes.items():
            pb.COUNTS.reset()
            t0 = time.perf_counter()
            got = sharded_pairhmm_scores(devices, *args, pad=8)
            ms = (time.perf_counter() - t0) * 1e3
            launches = pb.COUNTS.launches
            err = max(int((got.long() - whole.cpu().long()).abs().max()),
                      int((got.long() - plain.cpu().long()).abs().max()))
            rows.append({"B": B, "devices": name, "shards": len(devices),
                         "launches": launches, "call_ms_host_clock": ms,
                         "max_abs_err": err})
            if err or (device == "cuda" and launches != len(devices)):
                raise AssertionError(f"sharded_kernels: {rows[-1]}")
    gl_rows = []
    for ploidy, H, R in ((2, 12, 512), (2, 64, 4_099), (3, 8, 1_024)):
        from octopus_tpu_torch.core.types.genotypes import (
            generate_all_genotypes, genotype_counts_matrix)
        lnL = -rng.exponential(3.0, (H, R))
        gts = generate_all_genotypes(H, ploidy)
        counts = genotype_counts_matrix(gts, H).astype(np.float32)
        want = gl.genotype_log_likelihoods_torch(
            torch.as_tensor(lnL, dtype=torch.float32, device=device),
            torch.as_tensor(counts, device=device), ploidy).cpu().numpy()
        for name, devices in meshes.items():
            got = sharded_genotype_step(devices, lnL, counts, ploidy).numpy()
            close = np.allclose(got, want, rtol=SHARD_RTOL, atol=SHARD_ATOL)
            gl_rows.append({"ploidy": ploidy, "H": H, "R": R,
                            "G": len(gts), "devices": name,
                            "max_abs_diff": float(np.abs(got - want).max()),
                            "close": bool(close)})
            if not close:
                raise AssertionError(f"sharded_kernels: {gl_rows[-1]}")
    emit({"phase": "sharded_kernels", "pairhmm": rows, "genotype": gl_rows,
          "rtol": SHARD_RTOL, "atol": SHARD_ATOL})


# the bench shape's batch and a ragged one; the sharded genotype
# reduction's tolerance, as tests/test_torch_sharding.py
SHARD_BATCHES = (65_536, 4_099)
SHARD_RTOL, SHARD_ATOL = 2e-4, 2e-3


# ---------------------------------------------------------------------------
# phases 16-21: the ported entry points (octopus_tpu_torch.bench*,
# octopus_tpu_torch.scripts)
# ---------------------------------------------------------------------------

def phase_bench(device="cuda", check_B=16384):
    """octopus_tpu_torch.bench at its own batches (its JSON line), then its
    inputs at check_B pairs through the scorer it times, held against the
    plain twin, error 0. Returns (the scorer's launches in the bench's run,
    the error)."""
    import torch
    from octopus_tpu_torch import bench
    from octopus_tpu_torch.core.likelihood import pairhmm_batch as pb
    reset_counts()
    line = bench.run(device=device)
    counts = read_counts()
    print(json.dumps(line), flush=True)
    dev = torch.device(device)
    tracks = bench.bench_inputs(check_B, dev,
                                torch.Generator(device=dev).manual_seed(SEED))
    got = pb._scorer(dev)(*tracks, pad=bench.PAD)
    want = pb.pairhmm_scores_plain(*tracks, pad=bench.PAD)
    err = int((got.long() - want.long()).abs().max())
    emit({"phase": "bench", "kernel": line["detail"]["kernel"],
          "launches": counts["launches"], "check_B": check_B,
          "max_abs_err": err})
    del tracks, got, want
    if device == "cuda":
        torch.cuda.empty_cache()
    if err:
        raise AssertionError(f"bench: the scorer differs from its plain twin "
                             f"by {err}")
    return counts["launches"]["pairhmm"], err


# the README's `bench_e2e.py 200 30`, and its `bench_e2e.py 100 30 long`
# cut to 30 kb for the run's time limit: at 100 kb a long-mode run took
# 109-118 s on the card, at 50 kb 59-69 s, at 30 kb 45-55 s, host-bound
# (the haplotype beam ~50 s at 100 kb); at 20 kb a run is 4 s and no
# longer host-bound
BENCH_E2E_KB = 200
BENCH_E2E_LONG_KB = 30
BENCH_E2E_GATES = {"default_gate": {}, "gate0": {"OCTOPUS_TPU_HOST_HMM_MAX": "0"}}


def run_bench_e2e(phase, inputs, tmp, label, device, threads):
    """One octopus_tpu_torch.bench_e2e run (its untimed 10 kb warm-up and
    its timed run) at BENCH_E2E_GATES[label] with `threads`: prints the
    module's line, then the phase's row with the kernels' counts of the
    timed run alone and its wall unrounded. Recall and precision must reach
    0.95. Returns (record lines, the module's line, the row)."""
    import os
    from octopus_tpu_torch import bench_e2e
    fa, bam, truth, kb, extra = inputs
    for k in CLI_ENV_KEYS:
        os.environ.pop(k, None)
    os.environ.update(BENCH_E2E_GATES[label])
    d = os.path.join(tmp, f"{label}_{threads}")
    os.makedirs(d)
    try:
        bench_e2e.warm_up(fa, bam, extra, d, device)
        reset_counts()
        result, out, wall = bench_e2e.run_bench(fa, bam, truth, kb, DEPTH,
                                                extra, d, device, threads)
    finally:
        for k in CLI_ENV_KEYS:
            os.environ.pop(k, None)
    row = {"phase": phase, "run": label, "threads": threads, "wall_s": wall,
           **read_counts()}
    print(json.dumps(result), flush=True)
    emit(row)
    with open(out) as fh:
        lines = [line.rstrip("\n") for line in fh if not line.startswith("#")]
    if result["recall"] < 0.95 or result["precision"] < 0.95:
        raise AssertionError(f"{phase} {label}: recall {result['recall']} "
                             f"precision {result['precision']}")
    return lines, result, row


def pool_start_up(inputs, workers, device):
    """scripts/torch_pool_scaling.py's start-up measure on this input:
    seconds until each of `workers` pool workers, started as the CLI
    starts them, has returned one task."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "torch_pool_scaling.py")
    spec = importlib.util.spec_from_file_location("torch_pool_scaling", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.pool_start_up(["-R", inputs[0], "-I", inputs[1], "--device",
                              device], workers)


def phase_bench_e2e(device="cuda", kb=BENCH_E2E_KB):
    """octopus_tpu_torch.bench_e2e at the README's 200 kb, 30x: the
    module's own run (--threads 8, the default gate; its workers run on the
    host) and a serial run at gate 0 (--threads 1, so the card scores every
    job set), each printing the module's line; identical records, recall
    and precision 0.95, #1 launched in the serial run's timed part; the
    pool's start-up (scripts/torch_pool_scaling.py's measure) beside the
    walls. Returns #1's launches in the serial gate-0 run."""
    import os
    import shutil
    import tempfile
    from octopus_tpu_torch import bench_e2e
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bench_e2e_")
    try:
        t0 = time.perf_counter()
        fa, bam, truth, _, extra = bench_e2e.simulate_mode(tmp, kb, DEPTH)
        emit({"phase": "bench_e2e_input", "region_kb": kb, "depth": DEPTH,
              "truth": len(truth), "bam_bytes": os.path.getsize(bam),
              "simulate_and_write_s": time.perf_counter() - t0})
        inputs = (fa, bam, truth, kb, extra)
        pooled, _, pooled_row = run_bench_e2e(
            "bench_e2e", inputs, tmp, "default_gate", device,
            bench_e2e.THREADS)
        serial, _, serial_row = run_bench_e2e("bench_e2e", inputs, tmp,
                                              "gate0", device, 1)
        W = pool_workers()
        ready = pool_start_up(inputs, W, device)
        emit({"phase": "bench_e2e_pool", "workers": W,
              "cpu_count": os.cpu_count(),
              "wall_s": {"default_gate_threads8": pooled_row["wall_s"],
                         "gate0_threads1": serial_row["wall_s"]},
              "start_up_ready_s": ready,
              "start_up_share": max(ready) / pooled_row["wall_s"],
              "pool_cost_s": pooled_row["wall_s"] - serial_row["wall_s"]})
        if serial != pooled:
            raise AssertionError("bench_e2e: the serial gate-0 run and the "
                                 "pooled run wrote different records")
        launches = serial_row["launches"]["pairhmm"]
        if device == "cuda" and not launches:
            raise AssertionError("bench_e2e: the serial gate-0 run never "
                                 "launched #1")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# the long-read kernel check: a few hundred pairs of a 5 kb and a 15 kb
# read against their windows, the reads' length of the long mode
LONG_KERNEL_CASES = ((256, 5000), (256, 15000))


def long_read_kernel(pb, pad=8):
    """Kernel #1 on a few hundred pairs of reads 5,000 and 15,000 bases
    long (random_batch), every variant of csrc/pairhmm.cu against the plain
    twin, error 0; the wrapper's and each variant's CUDA-event medians and
    the plain twin's one run beside the bound."""
    import torch
    rng = np.random.default_rng(SEED + 3)
    rows = []
    for B, R in LONG_KERNEL_CASES:
        args = [torch.from_numpy(a).cuda()
                for a in random_batch(rng, B, R, pad)]
        # the plain twin takes seconds here: one run, timed as it runs
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        want = pb.pairhmm_scores_plain(*args, pad=pad)
        e1.record()
        torch.cuda.synchronize()
        got = pb.pairhmm_scores_cuda(*args, pad=pad)
        err = int((got.long() - want.long()).abs().max())
        variant_ms = {}
        for T in pb.THREADS:
            for wave in (False, True):
                if T > 2 * pad or (wave and not pb.wave_ok(T, pad)):
                    continue
                launch = (lambda T=T, wave=wave: pb.launch_kernel(
                    args, pad=pad, threads=T, wave=wave))
                v = launch()
                err = max(err, int((v.long() - want.long()).abs().max()))
                variant_ms[f"{'W' if wave else 'T'}{T}"] = cuda_ms(launch)
        bound_ms, bound_by = pairhmm_bound(B, R, pad)
        rows.append({"B": B, "R": R, "pad": pad, "max_abs_err": err,
                     "max_score": int(want.max()),
                     "wrapper_ms": cuda_ms(lambda: pb.pairhmm_scores_cuda(
                         *args, pad=pad)),
                     "plain_ms": e0.elapsed_time(e1),
                     "chosen": chosen_variant(pb, "pairhmm", B, pad),
                     "variant_ms": variant_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by})
        del args, want, got
        torch.cuda.empty_cache()
    emit({"phase": "long_read_kernel", "rows": rows})
    if any(r["max_abs_err"] for r in rows):
        raise AssertionError(f"long_read_kernel: {rows}")
    return max(r["max_abs_err"] for r in rows)


def phase_bench_e2e_long(device="cuda", kb=BENCH_E2E_LONG_KB):
    """octopus_tpu_torch.bench_e2e's `long` mode (5-15 kb PacBio-HiFi-style
    reads through resources/configs/PacBioCCS.config) at 30 kb (the
    README's 100 kb cut, BENCH_E2E_LONG_KB), 30x, at the default gate and
    at gate 0: identical records, recall and precision 0.95, and kernel #1
    launched at gate 0 (its longest R printed). Then kernel #1 on pairs of
    whole long reads (long_read_kernel). Returns (#1's launches at gate 0,
    the kernel check's error)."""
    import os
    import shutil
    import tempfile
    from octopus_tpu_torch import bench_e2e
    from octopus_tpu_torch.core.likelihood import pairhmm_batch as pb
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bench_e2e_long_")
    try:
        t0 = time.perf_counter()
        fa, bam, truth, _, extra = bench_e2e.simulate_mode(tmp, kb, DEPTH,
                                                           "long")
        emit({"phase": "bench_e2e_long_input", "region_kb": kb,
              "depth": DEPTH, "truth": len(truth),
              "bam_bytes": os.path.getsize(bam),
              "simulate_and_write_s": time.perf_counter() - t0})
        inputs = (fa, bam, truth, kb, extra)
        runs = {}
        for label in ("default_gate", "gate0"):
            lines, _, row = run_bench_e2e("bench_e2e_long", inputs, tmp, label,
                                          device, bench_e2e.THREADS)
            runs[label] = (lines, row)
        if runs["gate0"][0] != runs["default_gate"][0]:
            raise AssertionError("bench_e2e_long: gate 0 and the default gate "
                                 "wrote different records")
        launches = runs["gate0"][1]["launches"]["pairhmm"]
        if device == "cuda" and not launches:
            raise AssertionError("bench_e2e_long: gate 0 never launched #1")
        err = long_read_kernel(pb) if device == "cuda" else 0
        return launches, err
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


BENCH_SCALING_MB = 1
BENCH_SCALING_WORKERS = (1, 2)


def phase_bench_scaling(device="cuda", mb=BENCH_SCALING_MB,
                        workers=BENCH_SCALING_WORKERS):
    """octopus_tpu_torch.bench_scaling at 1 Mb, 30x: the CLI as one and as
    two --work-queue processes on the card (each its own CUDA context and
    half the host's cores), each printing the module's line; the merged
    body must equal the single process's."""
    import os
    import shutil
    import tempfile
    from octopus_tpu_torch import bench_e2e, bench_scaling
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bench_scaling_")
    try:
        t0 = time.perf_counter()
        fa, bam, _, _ = bench_e2e.simulate(tmp, mb * 1000, DEPTH)
        emit({"phase": "bench_scaling_input", "mb": mb, "depth": DEPTH,
              "bam_bytes": os.path.getsize(bam),
              "simulate_and_write_s": time.perf_counter() - t0})
        env = {k: v for k, v in os.environ.items() if k not in CLI_ENV_KEYS}
        rows = []
        for row in bench_scaling.scaling(fa, bam, tmp, mb, DEPTH, workers,
                                         device, env):
            print(json.dumps(row), flush=True)
            rows.append(row)
        if any(r["identical_to_single"] is False for r in rows) or not all(
                r["identical_to_single"] for r in rows[1:]):
            raise AssertionError(f"bench_scaling: {rows}")
        return rows
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def bam_reads(path):
    """(read count, HP tag of each read) of a BAM."""
    from octopus_tpu_torch.io.bam import BamFile
    src = BamFile(path)
    tags = []
    for contig, n in zip(src.header.ref_names, src.header.ref_lengths):
        for batch in src.fetch(contig, 0, n, keep_aux=True).values():
            tags += [batch.tag(i, "HP") for i in range(len(batch))]
    return len(tags), tags


def phase_scripts(inputs, tmp, device="cuda"):
    """The four user scripts (octopus_tpu_torch.scripts) on the card:
    long_phase on the cli phase's BAM (pass 1 must write the serial run's
    records, pass 2 a subset of its sites at recall 0.95); split_realigned_bam
    and filter_assigned_reads on csr_tools_cli's evidence BAM (every read in
    the BAM of its HP tuple; the uniquely assigned ones kept); train_forest
    --synthetic at 30 kb, the forest then loaded by --forest-model on the
    cli BAM (every record carries RFGQ). Returns #1's launches in the
    long_phase and forest runs."""
    import os
    from octopus_tpu_torch import bench_e2e
    from octopus_tpu_torch.io.vcf import VcfReader
    from octopus_tpu_torch.scripts import (filter_assigned_reads, long_phase,
                                           split_realigned_bam, train_forest)
    with open(inputs["serial"]) as fh:
        serial = [line.rstrip("\n") for line in fh if not line.startswith("#")]
    d = os.path.join(tmp, "scripts")
    os.makedirs(d)
    launches = 0

    def lines_of(path):
        with open(path) as fh:
            return [line.rstrip("\n") for line in fh
                    if not line.startswith("#")]

    # long_phase: both passes in-process, default gate
    out = os.path.join(d, "phased.vcf")
    reset_counts()
    t0 = time.perf_counter()
    long_phase.main(["-R", inputs["fa"], "-I", inputs["bam"], "-o", out,
                     "--device", device, "--keep-intermediate"])
    wall = time.perf_counter() - t0
    counts = read_counts()
    launches += counts["launches"]["pairhmm"]
    first, second = lines_of(os.path.join(d, "phased.tmp.vcf")), lines_of(out)
    recall, precision = accuracy(second, inputs["truth"])
    sites = {line.split("\t")[1] for line in first}
    phasing = {name: bench_e2e.phasing_stats(
        [r for r in VcfReader(path).records() if r.alts], {})
        for name, path in (("pass1", os.path.join(d, "phased.tmp.vcf")),
                           ("pass2", out))}
    row = {"phase": "scripts", "script": "long_phase", "wall_s": wall,
           "pass1_records": len(first), "pass2_records": len(second),
           "recall": recall, "precision": precision,
           "phase_sets": {k: v["n_phase_sets"] for k, v in phasing.items()},
           "ps_n50": {k: v["ps_n50"] for k, v in phasing.items()}, **counts}
    emit(row)
    if (first != serial or not second or recall < 0.95
            or not {line.split("\t")[1] for line in second} <= sites):
        raise AssertionError(f"scripts long_phase: {row}")

    # split_realigned_bam and filter_assigned_reads on the evidence BAM
    evidence = os.path.join(tmp, "bamout_default_gate.bam")
    n, tags = bam_reads(evidence)
    prefix = os.path.join(d, "hp")
    split_realigned_bam.main(["-b", evidence, "-o", prefix])
    split = {}
    for name in sorted(os.listdir(d)):
        if name.startswith("hp_") and name.endswith(".bam"):
            key = name[3:-4]
            m, got = bam_reads(os.path.join(d, name))
            split[key] = m
            want = None if key == "R" else ",".join(key.split("_"))
            if any((None if t is None else str(t)) != want for t in got):
                raise AssertionError(f"scripts split: {name} holds reads of "
                                     "another HP")
    assigned = os.path.join(d, "assigned.bam")
    filter_assigned_reads.main(["-I", evidence, "-O", assigned])
    kept, kept_tags = bam_reads(assigned)
    unique = sum(t is not None and "," not in str(t) for t in tags)
    row = {"phase": "scripts", "script": "split_and_filter",
           "evidence_reads": n, "split_bams": split, "assigned_reads": kept,
           "uniquely_assigned_in_evidence": unique}
    emit(row)
    if sum(split.values()) != n or kept != unique or not kept:
        raise AssertionError(f"scripts split/filter: {row}")

    # train_forest --synthetic, then the forest in --forest-model
    forest = os.path.join(d, "trained.npz")
    reset_counts()
    t0 = time.perf_counter()
    train_forest.main(["--synthetic", "--kb", "30", "--seeds", "101", "202",
                       "--trees", "20", "-o", forest, "--device", device])
    train_s = time.perf_counter() - t0
    counts = read_counts()
    launches += counts["launches"]["pairhmm"]
    lines, run_row = run_caller_cli(d, "scripts", "trained_forest",
                                    ["-R", inputs["fa"], "-I", inputs["bam"],
                                     "--forest-model", forest], {}, device,
                                    True)
    launches += run_row["launches"]["pairhmm"]
    row = {"phase": "scripts", "script": "train_forest", "train_s": train_s,
           "train_launches": counts["launches"],
           "forest_run_wall_s": run_row["wall_s"],
           "forest_run_records": len(lines),
           "forest_run_pass": run_row["pass_records"]}
    emit(row)
    if len(lines) != len(serial) or not all(
            "RFGQ" in line.split("\t")[8] for line in lines):
        raise AssertionError(f"scripts train_forest: {row}")
    return launches


# what the reference CLI (octopus_tpu, JAX on the CPU) reaches on the
# polyclone and cell modes' inputs, by bench_e2e_multi.py's own measures
# (`JAX_PLATFORMS=cpu python bench_e2e_multi.py polyclone|cell`): every
# trunk and private site of the 3 clones, the minor clone's too, no false
# positive, 2 clones the most common CLONES; every germline site of the
# cells, 7 of 8 somatics flagged SOMATIC and all 8 called, CELLS off by
# 0.29 on average. The trio mode's are MULTI_BARS'
BENCH_MULTI_BARS = {
    "polyclone": {"trunk_recall": 1.0, "private_recall": 1.0,
                  "minor_clone_recall": 1.0, "fp": 0, "clones_mode": 2},
    "cell": {"germline_recall": 1.0, "somatic_recall": 0.875,
             "somatic_called_any": 1.0, "fp": 0, "mean_cells_err": 0.29},
    "trio": MULTI_BARS["trio"],
}


def phase_bench_multi(device="cuda"):
    """octopus_tpu_torch.bench_e2e_multi.bench, the module's own path
    (--threads 4: CPU-only pool workers, the parent on the card), for the
    polyclone (50 kb, 3 clones at 120x), cell (30 kb, 8 cells at 12x) and
    trio (100 kb, 30x) modes, each printing the module's line; the accuracy
    must equal the reference CLI's on the same seed (BENCH_MULTI_BARS).
    Returns #1's launches over the three runs."""
    import os
    import shutil
    import tempfile
    from octopus_tpu_torch import bench_e2e_multi
    launches = 0
    for kind, bars in BENCH_MULTI_BARS.items():
        tmp = tempfile.mkdtemp(prefix=f"chip_smoke_bench_{kind}_")
        for k in CLI_ENV_KEYS:
            os.environ.pop(k, None)
        try:
            reset_counts()
            line = bench_e2e_multi.bench(kind, tmp, device)
            counts = read_counts()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps(line), flush=True)
        emit({"phase": "bench_multi", "mode": kind, **counts})
        launches += counts["launches"]["pairhmm"]
        short = {k: (line[k], bar) for k, bar in bars.items()
                 if line[k] != bar}
        if short:
            raise AssertionError(f"bench_multi {kind}: accuracy (got, the "
                                 f"reference's) {short}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import octopus_tpu_torch  # noqa: F401  (fails outside the checkout)

    seconds = {}

    @contextlib.contextmanager
    def timed(name):
        t0 = time.perf_counter()
        yield
        seconds[name] = time.perf_counter() - t0

    with timed("build"):
        phase_build()
    with timed("kernels"):
        kernel_rows = phase_kernels()
        variant_sweep(kernel_rows)
    with timed("kernel_experiments"):
        exp_rows, exp_phase = phase_kernel_experiments()
    with timed("gate_sweep"):
        phase_gate_sweep()
    with timed("bench"):
        bench_launches, bench_err = phase_bench()
    with timed("main_path"):
        main_path_launches, main_path_err = phase_main_path()
    emit({"phase": "main_path_kernel_launches",
          "pairhmm": main_path_launches})
    import shutil
    import tempfile
    cli_tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        with timed("cli"):
            cli_launches, cli_errs, cli_input = phase_cli(tmp=cli_tmp)
        with timed("pool_cli"):
            pool_launches = phase_pool_cli(cli_input, cli_tmp)
        with timed("pool_cli_deferred"):
            deferred_launches, deferred_err = phase_pool_cli_deferred(
                cli_input, cli_tmp)
        with timed("shard_cli"):
            shard_launches, shard_exp_launches = phase_shard_cli(
                cli_input, cli_tmp)
        with timed("csr_tools_cli"):
            csr_launches, csr_errs = phase_csr_tools_cli(cli_input, cli_tmp)
        with timed("cram_cli"):
            cram_launches = phase_cram_cli(cli_input, cli_tmp)
        with timed("scripts"):
            scripts_launches = phase_scripts(cli_input, cli_tmp)
    finally:
        shutil.rmtree(cli_tmp, ignore_errors=True)
    with timed("bench_e2e"):
        bench_e2e_launches = phase_bench_e2e()
    with timed("bench_e2e_long"):
        long_launches, long_err = phase_bench_e2e_long()
    with timed("bench_scaling"):
        phase_bench_scaling()
    with timed("sharded_kernels"):
        phase_sharded_kernels()
    with timed("vb_gate_sweep"):
        phase_vb_gate_sweep()
    with timed("cancer_cli"):
        cancer_launches, cancer_errs = phase_cancer_cli()
    for kind in ("polyclone", "cell"):
        with timed(f"{kind}_cli"):
            phase_vb_sample_cli(kind)
    multi = {}
    for kind in MULTI:
        with timed(f"{kind}_cli"):
            multi[kind] = phase_multi_cli(kind)
    with timed("bench_multi"):
        bench_multi_launches = phase_bench_multi()
    # the kernel experiments' launches on every product path: this process
    # since their own phase, and the two shard_cli processes
    exp_product = exp_launches()
    # host-clock seconds of each phase, to keep the script inside its limit
    emit({"phase": "phase_seconds", **seconds})
    print(card_line(), flush=True)
    sources = {"pairhmm": "octopus_tpu_torch/csrc/pairhmm.cu",
               "pairhmm_lanes": "octopus_tpu_torch/csrc/pairhmm_lanes.cu",
               "pairhmm_cost": "octopus_tpu_torch/csrc/pairhmm_cost.cu"}
    kept_errs = {"pairhmm": [main_path_err, bench_err, long_err,
                             cli_errs["pairhmm"],
                             deferred_err, csr_errs["pairhmm"],
                             cancer_errs["pairhmm"],
                             *(err for _, err in multi.values())],
                 "pairhmm_lanes": [cli_errs["pairhmm_lanes"],
                                   csr_errs["pairhmm_lanes"]],
                 "pairhmm_cost": []}
    # kernel #1 from the pool's parent (every pool_cli run and the deferred
    # run) and from the two shard_cli processes
    pool_paths = {"pool_cli": pool_launches,
                  "pool_cli_deferred": deferred_launches,
                  "shard_cli": shard_launches}
    # kernels #1 and #3 from the CSR tools' gate-0 runs, #1 from the CRAM
    # runs (default gate)
    tool_paths = {k: {"csr_tools_cli": csr_launches.get(k, 0),
                      "cram_cli": cram_launches if k == "pairhmm" else 0}
                  for k in KERNELS}
    # kernel #1 from the ported entry points: the bench module, the gate-0
    # runs of bench_e2e and its long mode, the scripts and bench_e2e_multi's
    # polyclone, cell and trio modes (default gates, the pool's parent)
    entry_paths = {"bench": bench_launches, "bench_e2e": bench_e2e_launches,
                   "bench_e2e_long": long_launches,
                   "scripts": scripts_launches,
                   "bench_multi": bench_multi_launches}
    launches = {k: cli_launches.get(k, 0) + sum(tool_paths[k].values())
                for k in KERNELS}
    launches["pairhmm"] += (cancer_launches + sum(n for n, _ in multi.values())
                            + sum(pool_paths.values())
                            + sum(entry_paths.values()))
    table = []
    for kernel in KERNELS:
        rows = kernel_rows[kernel]
        bench = rows[0]
        table.append({
            "name": kernel,
            "route": "cuda",
            "source": sources[kernel],
            "replaces": REPLACES[kernel],
            # the gate-0 runs of the individual, CSR tools, cancer,
            # population and trio CLI paths through this kernel, the pool's
            # parent, the shards, the CRAM runs and the ported entry points;
            # the cost kernel is on no path (as Pallas v2 is in the
            # reference)
            "launches": launches[kernel],
            "launches_by_path": {
                "cli": cli_launches.get(kernel, 0),
                **{k: n if kernel == "pairhmm" else 0
                   for k, n in pool_paths.items()},
                **tool_paths[kernel],
                "cancer_cli": cancer_launches if kernel == "pairhmm" else 0,
                **{f"{k}_cli": n if kernel == "pairhmm" else 0
                   for k, (n, _) in multi.items()},
                **{k: n if kernel == "pairhmm" else 0
                   for k, n in entry_paths.items()}},
            "max_abs_err": max(kept_errs[kernel]
                               + [r["max_abs_err"] for r in rows]),
            "ms": bench["wrapper_ms"],
            "plain_ms": bench["plain_ms"],
            "bound_ms": bench["bound_ms"],
            "bound_by": bench["bound_by"],
            "library_ms": None,
        })
    # the kernel experiments: their launches on the product paths (every
    # phase after their own, counted in this process and the shard_cli
    # processes), their own phase's beside
    for lib, replaces in EXPERIMENTS.items():
        rows = [r for r in exp_rows if r["kernel"] == lib]
        row = next(r for r in rows if r["variant"] == EXP_DEFAULT[lib])
        table.append({
            "name": lib,
            "route": "cuda",
            "source": f"octopus_tpu_torch/csrc/{lib}.cu",
            "replaces": replaces,
            "launches": exp_product[lib] + shard_exp_launches[lib],
            "launches_by_path": {"product_paths": exp_product[lib],
                                 "shard_cli": shard_exp_launches[lib],
                                 "kernel_experiments": exp_phase[lib]},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": row["wrapper_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
        })
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
