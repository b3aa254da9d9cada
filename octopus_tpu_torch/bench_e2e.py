"""End-to-end calling benchmark + accuracy self-check on synthetic data.

Simulates a diploid sample over an N-kb reference at a given depth with
SNVs/indels at human-like rates, runs the full pipeline (BAM on disk ->
VCF) through the port's CLI, and reports wall-clock plus recall/precision
vs the simulated truth.

    python -m octopus_tpu_torch.bench_e2e [kb=500] [depth=30] [long|longhard]
                                          [--device cuda|cpu]

Prints one JSON line with the keys of the reference package's
bench_e2e.py. The port's counterpart of that script: the same simulator
(a seed writes the same FASTA and BAM), the same 10 kb warm-up run and
`--threads 8 --benchmark` timed run, the same measures. Two pieces of the
original have no counterpart here and are left out: the JAX compilation
cache directory, and the kernel warm-up before the runs (the port compiles
nothing per shape; its kernels and host extension build at first use into
build/torch_kernels/, which the untimed 10 kb warm-up run pays).

--device defaults to cuda and raises without a card.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import resource
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from .utils.synthetic import flatten_haplotype

ROOT = Path(__file__).resolve().parent.parent
# the shipped PacBio HiFi preset: linked 500 bp fragmentation + PACBIO
# discovery (reference resources/configs/PacBioCCS.config)
PACBIO_CONFIG = ROOT / "resources" / "configs" / "PacBioCCS.config"
THREADS = 8

__all__ = ["simulate", "simulate_mode", "phasing_stats", "qual_calibration",
           "count_near", "warm_up", "run_bench", "main"]


def simulate(tmp, kb=500, depth=30, read_len=150, seed=11, err=0.001,
             read_len_range=None, base_qual=37, err_qual=None):
    """read_len_range=(lo, hi) simulates variable-length long reads (CCS
    style) with `err` random substitutions; default is 150 bp Illumina.
    err_qual: quality assigned to error bases (real sequencers flag most
    miscalls with reduced baseQ; None = same as base_qual).
    Returns (fasta, bam, truth {pos: (kind, zygosity, members)}, length)."""
    from .basics.reads import FLAG_REVERSE, make_read_batch
    from .io.bam_writer import BamWriter, build_bai

    rng = np.random.default_rng(seed)
    n = kb * 1000
    seq = "".join("ACGT"[c] for c in rng.integers(0, 4, n))
    fa = os.path.join(tmp, "ref.fa")
    with open(fa, "w") as fh:
        fh.write(">chr1\n")
        for i in range(0, n, 70):
            fh.write(seq[i:i + 70] + "\n")
    # truth variants: ~1/1200 SNVs, ~1/8000 small indels, half het half hom
    truth = {}
    haps = [list(seq), list(seq)]
    pos = 1000
    while pos < n - 1000:
        pos += int(rng.integers(600, 1800))
        if pos >= n - 1000:
            break
        hom = rng.random() < 0.4
        members = (0, 1) if hom else (int(rng.random() < 0.5),)
        if rng.random() < 0.15:
            size = int(rng.integers(1, 6))
            if rng.random() < 0.5:
                kind = ("del", size)
            else:
                ins = "".join("ACGT"[c] for c in rng.integers(0, 4, size))
                kind = ("ins", ins)
        else:
            base = seq[pos]
            alt = "ACGT"[("ACGT".index(base) + int(rng.integers(1, 4))) % 4]
            kind = ("snv", alt)
        truth[pos] = (kind, "hom" if hom else "het", members)
        for m in members:
            if kind[0] == "snv":
                haps[m][pos] = kind[1]
            elif kind[0] == "del":
                for k in range(kind[1]):
                    haps[m][pos + k] = ""
            else:
                haps[m][pos] = seq[pos] + kind[1]
    # per-haplotype: flattened sequence + ref coordinate of every hap base
    # (-1 = inserted base), so reads get true ref positions and CIGARs
    hap_seqs, hap_ref = [], []
    for h in haps:
        flat, refc = flatten_haplotype(h)
        hap_seqs.append(flat)
        hap_ref.append(refc)
    del haps     # 2 x genome-size lists of piece strings
    # freeze the retained truth/haplotype structures, so that gen-2 GC
    # passes do not rescan them during the per-read loop
    gc.collect()
    gc.freeze()
    mean_len = (read_len if read_len_range is None
                else (read_len_range[0] + read_len_range[1]) // 2)
    n_reads = int(n * depth / mean_len)
    # Streaming write: only a slab of reads is held in memory. Draws per
    # haplotype are pre-sorted by ref begin; ref position is monotone in hap
    # position, so flushing slab by slab keeps the BAM coordinate-sorted.
    per_hap = [n_reads - n_reads // 2, n_reads // 2]
    draws = []          # per hap: (hap begins, lengths, ref begins) by ref order
    for h in (0, 1):
        m = per_hap[h]
        if read_len_range is None:
            rls = np.full(m, min(read_len, len(hap_seqs[h]) - 1), np.int32)
        else:
            rls = rng.integers(read_len_range[0], read_len_range[1],
                               size=m).astype(np.int32)
            rls = np.minimum(rls, len(hap_seqs[h]) - 1)
        begins = rng.integers(0, len(hap_seqs[h]) - rls.astype(np.int64))
        # exact ref begin of each draw (ref coord of the first aligned base
        # at or after the hap begin): slabs partition by REF coordinate
        rc = hap_ref[h]
        idx = np.where(rc >= 0, np.arange(len(rc)), len(rc))
        next_aligned = np.minimum.accumulate(idx[::-1])[::-1]
        na = next_aligned[begins]
        ref_begins = np.where(na < len(rc), rc[np.minimum(na, len(rc) - 1)],
                              np.int64(n))
        order = np.argsort(ref_begins, kind="stable")
        draws.append((begins[order].astype(np.int64), rls[order],
                      ref_begins[order]))
    bam = os.path.join(tmp, "s.bam")
    slab = max(1_000_000, (read_len_range[1] * 4 if read_len_range else 0))
    flag_state = [0]

    def build_read(hap, refc, begin, rl, rev):
        s = list(hap[begin:begin + rl])
        q = [base_qual] * rl
        for j in np.flatnonzero(rng.random(rl) < err):
            s[j] = "ACGT"[rng.integers(0, 4)]
            if err_qual is not None:
                q[j] = err_qual
        rc = refc[begin:begin + rl]
        aligned = np.flatnonzero(rc >= 0)
        if not len(aligned):
            return None
        lead_ins = int(aligned[0])                    # leading inserted bases
        cig, last_ref, run_m = [], None, 0
        if lead_ins:
            cig.append(f"{lead_ins}S")
        for j in range(lead_ins, rl):
            if rc[j] < 0:                             # inserted base
                if run_m:
                    cig.append(f"{run_m}M")
                    run_m = 0
                if cig and cig[-1].endswith("I"):
                    cig[-1] = f"{int(cig[-1][:-1]) + 1}I"
                else:
                    cig.append("1I")
            else:
                if last_ref is not None and rc[j] > last_ref + 1:
                    if run_m:
                        cig.append(f"{run_m}M")
                        run_m = 0
                    cig.append(f"{int(rc[j] - last_ref - 1)}D")
                run_m += 1
                last_ref = int(rc[j])
        if run_m:
            cig.append(f"{run_m}M")
        if cig and cig[-1].endswith("I"):              # trailing ins -> softclip
            cig[-1] = cig[-1][:-1] + "S"
        return (int(rc[aligned[0]]), "".join(cig), "".join(s),
                q, 60, FLAG_REVERSE if rev else 0)

    t_slab = time.time()
    with BamWriter(bam, ["chr1"], [n], samples=["SIM"]) as w:
        cursors = [0, 0]
        for s0 in range(0, n + slab, slab):
            if s0 and s0 % (20 * slab) == 0:
                print(f"sim: {s0/1e6:.0f}/{n/1e6:.0f} Mb "
                      f"({time.time()-t_slab:.0f}s)", file=sys.stderr)
                t_slab = time.time()
            s1 = s0 + slab
            reads = []
            for h in (0, 1):
                begins, rls, ref_begins = draws[h]
                i = cursors[h]
                while i < len(begins) and ref_begins[i] < s1:
                    r = build_read(hap_seqs[h], hap_ref[h], int(begins[i]),
                                   int(rls[i]), flag_state[0] % 3 == 0)
                    flag_state[0] += 1
                    if r is not None:
                        reads.append(r)
                    i += 1
                cursors[h] = i
            if reads:
                w.write_batch(make_read_batch("chr1", reads).sorted_by_begin(),
                              sample="SIM")
    build_bai(bam)
    return fa, bam, truth, n


# mode -> simulate() keywords: PacBio-HiFi-style 5-15 kb reads, Q30 bases,
# 0.4% substitutions with error bases carrying reduced baseQ (real CCS flags
# most miscalls); `longhard` is a harsher profile (1% err, flat q23), a
# stress setting well below real HiFi quality
LONG_MODES = {
    "long": dict(read_len_range=(5000, 15000), err=0.004, base_qual=30,
                 err_qual=13),
    "longhard": dict(read_len_range=(5000, 15000), err=0.01, base_qual=23,
                     err_qual=None),
}


def simulate_mode(tmp, kb, depth, mode=None):
    """main's input for `mode` (None: 150 bp reads; "long" or "longhard"):
    (fasta, bam, truth, length, the CLI arguments the mode adds)."""
    if mode in LONG_MODES:
        fa, bam, truth, n = simulate(tmp, kb, depth, **LONG_MODES[mode])
        return fa, bam, truth, n, ["--config", str(PACBIO_CONFIG)]
    fa, bam, truth, n = simulate(tmp, kb, depth)
    return fa, bam, truth, n, []


def phasing_stats(records, truth, tol=5):
    """Phasing accuracy vs the simulator's known haplotypes: switch-error
    rate over adjacent phased-het pairs within each phase set, plus
    phase-set span N50 (the reference's PS semantics, phaser.cpp:54-175;
    PQ/PS docs website/docs/guides/advanced/vcf.md).

    truth: pos -> (kind, zygosity, members); members = carrier hap indices.
    The GT column order within a phase set is arbitrary, so accuracy is
    pairwise: a switch = adjacent het pair whose called relative
    orientation (same side vs opposite side) disagrees with truth."""
    truth_pos = np.asarray(sorted(truth))
    by_ps: dict = {}
    ps_span: dict = {}
    for r in records:
        sv = r.sample_values[0] if r.sample_values else {}
        ps = sv.get("PS")
        if ps in (None, "."):
            continue
        key = (r.chrom, ps)
        lo, hi = ps_span.get(key, (r.pos, r.pos))
        ps_span[key] = (min(lo, r.pos), max(hi, r.pos))
        gt = sv.get("GT", "")
        if "|" not in gt:
            continue
        halves = gt.split("|")[:2]
        if len(halves) != 2 or halves[0] == halves[1]:
            continue
        p0 = r.pos - 1
        if not len(truth_pos):
            continue
        j = int(np.searchsorted(truth_pos, p0))
        near = [int(truth_pos[k]) for k in (j - 1, j)
                if 0 <= k < len(truth_pos) and abs(int(truth_pos[k]) - p0) <= tol]
        if not near:
            continue
        _, zyg, members = truth[near[0]]
        if zyg != "het" or len(members) != 1:
            continue
        alt_side = 0 if halves[0] != "0" else 1
        by_ps.setdefault(key, []).append((p0, alt_side, members[0]))
    switches = pairs = 0
    for sites in by_ps.values():
        sites.sort()
        for (_, s1, h1), (_, s2, h2) in zip(sites, sites[1:]):
            pairs += 1
            if (s1 == s2) != (h1 == h2):
                switches += 1
    spans = sorted(hi - lo + 1 for lo, hi in ps_span.values())
    n50 = 0
    if spans:
        total, acc = sum(spans), 0
        for s in reversed(spans):
            acc += s
            if acc * 2 >= total:
                n50 = s
                break
    return {"phased_pairs": pairs, "switch_errors": switches,
            "switch_rate": round(switches / pairs, 4) if pairs else None,
            "ps_n50": n50, "n_phase_sets": len(ps_span)}


def qual_calibration(records, truth, tol=5, field=None):
    """Empirical calibration curve: calls binned by QUAL (or a phred INFO
    field), each bin reporting call count + false calls.  A calibrated
    caller's bin error rate tracks the phred expectation 10^(-Q/10)
    (phred semantics src/basics/phred.hpp:99-116; QUAL assembly
    caller.cpp).  Keys are the bin's lower phred bound."""
    truth_pos = np.asarray(sorted(truth))
    bins: dict = {}
    for r in records:
        if field is not None:
            v = r.info.get(field)
            if v is None:
                continue
            q = float(v)
        else:
            q = r.qual or 0.0
        b = min(int(q // 10) * 10, 100)
        p0 = r.pos - 1
        ok = len(truth_pos) and int(np.abs(truth_pos - p0).min()) <= tol
        n, e = bins.get(b, (0, 0))
        bins[b] = (n + 1, e + (0 if ok else 1))
    return {str(b): {"n": n, "err": e} for b, (n, e) in sorted(bins.items())}


def count_near(points, targets, tol=5):
    """|{p in points : min |p - t|, t in targets <= tol}|, by a sorted
    search."""
    if not points or not targets:
        return 0
    ts = np.asarray(sorted(targets))
    ps = np.asarray(sorted(points))
    j = np.searchsorted(ts, ps)
    near = np.zeros(len(ps), bool)
    for off in (-1, 0):
        k = np.clip(j + off, 0, len(ts) - 1)
        near |= np.abs(ts[k] - ps) <= tol
    return int(near.sum())


def warm_up(fa, bam, extra, tmp, device="cuda"):
    """The untimed run on the first 10 kb: the kernels' and the host
    extension's first build and load, the first launches and the lazy
    imports fall outside the timed region."""
    from .config.options import parse_args_with_config
    from .run import run_calling
    run_calling(parse_args_with_config(["-R", fa, "-I", bam,
                                        "-o", os.path.join(tmp, "warm.vcf"),
                                        "-T", "chr1:1-10000",
                                        "--device", device, *extra]))


def run_bench(fa, bam, truth, kb, depth, extra, tmp, device="cuda",
              threads=THREADS):
    """The timed `--threads threads --benchmark` run of the whole contig
    (after warm_up), scored against `truth`. Returns (the JSON line's dict,
    the output VCF's path, the timed run's wall seconds unrounded)."""
    from .config.options import parse_args_with_config
    from .io.vcf import VcfReader
    from .run import run_calling
    from .utils import timers

    out = os.path.join(tmp, "calls.vcf")
    args = parse_args_with_config(["-R", fa, "-I", bam, "-o", out, "-T", "chr1",
                                   "--threads", str(threads), "--benchmark",
                                   "--device", device, *extra])
    timers.reset()
    rss_after_sim_mb = round(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 1)
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
    t0 = time.time()
    run_calling(args)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - t0
    phases = {k: round(v, 1) for k, v in sorted(
        timers.totals().items(), key=lambda kv: -kv[1])}
    # parent high-water (includes the simulation phase; rss_after_sim_mb
    # separates the simulator's footprint from the caller's) + the largest
    # child process (the pool's workers)
    peak_rss_mb = round(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
        + resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss / 1024, 1)
    all_records = [r for r in VcfReader(out).records() if r.alts]
    records = [r for r in all_records if r.filters == ["PASS"]]
    called_any = {r.pos - 1 for r in all_records} | {r.pos for r in all_records}
    called = {r.pos - 1 for r in records}
    called |= {r.pos for r in records}       # indel anchor offset tolerance
    tp = count_near(list(truth), called)
    tp_any = count_near(list(truth), called_any)
    truth_pos = sorted(truth)
    fp = len(records) - count_near([r.pos - 1 for r in records], truth_pos)
    recall = tp / max(len(truth), 1)
    precision = (len(records) - fp) / max(len(records), 1)
    return {
        "metric": "e2e_synthetic_calling",
        "kb": kb, "depth": depth,
        "wall_s": round(wall, 1),
        "kb_per_s": round(kb / wall, 2),
        "n_truth": len(truth), "n_called": len(records),
        "recall": round(recall, 4), "precision": round(precision, 4),
        # pre-filter caller recall: truth sites emitted at all (non-PASS
        # records are genuine threshold-filter decisions, e.g. AFB outliers)
        "recall_called": round(tp_any / max(len(truth), 1), 4),
        "phases_s": phases,
        "peak_rss_mb": peak_rss_mb,
        "rss_after_sim_mb": rss_after_sim_mb,
        **phasing_stats(records, truth),
        "qual_calibration": qual_calibration(records, truth),
    }, out, wall


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("kb", nargs="?", type=int, default=500)
    p.add_argument("depth", nargs="?", type=int, default=30)
    p.add_argument("mode", nargs="?", default=None,
                   help="long or longhard: PacBio-HiFi-style long reads "
                        "through the PacBioCCS preset")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    from .device import resolve_device
    resolve_device(args.device)
    tmp = tempfile.mkdtemp(prefix="bench_e2e_")
    try:
        fa, bam, truth, _, extra = simulate_mode(tmp, args.kb, args.depth,
                                                 args.mode)
        warm_up(fa, bam, extra, tmp, args.device)
        result, _, _ = run_bench(fa, bam, truth, args.kb, args.depth, extra,
                                 tmp, device=args.device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
