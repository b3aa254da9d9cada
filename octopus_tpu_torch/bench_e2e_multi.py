"""End-to-end accuracy benchmarks for the multi-sample callers.

Synthetic BAM(s) -> the port's CLI -> VCF for the multi-sample caller
families: trio (de novo detection with -M/-F), cancer (tumour-normal
somatic calling with --normal-sample), population (3-sample joint
germline), polyclone (haploid clone mixtures) and cell (single cells over
a known phylogeny).

    python -m octopus_tpu_torch.bench_e2e_multi
        [trio|cancer|population|polyclone|cell|all] [kb=100] [depth=30]
        [--device cuda|cpu]

Prints one JSON line per mode, with the keys of the reference package's
bench_e2e_multi.py; a seed writes that script's files. Each mode is three
parts, which chip_smoke.py also calls on their own: `<mode>_input` writes
the reference and BAMs, MODES[mode]'s arguments drive the CLI, and
`<mode>_result` scores the VCF against the simulated truth.

`n_compiles`, `compile_s` and `warm_compiles` are null: the original
counts JAX's compilations and warms the kernel and VB executables before
the modes (`_install_compile_counter`, `warm_kernels`, `warm_vb`). The
port compiles nothing per shape, so it has neither counter nor warm-up.

--device defaults to cuda and raises without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from collections import Counter

import numpy as np

from .bench_e2e import qual_calibration
from .utils import synthetic
from .utils.synthetic import (apply_variant, flatten_haplotype,
                              mixture_reads, random_sequence, random_variant,
                              write_reads_bam, write_reference)


def _near(pos_set, p, tol=5):
    return any(abs(p - q) <= tol for q in pos_set)


def _run_cli(fa, bams, out, extra, device="cuda"):
    """Drive the CLI's argument path in-process with --threads 4."""
    from .config.options import build_parser
    from .run import run_calling
    args = build_parser().parse_args(["-R", fa, "-I", *bams, "-o", out,
                                      "-T", "chr1", "--threads", "4",
                                      "--device", device, *extra])
    run_calling(args)


def _pass_records(vcf):
    from .io.vcf import VcfReader
    return [r for r in VcfReader(vcf).records()
            if r.alts and r.filters == ["PASS"]]


def _all_records(vcf):
    from .io.vcf import VcfReader
    return [r for r in VcfReader(vcf).records() if r.alts]


# ---------------------------------------------------------------------------
# trio
# ---------------------------------------------------------------------------

def trio_input(tmp, kb=100, depth=30, seed=5):
    """(fasta, [MOM, DAD, KID] BAMs, (germline, de novo positions))."""
    fa, bams, germline, denovo, _ = synthetic.simulate_trio(
        tmp, kb=kb, depth=depth, seed=seed)
    return fa, bams, (germline, denovo)


def trio_result(out, truth, kb, depth, wall):
    germline, denovo = truth
    recs = _pass_records(out)
    dn_called = {r.pos - 1 for r in recs if r.info.get("DENOVO")}
    other_called = {r.pos - 1 for r in recs if not r.info.get("DENOVO")}
    tp = sum(1 for p in denovo if _near(dn_called, p))
    fp = sum(1 for p in dn_called if not _near(denovo, p))
    germ_tp = sum(1 for p in germline if _near(other_called | dn_called, p))
    # pre-filter accounting: the strict default de novo expression
    # (PP >= 40 etc, option_parser.cpp:736-741) is the reference's own
    # gate; the caller-level recall counts every DENOVO-flagged record
    dn_recs = [r for r in _all_records(out) if r.info.get("DENOVO")]
    all_dn = {r.pos - 1 for r in dn_recs}
    caller_tp = sum(1 for p in denovo if _near(all_dn, p))
    caller_fp = sum(1 for p in all_dn if not _near(denovo, p))
    pp_cal = qual_calibration(dn_recs, {p: None for p in denovo}, field="PP")
    return {
        "metric": "e2e_trio_denovo", "kb": kb, "depth": depth,
        "wall_s": round(wall, 1),
        "n_denovo": len(denovo), "denovo_recall": round(tp / len(denovo), 4),
        "denovo_fp": fp,
        "caller_denovo_recall": round(caller_tp / len(denovo), 4),
        "caller_denovo_fp": caller_fp,
        "germline_recall": round(germ_tp / max(len(germline), 1), 4),
        "denovo_pp_calibration": pp_cal,
    }


# ---------------------------------------------------------------------------
# cancer
# ---------------------------------------------------------------------------

CANCER_VAF = 0.25


def cancer_input(tmp, kb=100, depth=60, seed=7, vaf=CANCER_VAF):
    """(fasta, [NORMAL, TUMOUR] BAMs, (germline, somatic positions)): the
    normal at depth // 2, the tumour at depth with a somatic clone at read
    fraction 2 * vaf."""
    fa, bam_n, bam_t, germline, somatic, _ = synthetic.simulate_tumour_normal(
        tmp, kb=kb, depth=depth, seed=seed, vaf=vaf, min_gap=51)
    return fa, [bam_n, bam_t], (set(germline), set(somatic))


def cancer_result(out, truth, kb, depth, wall, vaf=CANCER_VAF):
    _, somatic = truth
    recs = _pass_records(out)
    som_called = {r.pos - 1 for r in recs if r.info.get("SOMATIC")}
    tp = sum(1 for p in somatic if _near(som_called, p))
    fp = sum(1 for p in som_called if not _near(somatic, p))
    som_recs = [r for r in _all_records(out) if r.info.get("SOMATIC")]
    pp_cal = qual_calibration(som_recs, {p: None for p in somatic}, field="PP")
    return {
        "metric": "e2e_cancer_somatic", "kb": kb, "depth": depth, "vaf": vaf,
        "wall_s": round(wall, 1),
        "n_somatic": len(somatic),
        "somatic_recall": round(tp / len(somatic), 4),
        "somatic_fp": fp,
        "somatic_pp_calibration": pp_cal,
    }


# ---------------------------------------------------------------------------
# population
# ---------------------------------------------------------------------------

def population_input(tmp, kb=100, depth=30, seed=9, n_samples=3):
    """(fasta, [S0, S1, ...] BAMs, {pos: per-sample [hap0, hap1] alt
    flags})."""
    fa, bams, truth, _ = synthetic.simulate_population(
        tmp, kb=kb, depth=depth, seed=seed, n_samples=n_samples)
    return fa, bams, truth


def population_result(out, truth, kb, depth, wall):
    recs = _pass_records(out)
    called = {r.pos - 1 for r in recs} | {r.pos for r in recs}
    tp = sum(1 for p in truth if _near(called, p))
    fp = sum(1 for r in recs
             if not _near(set(truth), r.pos - 1) and not _near(set(truth), r.pos))
    # genotype concordance at matched sites
    gt_ok = gt_tot = 0
    truth_pos = sorted(truth)
    n_samples = len(next(iter(truth.values()))) if truth else 0
    for r in recs:
        p0 = r.pos - 1
        match = [q for q in truth_pos if abs(q - p0) <= 5]
        if not match:
            continue
        gts = truth[match[0]]
        for s_, sv in enumerate(r.sample_values[:len(gts)]):
            gt_str = sv.get("GT", ".").replace("|", "/")
            try:
                got = sorted(int(x) > 0 for x in gt_str.split("/"))
            except ValueError:
                continue
            gt_tot += 1
            gt_ok += got == sorted(bool(x) for x in gts[s_])
    return {
        "metric": "e2e_population_joint", "kb": kb, "depth": depth,
        "n_samples": n_samples, "wall_s": round(wall, 1),
        "n_truth": len(truth),
        "recall": round(tp / max(len(truth), 1), 4),
        "fp": fp,
        "gt_concordance": round(gt_ok / max(gt_tot, 1), 4),
    }


# ---------------------------------------------------------------------------
# polyclone
# ---------------------------------------------------------------------------

POLYCLONE_FRACTIONS = (0.5, 0.3, 0.2)


def polyclone_input(tmp, kb=50, depth=120, seed=13,
                    fractions=POLYCLONE_FRACTIONS):
    """Polyclonal haploid mixture (mixed infection): clones at uneven
    fractions with shared (trunk) and private variants, in one pooled BAM.
    Mirrors the reference's polyclone use-case (polyclone_caller.cpp:92-110
    clonality k-sweep). Returns (fasta, [POOL BAM], (trunk positions,
    {private position: clone}, clone count))."""
    rng = np.random.default_rng(seed)
    n = kb * 1000
    seq = random_sequence(rng, n)
    fa = write_reference(tmp, seq)
    n_clones = len(fractions)
    clones = [[list(seq)] for _ in range(n_clones)]     # haploid: 1 hap each
    trunk, private = set(), {}                          # pos -> clone idx
    pos = 1500
    while pos < n - 1500:
        pos += int(rng.integers(800, 2000))
        if pos >= n - 1500:
            break
        kind = random_variant(rng, seq, pos)
        if rng.random() < 0.4:                          # trunk: all clones
            for c in clones:
                apply_variant(c, pos, kind, (0,), seq)
            trunk.add(pos)
        else:                                           # private to one clone
            ci = int(rng.integers(0, n_clones))
            apply_variant(clones[ci], pos, kind, (0,), seq)
            private[pos] = ci
    flats = [flatten_haplotype(c[0]) for c in clones]
    reads = mixture_reads(flats, fractions, int(n * depth / 150), 150, rng)
    bam = write_reads_bam(tmp, "POOL", reads, "chr1", n)
    return fa, [bam], (trunk, private, n_clones)


def polyclone_result(out, truth, kb, depth, wall,
                     fractions=POLYCLONE_FRACTIONS):
    trunk, private, n_clones = truth
    recs = _all_records(out)
    called = {r.pos - 1 for r in recs} | {r.pos for r in recs}
    trunk_tp = sum(1 for p in trunk if _near(called, p))
    priv_tp = sum(1 for p in private if _near(called, p))
    # recall of the minor clone's private variants (hardest: VAF = min frac)
    minor = [p for p, ci in private.items() if ci == n_clones - 1]
    minor_tp = sum(1 for p in minor if _near(called, p))
    truth_all = trunk | set(private)
    fp = sum(1 for r in recs
             if not _near(truth_all, r.pos - 1) and not _near(truth_all, r.pos))
    clones_info = [r.info.get("CLONES") for r in recs if r.info.get("CLONES")]
    k_mode = Counter(clones_info).most_common(1)[0][0] if clones_info else 0
    return {
        "metric": "e2e_polyclone", "kb": kb, "depth": depth,
        "fractions": list(fractions), "wall_s": round(wall, 1),
        "n_trunk": len(trunk), "n_private": len(private),
        "trunk_recall": round(trunk_tp / max(len(trunk), 1), 4),
        "private_recall": round(priv_tp / max(len(private), 1), 4),
        "minor_clone_recall": round(minor_tp / max(len(minor), 1), 4),
        "fp": fp, "clones_mode": int(k_mode),
    }


# ---------------------------------------------------------------------------
# cell
# ---------------------------------------------------------------------------

def cell_input(tmp, kb=30, n_cells=8, depth=12, seed=17):
    """Single cells from a known clone phylogeny with allelic dropout.
    Phylogeny: founder (germline hets) -> clone A (+somatics) -> clone B
    (+more somatics); cells split across the three clones. Mirrors the
    reference's CellCaller (cell_caller.cpp:103-135, single_cell_model).
    Returns (fasta, one BAM a cell, (germline, clone A somatics, clone B
    somatics, clone of each cell))."""
    rng = np.random.default_rng(seed)
    n = kb * 1000
    seq = random_sequence(rng, n)
    fa = write_reference(tmp, seq)
    founder = [list(seq), list(seq)]
    germline = set()
    pos = 1500
    while pos < n - 1500:
        pos += int(rng.integers(1000, 2500))
        if pos >= n - 1500:
            break
        kind = random_variant(rng, seq, pos)
        apply_variant(founder, pos, kind,
                (0, 1) if rng.random() < 0.3 else (int(rng.random() < 0.5),),
                seq)
        germline.add(pos)
    # clone A: founder + somatic SNVs on hap 0; clone B: A + more somatics
    clone_a = [list(founder[0]), list(founder[1])]
    som_a, som_b = set(), set()
    for _ in range(5):
        pos = int(rng.integers(2000, n - 2000))
        if _near(germline, pos, 50) or _near(som_a, pos, 50):
            continue
        clone_a[0][pos] = "ACGT"[("ACGT".index(seq[pos]) + 2) % 4]
        som_a.add(pos)
    clone_b = [list(clone_a[0]), list(clone_a[1])]
    for _ in range(4):
        pos = int(rng.integers(2000, n - 2000))
        if _near(germline | som_a, pos, 50) or _near(som_b, pos, 50):
            continue
        clone_b[0][pos] = "ACGT"[("ACGT".index(seq[pos]) + 1) % 4]
        som_b.add(pos)
    clone_of_cell = ([0] * (n_cells - n_cells // 2 - n_cells // 4)
                     + [1] * (n_cells // 2) + [2] * (n_cells // 4))
    clone_haps = [founder, clone_a, clone_b]
    bams = []
    for ci in range(n_cells):
        haps = clone_haps[clone_of_cell[ci]]
        flats = [flatten_haplotype(h) for h in haps]
        # allelic dropout: per-cell haplotype sampling weights (WGA
        # amplification bias): some cells are mostly one hap
        w0 = float(rng.beta(2.0, 2.0))
        reads = mixture_reads(flats, [w0, 1 - w0], int(n * depth / 150), 150,
                              rng)
        bams.append(write_reads_bam(tmp, f"CELL{ci}", reads, "chr1", n))
    return fa, bams, (germline, som_a, som_b, clone_of_cell)


def cell_result(out, truth, kb, depth, wall):
    germline, som_a, som_b, clone_of_cell = truth
    recs = _all_records(out)
    som_truth = som_a | som_b
    som_called = {r.pos - 1 for r in recs if r.info.get("SOMATIC")}
    called_all = {r.pos - 1 for r in recs} | {r.pos for r in recs}
    germ_tp = sum(1 for p in germline if _near(called_all, p))
    som_tp = sum(1 for p in som_truth if _near(som_called, p))
    som_tp_any = sum(1 for p in som_truth if _near(called_all, p))
    truth_all = germline | som_truth
    fp = sum(1 for r in recs
             if not _near(truth_all, r.pos - 1) and not _near(truth_all, r.pos))
    # somatic cell-count sanity: CELLS should approximate the number of
    # cells carrying the somatic clone (A+B for som_a, B only for som_b)
    n_a = sum(1 for c in clone_of_cell if c >= 1)
    n_b = sum(1 for c in clone_of_cell if c == 2)
    cells_err = []
    for r in recs:
        if r.info.get("SOMATIC") and r.info.get("CELLS") is not None:
            p = r.pos - 1
            want = n_a if _near(som_a, p) else (n_b if _near(som_b, p) else None)
            if want:
                cells_err.append(abs(int(r.info["CELLS"]) - want))
    return {
        "metric": "e2e_cell_phylogeny", "kb": kb,
        "n_cells": len(clone_of_cell), "depth": depth,
        "wall_s": round(wall, 1),
        "n_germline": len(germline), "n_somatic": len(som_truth),
        "germline_recall": round(germ_tp / max(len(germline), 1), 4),
        "somatic_recall": round(som_tp / max(len(som_truth), 1), 4),
        "somatic_called_any": round(som_tp_any / max(len(som_truth), 1), 4),
        "fp": fp,
        "mean_cells_err": (round(float(np.mean(cells_err)), 2)
                           if cells_err else None),
    }


# mode -> (input, the CLI arguments it adds, result)
MODES = {
    "trio": (trio_input, ["-M", "MOM", "-F", "DAD"], trio_result),
    "cancer": (cancer_input, ["--caller", "cancer", "--normal-sample",
                              "NORMAL"], cancer_result),
    "population": (population_input, ["--caller", "population"],
                   population_result),
    "polyclone": (polyclone_input, ["--caller", "polyclone", "--max-clones",
                                    "4", "--organism-ploidy", "1"],
                  polyclone_result),
    "cell": (cell_input, ["--caller", "cell", "--max-phylogeny-size", "3"],
             cell_result),
}


def mode_sizes(mode, kb=100, depth=30) -> dict:
    """The input sizes main gives `mode`: trio and population at kb and
    depth, cancer at kb and at least 60x, polyclone and cell at their own
    (50 kb at 120x; 30 kb, 8 cells at 12x)."""
    if mode == "polyclone":
        return {"kb": 50, "depth": 120}
    if mode == "cell":
        return {"kb": 30, "depth": 12}
    return {"kb": kb, "depth": max(depth, 60) if mode == "cancer" else depth}


def bench(mode, tmp, device="cuda", kb=100, depth=30) -> dict:
    """One mode at mode_sizes(mode, kb, depth): its input written to the
    directory `tmp`, the CLI timed, the VCF scored. Returns the mode's
    JSON line."""
    make_input, argv, result = MODES[mode]
    sizes = mode_sizes(mode, kb, depth)
    fa, bams, truth = make_input(tmp, **sizes)
    out = os.path.join(tmp, f"{mode}.vcf")
    t0 = time.time()
    _run_cli(fa, bams, out, argv, device)
    wall = time.time() - t0
    line = result(out, truth, sizes["kb"], sizes["depth"], wall)
    line.update({"n_compiles": None, "compile_s": None,
                 "warm_compiles": None})
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("mode", nargs="?", default="all",
                   choices=["all", *MODES])
    p.add_argument("kb", nargs="?", type=int, default=100)
    p.add_argument("depth", nargs="?", type=int, default=30)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    from .device import resolve_device
    resolve_device(args.device)
    for name in MODES:
        if args.mode not in ("all", name):
            continue
        tmp = tempfile.mkdtemp(prefix=f"bench_{name}_")
        try:
            result = bench(name, tmp, args.device, args.kb, args.depth)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
