#!/usr/bin/env python3
"""One window of the germline cell, captured and held against the plain
reference `benchmark/reference/germline.py` (PyTorch float64 on the CPU).

    python3 scripts/torch_germline_capture.py [--seed N] [--contig-kb KB]
        [--sample P] [--device cuda|cpu] [--out FILE]

Makes the inputs of `germline-illumina35x.wgs` for the seed (the cell's
configuration and traffic; `--contig-kb` cuts the contig), then calls
every measured shard once through the CLI's path, as the benchmark's
window does, on `--device`. While it runs it captures:

* a seeded sample (each with probability `--sample`) of the individual
  model's genotype reductions, with lnL and the genotypes, on the host
  (float64) and on the card (float32) alike, and compares each with the
  reference's: within 1e-9 relative on the host, within the reference's
  derived `float32_bound` on the card;
* every read assignment's likelihood matrix, and at every call of CSR's
  allele depth (`FacetBundle.allele_support_context`) each sample's tie
  sets, AD and ADP and the tied reads credited, compared exactly with the
  reference's from the same matrix.

Prints one JSON line (appended to --out too): the counts compared, the
mismatches, the largest errors, the card's name and power limit. Exits 1
on a mismatch. Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
CELL = "germline-illumina35x.wgs"


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=3_000_000_011)
    p.add_argument("--contig-kb", type=int, default=None)
    p.add_argument("--sample", type=float, default=0.05)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from benchmark import bamfile, cell, simulate
    from benchmark.reference import germline as ref
    from octopus_tpu_torch import run as program
    from octopus_tpu_torch.config import options
    from octopus_tpu_torch.core.csr import facets
    from octopus_tpu_torch.core.likelihood import likelihood_array
    from octopus_tpu_torch.core.models import genotype_likelihoods, individual
    from octopus_tpu_torch.core.tools import read_assigner

    _, config, traffic = cell.load_cell(cell.load_spec(), CELL)
    if args.contig_kb:
        traffic = {**traffic, "contig_kb": args.contig_kb}
    rng = np.random.default_rng([args.seed, 2])
    stats = {"reductions_host": 0, "reductions_card": 0,
             "host_max_rel": 0.0, "card_max_of_bound": 0.0,
             "card_max_abs": 0.0, "reduction_mismatches": 0,
             "card_underflow": 0, "support_calls": 0, "samples": 0,
             "tied_reads": 0, "tie_mismatches": 0, "depth_mismatches": 0,
             "credited_port": 0, "credited_reference": 0,
             "ad_total": 0, "adp_total": 0}

    real_reduce = individual.genotype_log_likelihoods

    def reduce(lnL, genotypes, use_device=True, device="cuda"):
        out = real_reduce(lnL, genotypes, use_device=use_device, device=device)
        if rng.random() >= args.sample:
            return out
        want = ref.genotype_log_likelihoods(lnL, genotypes).numpy()
        if genotype_likelihoods.runs_on_device(lnL, genotypes, use_device):
            stats["reductions_card"] += 1
            # the bound holds where no exp(lnL - m) underflows float32
            if (lnL - lnL.max(axis=0)).min() <= -87:
                stats["card_underflow"] += 1
            bound = ref.float32_bound(lnL, genotypes).numpy()
            err = np.abs(out - want)
            stats["card_max_abs"] = max(stats["card_max_abs"], float(err.max()))
            stats["card_max_of_bound"] = max(stats["card_max_of_bound"],
                                             float((err / bound).max()))
            stats["reduction_mismatches"] += int((err > bound).any())
        else:
            stats["reductions_host"] += 1
            rel = np.abs(out - want) / np.maximum(np.abs(want), 1e-300)
            stats["host_max_rel"] = max(stats["host_max_rel"], float(rel.max()))
            stats["reduction_mismatches"] += int((rel > 1e-9).any())
        return out

    matrices: dict = {}
    real_assign = read_assigner._assignment_from_matrix

    def assign(lnL, unique_haps, ambiguous_margin=1e-9):
        a = real_assign(lnL, unique_haps, ambiguous_margin)
        matrices[id(a)] = (a, np.array(lnL))
        return a

    real_support = facets.FacetBundle.allele_support_context

    def support(self, variant):
        before = likelihood_array.ROUTING.tied_reads_credited
        out = real_support(self, variant)
        stats["support_calls"] += 1
        stats["credited_port"] += likelihood_array.ROUTING.tied_reads_credited - before
        for b, a, haps, (ad, adp) in zip(self.overlapping_reads,
                                         self.read_assignments,
                                         self.called_haplotypes_by_sample, out):
            if a is None or not len(b):
                continue
            _, lnL = matrices[id(a)]
            alt, refs = facets._site_haplotypes(haps, variant)
            over = facets._overlapping(b, variant)
            ties = ref.tie_sets(lnL).numpy()
            stats["samples"] += 1
            stats["tied_reads"] += int((over & (ties.sum(axis=0) > 1)).sum())
            stats["tie_mismatches"] += int(not np.array_equal(ties, a.ties))
            want = ref.allele_depths(lnL, alt, refs, over)
            stats["depth_mismatches"] += int((ad, adp) != want[:2])
            stats["credited_reference"] += want[2]
            stats["ad_total"] += ad
            stats["adp_total"] += adp
        return out

    individual.genotype_log_likelihoods = reduce
    read_assigner._assignment_from_matrix = assign
    facets.FacetBundle.allele_support_context = support

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="capture_") as work:
        inputs = simulate.simulate(config, traffic, args.seed)
        fasta = os.path.join(work, "ref.fa")
        bamfile.write_fasta(fasta, cell.CONTIG, inputs.reference)
        bams = []
        for s in inputs.samples:
            path = os.path.join(work, f"{s.name}.bam")
            bamfile.write_bam(path, cell.CONTIG, len(inputs.reference), s,
                              inputs.base_qual, inputs.mapq)
            bams.append(path)
        _, measured = cell.shards_of(traffic, len(inputs.reference))
        likelihood_array.ROUTING.reset()
        genotype_likelihoods.COUNTS.reset()
        for begin, end in measured:
            argv = ["-R", fasta, "-I", *bams, "-o",
                    os.path.join(work, f"shard{begin}.vcf"),
                    "-T", f"{cell.CONTIG}:{begin}-{end}",
                    "--device", args.device, *config.get("caller_args", [])]
            program.run_calling(options.parse_args_with_config(argv))
            matrices.clear()
    line = {"capture": CELL, "seed": args.seed, "device": args.device,
            "card": card() if args.device == "cuda" else "",
            "torch": torch.__version__,
            "shards": len(measured), "seconds": round(time.perf_counter() - t0, 1),
            "reductions_all": vars(genotype_likelihoods.COUNTS).copy(),
            "credited_counter": likelihood_array.ROUTING.tied_reads_credited,
            **stats}
    ok = (stats["reduction_mismatches"] == 0 and stats["tie_mismatches"] == 0
          and stats["depth_mismatches"] == 0 and stats["card_underflow"] == 0
          and stats["credited_port"] == stats["credited_reference"]
          and stats["samples"] > 0 and stats["reductions_host"] > 0)
    line["ok"] = ok
    print(json.dumps(line), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write(json.dumps(line) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
