#!/usr/bin/env python3
"""Random-forest filter training pipeline.

Capability-equivalent to the reference's scripts/forest.smk (Snakemake +
GIAB truth + rtg vcfeval + ranger): produce an annotated call set, label
each call against a truth VCF, and train the call-quality forest consumed
by --forest-model.

Two modes:

  1. From existing data:
       train_forest.py --annotated calls.vcf --truth truth.vcf -o out.forest
     where calls.vcf came from an octopus-tpu(-torch) run with
     --disable-call-filtering --annotations <measures...>.

  2. Fully synthetic (no external data; used to build the shipped
     resources/forests models):
       train_forest.py --synthetic --kb 200 --depth 30 -o out.forest

The measure sets default to the reference's forest.smk germline/somatic
lists (forest.smk:10-11), intersected with what the annotated VCF carries.

The port's counterpart of the reference repository's scripts/train_forest.py:

    python -m octopus_tpu_torch.scripts.train_forest --synthetic --kb 200
        --depth 30 -o out.forest [--device cuda|cpu]

The synthetic mode calls through the port's CLI on --device (default
cuda, which raises without a card).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

# forest.smk:10-11 default measure lists
GERMLINE_MEASURES = (
    "AC AD ADP AF AFB ARF BMQ BQ CC CRF DAD DAF DC DENOVO DP DPC ER ERS FRF "
    "GC GQ GQD ITV MC MF MHL MP MRC MQ MQ0 MQD PLN PP PPD QD QUAL REB RSB "
    "RTB SB SD SF STRL STRP VL").split()
SOMATIC_MEASURES = (
    "AC AD ADP AF ARF BMQ BQ CC CRF DAD DAF DP DPC ER ERS FRF GC GQ GQD ITV "
    "NC MC MF MHL MP MRC MQ MQ0 MQD PLN PP PPD QD QUAL REB RSB RTB SB SD SF "
    "SHC SMQ SOMATIC STRL STRP VL").split()


def synthesize_annotated(kb: int, depth: int, seed: int, measures: list[str],
                         tmpdir: str, fp_rate: float = 0.35, err: float = 0.001,
                         device: str = "cuda"):
    """Run the caller in annotation mode on a simulated sample.

    To give the forest negative examples, a fraction of extra false
    candidates is injected via --source-candidates (decoy variants absent
    from the sample's haplotypes), mirroring how real training data contains
    vcfeval-labelled FPs.
    """
    from ..config.options import build_parser
    from ..run import run_calling
    from ..utils.synthetic import random_variant, simulate_diploid, truth_to_vcf

    fa, bam, truth, n = simulate_diploid(tmpdir, kb=kb, depth=depth,
                                         seed=seed, err=err)
    seq = "".join(
        line.strip() for line in open(fa) if not line.startswith(">"))
    truth_vcf = truth_to_vcf(truth, seq, os.path.join(tmpdir, "truth.vcf"))

    # decoy candidates: random variants nowhere near truth sites
    rng = np.random.default_rng(seed + 1)
    decoys = {}
    tried = 0
    target = max(4, int(len(truth) * fp_rate / max(1e-9, 1 - fp_rate)))
    while len(decoys) < target and tried < 50 * target:
        tried += 1
        pos = int(rng.integers(1500, n - 1500))
        if any(abs(pos - t) < 50 for t in truth) or pos in decoys:
            continue
        decoys[pos] = (random_variant(rng, seq, pos), "het")
    decoy_vcf = truth_to_vcf(decoys, seq, os.path.join(tmpdir, "decoys.vcf"))

    out = os.path.join(tmpdir, "annotated.vcf")
    args = build_parser().parse_args([
        "-R", fa, "-I", bam, "-o", out, "-T", "chr1",
        "--disable-call-filtering", "--annotations", *measures,
        "--source-candidates", decoy_vcf, "--device", device,
    ])
    run_calling(args)
    return out, truth_vcf


def synthesize_annotated_somatic(kb: int, depth: int, seed: int,
                                 measures: list[str], tmpdir: str,
                                 err: float = 0.001, device: str = "cuda"):
    """Cancer-caller annotation run on a simulated tumour-normal pair.

    Training rows for the somatic forest are the SOMATIC-flagged calls,
    labelled against the simulated somatic truth."""
    from ..config.options import build_parser
    from ..run import run_calling
    from ..utils.synthetic import simulate_tumour_normal, truth_to_vcf

    fa, bam_n, bam_t, germline, somatic, n = simulate_tumour_normal(
        tmpdir, kb=kb, depth=depth, seed=seed, err=err)
    seq = "".join(
        line.strip() for line in open(fa) if not line.startswith(">"))
    truth_vcf = truth_to_vcf(somatic, seq, os.path.join(tmpdir, "somatic_truth.vcf"))
    out = os.path.join(tmpdir, "annotated.vcf")
    args = build_parser().parse_args([
        "-R", fa, "-I", bam_n, bam_t, "-o", out, "-T", "chr1",
        "--caller", "cancer", "--normal-sample", "NORMAL",
        "--disable-call-filtering", "--annotations", *measures,
        "--device", device,
    ])
    run_calling(args)
    # keep only somatic-flagged records for the somatic forest
    from ..io.vcf import VcfReader, VcfWriter
    reader = VcfReader(out)
    som_out = os.path.join(tmpdir, "annotated_somatic.vcf")
    header = reader.header
    with VcfWriter(som_out, header) as w:
        for rec in reader:
            if rec.info.get("SOMATIC"):
                w.write(rec)
    return som_out, truth_vcf


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--annotated", nargs="*", default=[],
                   help="annotated VCF(s) from --disable-call-filtering runs")
    p.add_argument("--truth", nargs="*", default=[],
                   help="truth VCF(s), one per annotated VCF")
    p.add_argument("--synthetic", action="store_true",
                   help="simulate training data instead")
    p.add_argument("--kb", type=int, default=200)
    p.add_argument("--depth", type=int, default=30)
    p.add_argument("--seeds", type=int, nargs="*", default=[101, 202, 303])
    p.add_argument("--somatic", action="store_true",
                   help="use the somatic measure set")
    p.add_argument("--measures", nargs="*", default=None)
    p.add_argument("--trees", type=int, default=100)
    p.add_argument("--max-depth", type=int, default=12)
    p.add_argument("--csv", default=None, help="also dump the measure table")
    p.add_argument("-o", "--output", required=True, help=".forest output")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where --synthetic's calling runs")
    args = p.parse_args(argv)

    from ..core.csr.random_forest import train_forest
    from ..core.csr.training import extract_measure_table, label_against_truth

    measures = args.measures or (
        SOMATIC_MEASURES if args.somatic else GERMLINE_MEASURES)

    pairs: list[tuple[str, str]] = []
    if args.synthetic:
        from ..device import resolve_device
        resolve_device(args.device)
        # alternate clean and noisy replicates: the noisy ones (higher
        # sequencing error, half depth) are where the caller makes the FP
        # mistakes the forest must learn to reject
        for k, seed in enumerate(args.seeds):
            tmp = tempfile.mkdtemp(prefix=f"forest_train_{seed}_")
            noisy = k % 2 == 1
            if args.somatic:
                pairs.append(synthesize_annotated_somatic(
                    args.kb, max(16, args.depth // 2) if noisy else args.depth,
                    seed, measures, tmp, err=0.008 if noisy else 0.001,
                    device=args.device))
            else:
                pairs.append(synthesize_annotated(
                    args.kb, max(8, args.depth // 2) if noisy else args.depth,
                    seed, measures, tmp, err=0.01 if noisy else 0.001,
                    device=args.device))
    if args.annotated:
        if len(args.annotated) != len(args.truth):
            p.error("--annotated and --truth must pair up")
        pairs += list(zip(args.annotated, args.truth))
    if not pairs:
        p.error("nothing to train on: pass --synthetic or --annotated/--truth")

    names = None
    X_parts, y_parts = [], []
    for annotated_vcf, truth_vcf in pairs:
        names, X, keys = extract_measure_table(
            annotated_vcf, measures=names or measures, csv_path=None)
        y = label_against_truth(keys, truth_vcf)
        X_parts.append(X)
        y_parts.append(y)
        print(f"{annotated_vcf}: {len(y)} calls, "
              f"{int(y.sum())} TP / {int((1 - y).sum())} FP", file=sys.stderr)
    X = np.vstack(X_parts)
    y = np.concatenate(y_parts)
    # drop measures that are entirely missing in this data
    keep = ~np.all(np.isnan(X), axis=0)
    names = [nm for nm, k in zip(names, keep) if k]
    X = X[:, keep]
    X = np.nan_to_num(X, nan=-1.0)
    if args.csv:
        import csv as _csv
        with open(args.csv, "w", newline="") as fh:
            w = _csv.writer(fh)
            w.writerow([*names, "TP"])
            for row, lab in zip(X, y):
                w.writerow([*row, int(lab)])

    forest = train_forest(X, y.astype(np.int64), names,
                          n_trees=args.trees, max_depth=args.max_depth)
    forest.save(args.output)
    proba = forest.predict_proba(X)
    acc = float(((proba > 0.5) == (y > 0)).mean())
    print(f"trained {args.trees} trees on {len(y)} calls "
          f"({len(names)} measures); train accuracy {acc:.3f}; "
          f"saved {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
