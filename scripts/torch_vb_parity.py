#!/usr/bin/env python3
"""The cancer CLI of the port against the reference's, ELBO by ELBO, on the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_vb_parity.py --kb 100 [--out DIR]

Simulates the tumour-normal pair of chip_smoke.py's cancer phase
(simulate_tumour_normal(kb, depth=60, seed=7, vaf=0.25)), runs the
reference CLI (octopus_tpu, JAX on the CPU) and the port's CLI
(octopus_tpu_torch, --device cpu) with --caller cancer --normal-sample
NORMAL, and records every SubcloneModel.evaluate of each: its genotype log
evidences (the best seed's float32 ELBO of each genotype). Prints one JSON
object: evaluations and ELBOs of each side, ELBOs bit-equal between the
two (evaluations paired in call order, where the genotype counts agree),
the largest difference in float32 ulps, the count of record lines that
differ and the lines themselves, how far the port's own ELBOs move when its
sums in XLA:CPU's order are replaced by torch's (sum_order_probe, over the
first --probe evaluations), and each run's seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PINNED = ("OCTOPUS_TPU_HOST_HMM_MAX", "OCTOPUS_TPU_HOST_LATENTS")


def recording(model_class, into, calls=None):
    """Wrap model_class.evaluate so that each call appends its genotype log
    evidences to `into` (and, with `calls`, its arguments); returns the
    original to restore."""
    original = model_class.evaluate

    def evaluate(self, *args, **kwargs):
        inf = original(self, *args, **kwargs)
        into.append(np.asarray(inf.genotype_log_evidences, np.float64))
        if calls is not None:
            calls.append((self, args, kwargs))
        return inf

    model_class.evaluate = evaluate
    return original


def records(path):
    return [line for line in Path(path).read_text().splitlines()
            if not line.startswith("#")]


def ulps32(a, b):
    """Distance of float32 values in units in the last place."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kb", type=int, default=100)
    ap.add_argument("--out", default=None, help="directory for the BAMs and VCFs")
    ap.add_argument("--probe", type=int, default=40,
                    help="evaluations rerun with torch's own sums")
    args = ap.parse_args(argv)
    out = Path(args.out or tempfile.mkdtemp(prefix="vb_parity_"))
    out.mkdir(parents=True, exist_ok=True)

    from octopus_tpu import cli as ref_cli
    from octopus_tpu.core.models import subclone_vb as ref_vb
    from octopus_tpu_torch import cli
    from octopus_tpu_torch.core.models import subclone_vb
    from octopus_tpu_torch.utils import synthetic

    fa, bam_n, bam_t, _, _, _ = synthetic.simulate_tumour_normal(
        str(out), kb=args.kb, depth=60, seed=7, vaf=0.25)
    argv_common = ["-R", fa, "-I", bam_n, bam_t, "--caller", "cancer",
                   "--normal-sample", "NORMAL"]

    got = {"reference": [], "port": []}
    seconds = {}
    vcf = {"reference": str(out / "reference.vcf"), "port": str(out / "port.vcf")}
    saved = recording(ref_vb.SubcloneModel, got["reference"])
    t0 = time.perf_counter()
    try:
        assert ref_cli.main([*argv_common, "-o", vcf["reference"]]) == 0
    finally:
        ref_vb.SubcloneModel.evaluate = saved
    seconds["reference"] = time.perf_counter() - t0
    for k in PINNED:
        os.environ.pop(k, None)
    calls = []
    saved = recording(subclone_vb.SubcloneModel, got["port"], calls)
    t0 = time.perf_counter()
    try:
        assert cli.main([*argv_common, "-o", vcf["port"], "--device", "cpu"]) == 0
    finally:
        subclone_vb.SubcloneModel.evaluate = saved
    seconds["port"] = time.perf_counter() - t0

    equal = paired = 0
    max_ulps = 0
    max_abs = 0.0
    for a, b in zip(got["reference"], got["port"]):
        if a.shape != b.shape:
            continue
        paired += a.size
        equal += int((a == b).sum())
        max_ulps = max(max_ulps, int(ulps32(a, b).max(initial=0)))
        max_abs = max(max_abs, float(np.abs(a - b).max(initial=0.0)))
    # how far the summation order alone moves the port's ELBOs: the first
    # evaluations again, in the torch form (on the CPU vb_subclone is one
    # native call), with the subclone VB's sums over reads (XLA:CPU's
    # order) replaced by torch's own float32 sums
    engine = subclone_vb.vb_subclone
    fsum_xla, fdot = subclone_vb.fsum_xla, subclone_vb.fdot
    subclone_vb.vb_subclone = subclone_vb.vb_subclone_ops
    subclone_vb.fsum_xla = lambda x, dims=1: x.sum(tuple(range(-dims, 0)))
    subclone_vb.fdot = lambda a, b: (a * b).sum(-1)
    probe = {"evaluations": 0, "elbos": 0, "bit_equal": 0, "max_ulps": 0}
    try:
        for (model, a, kw), want in zip(calls[:args.probe], got["port"]):
            gle = np.asarray(model.evaluate(*a, **kw).genotype_log_evidences,
                             np.float64)
            probe["evaluations"] += 1
            probe["elbos"] += gle.size
            probe["bit_equal"] += int((gle == want).sum())
            probe["max_ulps"] = max(probe["max_ulps"],
                                    int(ulps32(gle, want).max(initial=0)))
    finally:
        subclone_vb.vb_subclone = engine
        subclone_vb.fsum_xla, subclone_vb.fdot = fsum_xla, fdot
    ref_lines, port_lines = records(vcf["reference"]), records(vcf["port"])
    differ = [[r, p] for r, p in zip(ref_lines, port_lines) if r != p]
    print(json.dumps({
        "kb": args.kb,
        "evaluations": {k: len(v) for k, v in got.items()},
        "elbos": {k: int(sum(x.size for x in v)) for k, v in got.items()},
        "elbos_paired": paired, "elbos_bit_equal": equal,
        "max_ulps": max_ulps, "max_abs_diff": max_abs,
        "records": {"reference": len(ref_lines), "port": len(port_lines)},
        "record_lines_differ": len(differ), "records_differ": differ,
        "sum_order_probe": probe,
        "seconds": seconds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
