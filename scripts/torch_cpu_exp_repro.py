#!/usr/bin/env python3
"""Whether a --device cpu run of the port gives the same bits in every
process: its records, and the exp of its genotype reduction by torch and by
vb_math.

    python scripts/torch_cpu_exp_repro.py [--runs 16] [--parallel 4]

Simulates a 24 kb diploid at 30x (simulate_diploid, seed 5, spacing
150-450) and calls chr1:20000-24000 with the port's CLI on the CPU in
--runs fresh interpreters, --parallel at a time (a loaded host is where the
bits moved). That window holds one genotype reduction above HOST_GATE
(128 haplotypes x 319 reads). Each interpreter prints, for that reduction,
a hash of torch.exp(lnL - m) and of vb_math.fexp(lnL - m), and a hash of
the record lines. Prints one JSON object: how many distinct hashes of each
the runs gave, and the QUALs of chr1:21143 they wrote; before it, one
line a run.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def child(fa: str, bam: str, out: str) -> None:
    import torch
    from octopus_tpu_torch import cli
    from octopus_tpu_torch.core.models import genotype_likelihoods as gl
    from octopus_tpu_torch.core.models.vb_math import fexp
    seen = {}
    real = gl.genotype_log_likelihoods_torch

    def recording(lnL, counts, ploidy):
        m = torch.amax(lnL, dim=0)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        x = lnL - m[None, :]
        for name, fn in (("torch_exp", torch.exp), ("vb_math_fexp", fexp)):
            seen[name] = hashlib.md5(fn(x).numpy().tobytes()).hexdigest()
        return real(lnL, counts, ploidy)

    gl.genotype_log_likelihoods_torch = recording
    rc = cli.main(["-R", fa, "-I", bam, "-o", out, "--device", "cpu",
                   "-T", "chr1:20000-24000"])
    lines = [line for line in open(out) if not line.startswith("#")]
    qual = [line.split("\t")[5] for line in lines
            if line.startswith("chr1\t21143\t")]
    print(json.dumps({"rc": rc, **seen, "qual_21143": qual,
                      "records": hashlib.md5("".join(lines).encode())
                      .hexdigest()}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=16)
    ap.add_argument("--parallel", type=int, default=4)
    ap.add_argument("--child", nargs=3, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        child(*a.child)
        return 0
    from octopus_tpu_torch.utils.synthetic import simulate_diploid
    tmp = tempfile.mkdtemp(prefix="cpu_exp_repro_")
    fa, bam, _, _ = simulate_diploid(tmp, kb=24, depth=30, seed=5,
                                     spacing=(150, 450))
    rows = []
    for start in range(0, a.runs, a.parallel):
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--child", fa, bam,
             os.path.join(tmp, f"run{i}.vcf")],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
            for i in range(start, min(start + a.parallel, a.runs))]
        for p in procs:
            out, _ = p.communicate(timeout=1800)
            rows.append(json.loads(out.strip().splitlines()[-1]))
            print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({
        "runs": len(rows), "parallel": a.parallel,
        "cpu_count": os.cpu_count(),
        **{f"distinct_{k}": len({r[k] for r in rows})
           for k in ("torch_exp", "vb_math_fexp", "records")},
        "qual_21143": dict(collections.Counter(
            ",".join(r["qual_21143"]) for r in rows))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
