#!/usr/bin/env python3
"""Two-pass long-range phasing driver.

Capability-equivalent to the reference's scripts/long_phase.py: pass 1 calls
variants normally; pass 2 re-runs the caller with the pass-1 VCF as the only
candidate source and aggressive lagging/backtracking, producing maximal
phase sets. Drives the port's CLI (in-process by default, so the kernels
are built and loaded once; --exec runs a subprocess instead, e.g.
octopus-tpu-torch).

    python -m octopus_tpu_torch.scripts.long_phase -R ref.fa -I reads.bam
        -o phased.vcf [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def build_cmd(args, extra: list[str]) -> list[str]:
    cmd = ["-R", args.reference, "-I", *args.reads, "--device", args.device]
    if args.regions:
        cmd += ["-T", *args.regions]
    if args.regions_file:
        cmd += ["--regions-file", args.regions_file]
    if args.threads is not None:
        cmd += ["--threads", str(args.threads)]
    if args.forest is not None:
        cmd += ["--forest-model", args.forest]
    if args.config is not None:
        cmd += ["--config", args.config]
    return cmd + extra


def run(cli_args: list[str], exec_path: str | None) -> None:
    if exec_path:
        subprocess.run([exec_path, *cli_args], check=True)
    else:
        from ..config.options import parse_args_with_config
        from ..run import run_calling
        run_calling(parse_args_with_config(cli_args))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-R", "--reference", required=True)
    p.add_argument("-I", "--reads", nargs="+", required=True)
    p.add_argument("-T", "--regions", nargs="*", default=None)
    p.add_argument("--regions-file", default=None)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--threads", type=int, default=None)
    p.add_argument("--forest", default=None)
    p.add_argument("--config", default=None)
    p.add_argument("--bamout", default=None)
    p.add_argument("--bamout-type", default=None)
    p.add_argument("--exec", dest="exec_path", default=None,
                   help="octopus-tpu-torch binary to subprocess "
                        "(default: in-process)")
    p.add_argument("--keep-intermediate", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    from ..device import resolve_device
    resolve_device(args.device)

    tmp_vcf = (args.output.replace(".vcf", ".tmp.vcf")
               if ".vcf" in args.output else args.output + ".tmp.vcf")

    # pass 1: standard calling
    run(build_cmd(args, ["-o", tmp_vcf]), args.exec_path)

    # pass 2: regenotype-and-phase over the pass-1 candidates only
    second = ["--disable-denovo-variant-discovery",
              "--source-candidates", tmp_vcf,
              "--lagging-level", "AGGRESSIVE",
              "--backtrack-level", "AGGRESSIVE",
              "-o", args.output]
    if args.bamout:
        second += ["--bamout", args.bamout]
        if args.bamout_type:
            second += ["--bamout-type", args.bamout_type]
    run(build_cmd(args, second), args.exec_path)

    if not args.keep_intermediate:
        for path in (tmp_vcf, tmp_vcf + ".tbi", tmp_vcf + ".gz",
                     tmp_vcf + ".gz.tbi"):
            if os.path.exists(path):
                os.remove(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
