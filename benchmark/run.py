"""Runs one cell of the port's benchmark once, on one NVIDIA card.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object: `correct`,
`attempted` (shards started in the window), `failed`, `pass_complete`
(whether the window called every measured shard before its cap),
`metrics` (with `--trace 0` the cell's end-to-end metrics, with
`--trace 1` its per-layer ones), `device`, with `--trace 1` a `breakdown`, and last `checks`, each
number compared with its limit (also the last lines of standard error).
It exits 1 and prints no result without a CUDA card, when the cell needs
more cards than there are, or when a module of JAX or of the JAX package
was loaded. Build caches stay inside the checkout; inputs go under TMPDIR.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "bench_cache"


def host_threads(workload: str):
    """The host threads the cell's configuration states (`host_threads`),
    or None where the cell or the key is missing."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    files = {c["name"]: c["file"] for c in spec["configs"]}
    if workload not in cells:
        return None
    config = json.loads((ROOT / files[cells[workload]["config"]]).read_text())
    return config.get("host_threads")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # the deployment's host threads for torch, OpenMP and BLAS, set before
    # any of them loads
    threads = host_threads(args.workload)
    if threads is not None:
        for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
            os.environ[var] = str(int(threads))

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))

    from benchmark import cell

    spec = cell.load_spec(ROOT)
    chips = next((w["chips"] for w in spec["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    result = cell.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), started=STARTED, spec=spec)
    found = cell.forbidden_modules()
    if found:
        print(f"loaded, and no run may: {found}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
