"""One run of one cell: set-up, the measured window, the check, the line.

Everything a cell needs is found by name: the cell in BENCHMARK.json, its
configuration file, `traffic/<mix>.json` and, for a traced run, one reader
a per-layer metric in `metrics/<metric>.py`.

The window is one pass with one client: it calls every measured shard of
the contig once, in order, each through the CLI's own path
(`parse_args_with_config`, then `run_calling`, `-T` the shard, `--device`,
the configuration's caller arguments, all else at its default), back to
back. So every run, of any program, calls the same shards from the same
reads, and only the sequence drawn from the seed (`simulate.py`) and the
timing vary (a traffic with `reads_from_seed` draws its reads from the
seed too). `seconds` is a cap: no shard starts once it has passed (the
last one started runs to its end), and the result line and the window's
log say whether the pass completed (`pass_complete`), so that a rate over
a cut pass shows as one.

The check (`check.py`) runs once the window has closed, over samples of
bounded size, and the window's log gives its seconds from the window's
close to the verdict, less the profiler's stop in a traced run
(`check_s`). A traffic may carry `rehearsal` (`contig_kb`, `shard_kb`):
the size the tests rehearse its cells at on the CPU (`rehearsal_size`); a
run takes no notice of it.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import bamfile, check, devtrace, probes, simulate

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CONTIG = "chr1"
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "octopus_tpu"})
# the tests' CPU rehearsal of a cell whose traffic gives no `rehearsal`
REHEARSAL = {"contig_kb": 20, "shard_kb": 5}


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Top-level names in sys.modules that no run may load, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as fh:
        return json.load(fh)


def load_cell(spec: dict, workload: str, root: Path = ROOT):
    """(cell, configuration, traffic) of `workload`, each by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    with open(root / entry["file"]) as fh:
        config = json.load(fh)
    with open(BENCH / "traffic" / f"{cell['traffic']}.json") as fh:
        traffic = json.load(fh)
    return cell, config, traffic


def rehearsal_size(spec: dict, workload: str, root: Path = ROOT) -> dict:
    """The contig and shard the tests rehearse `workload` at on the CPU:
    its traffic's `rehearsal` (`contig_kb`, `shard_kb`) where it has one,
    else REHEARSAL."""
    traffic = load_cell(spec, workload, root)[2]
    return dict(traffic.get("rehearsal", REHEARSAL))


def metrics_of(spec: dict, kind: str, workload: str) -> list:
    return [m for m in spec[kind]
            if "workloads" not in m or workload in m["workloads"]]


def load_reader(name: str):
    """The `read` function of metrics/<name>.py."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def shards_of(traffic: dict, length: int) -> tuple:
    """(warm-up shard, measured shards) as (begin, end), zero-based half
    open: the contig's last shard warms up, the others are measured."""
    size = int(traffic["shard_kb"]) * 1000
    bounds = [(b, min(b + size, length)) for b in range(0, length, size)]
    return bounds[-1], bounds[:-1]


def one_pass(measured: list, seconds: float, call_one,
             clock=time.perf_counter_ns) -> tuple:
    """The window: `call_one(region)` for each measured shard once, in
    order, none started once `seconds` have passed since the window
    opened. Returns (the window's start, the end of its last shard, on
    `clock` in ns; each shard's seconds, from the end of the one before)."""
    t0 = last_end = clock()
    shard_s = []
    for region in measured:
        if (clock() - t0) / 1e9 >= seconds:
            break
        call_one(region)
        end = clock()
        shard_s.append(round((end - last_end) / 1e9, 3))
        last_end = end
    return t0, last_end, shard_s


@dataclass
class Reading:
    """What the per-layer readers read from a traced window."""

    self_s: dict                # span name -> self seconds
    called_mb: float
    window_s: float
    device: object              # devtrace.DeviceTrace
    launches: list              # (B, R, pad) of each card launch
    routing: dict               # host / card job sets and pairs
    kernel_launches: int


def card_info() -> dict:
    """nvidia-smi's name, power limit and SM clock of the card, or {}."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    if not out:
        return {}
    parts = [p.strip() for p in out[0].split(",")]
    return dict(zip(("name", "power_limit", "sm_clock"), parts))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", started: float | None = None,
             spec: dict | None = None, traffic_override: dict | None = None,
             controls: tuple = (), tmp_root: str | None = None) -> dict:
    """Run one cell once and return its result line (a dict), or raise.

    `started` is the process's start on perf_counter (set-up counts from
    it); `traffic_override` replaces traffic keys (the tests' small
    sizes); each of `controls` (check.CONTROLS, check.VB_CONTROLS) puts
    a reference in a narrower type in the program's place in one layer,
    judged on the same window, under the result's "controls"."""
    started = time.perf_counter() if started is None else started
    spec = spec or load_spec()
    cell, config, traffic = load_cell(spec, workload)
    traffic = {**traffic, **(traffic_override or {})}

    import torch

    from octopus_tpu_torch import _build
    from octopus_tpu_torch import run as program
    from octopus_tpu_torch.config import options
    from octopus_tpu_torch.core.likelihood import likelihood_array, pairhmm_batch
    from octopus_tpu_torch.core.models import genotype_likelihoods, subclone_vb
    from octopus_tpu_torch.utils import timers

    on_card = device == "cuda"
    native = _build.require_native() if on_card else _build.load_native()
    if on_card:
        pairhmm_batch.kernel_library(pairhmm_batch.scorer_name(torch.device(device)))

    work = tempfile.mkdtemp(prefix="bench_", dir=tmp_root or os.environ.get("TMPDIR"))
    try:
        inputs = simulate.simulate(config, traffic, seed)
        length = len(inputs.reference)
        fasta = os.path.join(work, "ref.fa")
        bamfile.write_fasta(fasta, CONTIG, inputs.reference)
        bams = []
        for sample in inputs.samples:
            path = os.path.join(work, f"{sample.name}.bam")
            bamfile.write_bam(path, CONTIG, length, sample, inputs.base_qual,
                              inputs.mapq)
            bams.append(path)
        warm, measured = shards_of(traffic, length)

        def call(region, out):
            argv = ["-R", fasta, "-I", *bams, "-o", out,
                    "-T", f"{CONTIG}:{region[0]}-{region[1]}",
                    "--device", device, *config.get("caller_args", [])]
            return program.run_calling(options.parse_args_with_config(argv))

        call(warm, os.path.join(work, "warm.vcf"))
        if on_card:
            torch.cuda.synchronize()

        capture = probes.Capture(rng=np.random.default_rng([seed, 1]))
        spans = probes.Spans() if trace else None
        prof = None
        card_before = card_info() if trace and on_card else {}
        if spans:
            spans.install(timers)
        capture.install(pairhmm_batch, native, timers, subclone_vb,
                        genotype_likelihoods)
        likelihood_array.ROUTING.reset()
        for counts in pairhmm_batch.KERNEL_COUNTS.values():
            counts.reset()
        subclone_vb.COUNTS.reset()
        genotype_likelihoods.COUNTS.reset()
        if trace and on_card:
            prof = devtrace.profiler()
            prof.__enter__()
        setup_s = time.perf_counter() - started
        capture.on = True
        failed = 0
        called: list = []           # (region, VCF path) of each shard that completed

        def call_one(region):
            nonlocal failed
            out = os.path.join(work, f"shard{region[0]}.vcf")
            try:
                if spans:
                    with spans.span("run_calling"):
                        call(region, out)
                else:
                    call(region, out)
                called.append((region, out))
            except Exception:       # a shard that fails counts and the pass goes on
                failed += 1
                log(f"shard {region} failed:\n{traceback.format_exc()}")
            if on_card:
                torch.cuda.synchronize()

        wall_offset = time.time_ns() - time.perf_counter_ns()
        t0, last_end, shard_s = one_pass(measured, seconds, call_one)
        attempted = len(shard_s)
        called_bp = sum(end - begin for (begin, end), _ in called)
        capture.on = False
        capture.finish()
        profiler_stop_ns = 0
        if prof is not None:
            stop = time.perf_counter_ns()
            prof.__exit__(None, None, None)
            profiler_stop_ns = time.perf_counter_ns() - stop
        capture.uninstall()
        if spans:
            spans.uninstall()
        window_ns = last_end - t0
        memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
        card = card_info() if on_card else {}
        routing = likelihood_array.ROUTING
        routing_counts = {"card_job_sets": routing.device_job_sets,
                          "card_pairs": routing.device_pairs,
                          "host_job_sets": routing.host_job_sets,
                          "host_pairs": routing.host_pairs}
        kernel_launches = pairhmm_batch.KERNEL_COUNTS["pairhmm"].launches
        all_launches = sum(c.launches for c in pairhmm_batch.KERNEL_COUNTS.values())
        vb_counts = vars(subclone_vb.COUNTS).copy()
        genotype_counts = vars(genotype_likelihoods.COUNTS).copy()

        # the check, once the window has closed
        called_mb = called_bp / 1e6
        shares, counts = check.records_shares(called, inputs.sites,
                                              inputs.reference)
        seen = check.unseen(capture, all_launches, routing)
        sample = check.pairhmm_sample(capture)
        reductions = capture.reductions()

        def numbers_of(control=None):
            hmm = check.pairhmm_gap(sample, control)
            vb = check.vb_gap(capture, config.get("vb"), subclone_vb.COUNTS,
                              control)
            gl = check.genotype_gap(reductions, genotype_likelihoods.COUNTS,
                                    capture.gl_calls, control)
            numbers = {"hmm_err": hmm["hmm_err"],
                       "hmm_pairs": hmm["host_pairs"] + hmm["card_pairs"],
                       "hmm_unseen": seen["hmm_unseen"],
                       "card_unchecked": int(routing.device_pairs > 0
                                             and hmm["card_pairs"] == 0),
                       **vb, **gl, **shares}
            judged = check.judge(numbers, config["limits"])
            return hmm, judged, failed == 0 and all(
                j["holds"] for j in judged.values())

        hmm, judged, correct = numbers_of()
        check_s = (time.perf_counter_ns() - last_end - profiler_stop_ns) / 1e9
        control_results = {}
        for control in controls:
            _, cj, cc = numbers_of(control)
            control_results[control] = {
                "correct": bool(cc),
                "checks": {k: {"value": j["value"], "limit": j["limit"]}
                           for k, j in cj.items()}}
        log(json.dumps({"window": {
            "pass_complete": attempted == len(measured), "shards": attempted,
            "failed": failed,
            "regions": [f"{b}-{e}" for b, e in measured[:attempted]],
            "called_kb": called_bp / 1e3, "window_s": window_ns / 1e9,
            "setup_s": setup_s, "check_s": check_s, "card": card,
            "card_before": card_before,
            "kernel_launches": kernel_launches, **routing_counts,
            "launches_per_mb": kernel_launches / called_mb if called_mb else None,
            "card_pairs_per_mb": routing_counts["card_pairs"] / called_mb if called_mb else None,
            "host_dp_pairs_per_mb": routing_counts["host_pairs"] / called_mb if called_mb else None,
            "vb": vb_counts, "genotype": genotype_counts,
            "genotype_kept": {"host": len(capture.gl_host.items),
                              "device": len(capture.gl_card.items),
                              "seen": capture.gl_calls},
            "unseen": seen["parts"],
            "checked": {k: v for k, v in hmm.items() if k != "hmm_err"},
            "records": counts, "shard_s": shard_s}}))

        result: dict = {"correct": bool(correct), "attempted": attempted,
                        "failed": failed,
                        "pass_complete": attempted == len(measured)}
        if trace:
            dev = (devtrace.read(prof, (t0 + wall_offset, last_end + wall_offset))
                   if prof is not None else None)
            reading = Reading(self_s=spans.self_seconds(), called_mb=called_mb,
                              window_s=window_ns / 1e9, device=dev,
                              launches=capture.launches, routing=routing_counts,
                              kernel_launches=kernel_launches)
            values = {}
            for metric in metrics_of(spec, "per_layer", workload):
                value = load_reader(metric["name"])(reading)
                if value is not None:
                    values[metric["name"]] = {"value": value, "unit": metric["unit"]}
            result["metrics"] = values
        else:
            rate = called_bp / 1e3 / (window_ns / 1e9)
            values = {"called_kb_per_s": {"value": rate, "unit": "kb/s"},
                      "setup_s": {"value": setup_s, "unit": "s"}}
            wanted = {m["name"] for m in metrics_of(spec, "end_to_end", workload)}
            result["metrics"] = {k: v for k, v in values.items() if k in wanted}
        result["device"] = {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": int(cell["chips"]), "memory_peak_bytes": int(memory_peak)}
        if trace:
            dev = reading.device
            result["device"]["busy_s"] = dev.busy_s if dev else 0.0
            result["device"]["window_s"] = window_ns / 1e9
            if dev:
                ops = sorted(dev.seconds_by_kernel().items(), key=lambda kv: -kv[1])
                idle = sorted(dev.idle_by_phase(spans.self_intervals(), wall_offset).items(),
                              key=lambda kv: -kv[1])
                result["breakdown"] = {"device_ops": [list(x) for x in ops[:10]],
                                       "idle_gaps": [list(x) for x in idle[:10]]}
        if controls:
            result["controls"] = control_results
        result["checks"] = {name: {"value": j["value"], "limit": j["limit"]}
                            for name, j in judged.items()}
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


__all__ = ["run_cell", "load_spec", "load_cell", "rehearsal_size", "shards_of",
           "one_pass", "forbidden_modules", "Reading", "FORBIDDEN", "REHEARSAL"]
