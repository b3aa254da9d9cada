"""The per-layer readers of the program's spans and counters.

On a traced rehearsal of each cell of BENCHMARK.json at its rehearsal size
(`cell.rehearsal_size`; on the CPU, and on a card where there is one):
the rehearsal is correct, every phase the window recorded is read by
exactly one per-layer reader, the s/Mb readers add up to the window's
seconds a Mb, and the counter readers read the window's counts; a cell
whose configuration has no `vb` opens no VB phase and counts no VB
evaluation, and reaches the individual model's genotype reductions. The
window is one pass: the rehearsal calls each measured shard once, in
order. A counter reader returns None on a program without its counter. On
the card (skipped without one): the harness's clock, the path that puts
the card's idle gaps on host phases, holds a kernel inside the span that
issued it."""

import json
import subprocess
import sys
import types

import pytest
import torch

from benchmark import cell, probes

SPEC = cell.load_spec()
COUNTERS = ("vb_host_evals_per_mb", "vb_captures_per_mb", "shortcut_pairs_per_mb")
CAP = 600                   # seconds no rehearsal reaches: each calls its whole pass


def reading(self_s: dict, called_mb: float = 1.0) -> cell.Reading:
    return cell.Reading(self_s=self_s, called_mb=called_mb, window_s=1.0,
                        device=None, launches=[],
                        routing={"card_job_sets": 0, "card_pairs": 0,
                                 "host_job_sets": 0, "host_pairs": 0},
                        kernel_launches=0)


def span_readers(workload: str) -> dict:
    return {m["name"]: cell.load_reader(m["name"])
            for m in cell.metrics_of(SPEC, "per_layer", workload)
            if m["unit"] == "s/Mb"}


@pytest.fixture(scope="module",
                params=[(w["name"], device) for w in SPEC["workloads"]
                        for device in ("cpu", "cuda")],
                ids=lambda p: "-".join(p))
def traced(request, tmp_path_factory):
    """(workload, result line, span self seconds, window log, shortcut
    pairs, whether the configuration has VB) of one traced rehearsal, on
    the CPU or on the card."""
    import contextlib
    import io

    from octopus_tpu_torch.core.likelihood import likelihood_array

    workload, device = request.param
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    recorded = []
    self_seconds = probes.Spans.self_seconds

    def keep(spans):
        out = self_seconds(spans)
        recorded.append(out)
        return out

    log = io.StringIO()
    mp = pytest.MonkeyPatch()
    mp.setattr(probes.Spans, "self_seconds", keep)
    mp.delenv("OCTOPUS_TPU_HOST_HMM_MAX", raising=False)
    try:
        with contextlib.redirect_stderr(log):
            res = cell.run_cell(workload, 2**31 + 3, CAP, True, device=device,
                                traffic_override=cell.rehearsal_size(SPEC, workload),
                                tmp_root=str(tmp_path_factory.mktemp("traced")))
    finally:
        mp.undo()
    window = next(json.loads(line)["window"] for line in log.getvalue().splitlines()
                  if line.startswith('{"window"'))
    return (workload, res, recorded[0], window,
            likelihood_array.ROUTING.shortcut_pairs,
            "vb" in cell.load_cell(SPEC, workload)[1])


def test_rehearsal_is_correct(traced):
    _, res, _, _, _, _ = traced
    assert res["correct"], res["checks"]


def test_every_phase_is_read_by_one_reader(traced):
    workload, _, self_s, _, _, has_vb = traced
    readers = span_readers(workload)
    for name in self_s:
        reading_one = reading({name: 1.0})
        by = [m for m, read in readers.items() if read(reading_one)]
        assert len(by) == 1, (name, by)
    # the phases the new readers read, opened on the CPU and the card alike
    assert {"active_region", "populate_jobs", "populate_shortcut",
            "populate_stage"} <= set(self_s)
    vb_phases = {name for name in self_s if name.startswith("vb_")}
    assert ("vb_host" in vb_phases) if has_vb else not vb_phases, vb_phases


def test_span_readers_add_up_to_the_window(traced):
    workload, res, _, window, _, _ = traced
    values = res["metrics"]
    total = sum(values[m]["value"] for m in span_readers(workload))
    per_mb = window["window_s"] / (window["called_kb"] / 1e3)
    assert total == pytest.approx(per_mb, rel=0.01)


def test_counter_readers_read_the_window_counts(traced):
    _, res, _, window, shortcut_pairs, has_vb = traced
    called_mb = window["called_kb"] / 1e3
    values = {k: v["value"] for k, v in res["metrics"].items()}
    assert values["vb_host_evals_per_mb"] == pytest.approx(
        window["vb"]["host"] / called_mb)
    assert values["vb_captures_per_mb"] == pytest.approx(
        window["vb"]["captures"] / called_mb)
    # a capture a genotype chunk of each card evaluation, none on the CPU
    assert window["vb"]["captures"] >= window["vb"]["device"]
    assert (window["vb"]["captures"] > 0) == (window["vb"]["device"] > 0)
    assert values["shortcut_pairs_per_mb"] == pytest.approx(
        shortcut_pairs / called_mb)
    assert shortcut_pairs > 0
    assert set(window["genotype"]) == {"host", "device"}
    if has_vb:
        assert window["vb"]["host"] > 0
    else:
        assert not any(window["vb"].values()), window["vb"]
        assert values["vb_host_evals_per_mb"] == 0
        assert values["vb_host_native_per_mb"] == 0
        # the individual model's genotype reductions, reset before the window
        assert sum(window["genotype"].values()) > 0


def test_rehearsal_calls_its_whole_pass_once_in_order(traced):
    workload, res, _, window, _, _ = traced
    traffic = cell.load_cell(SPEC, workload)[2]
    size = cell.rehearsal_size(SPEC, workload)
    _, measured = cell.shards_of({**traffic, **size}, size["contig_kb"] * 1000)
    assert window["pass_complete"] and res["attempted"] == len(measured)
    assert window["regions"] == [f"{b}-{e}" for b, e in measured]
    assert len(window["shard_s"]) == len(measured)


def test_counter_readers_return_none_without_the_counter(monkeypatch):
    from octopus_tpu_torch.core import likelihood, models
    from octopus_tpu_torch.core.likelihood import likelihood_array
    from octopus_tpu_torch.core.models import subclone_vb

    readers = {name: cell.load_reader(name) for name in COUNTERS}
    r = reading({}, called_mb=0.5)
    assert all(read(r) is not None for read in readers.values())
    # the counters' owners as a program without them has them
    monkeypatch.setattr(subclone_vb, "COUNTS", types.SimpleNamespace(
        host=3, device=0, host_elements=1, device_elements=0))
    monkeypatch.setattr(likelihood_array, "ROUTING", types.SimpleNamespace())
    assert readers["vb_host_evals_per_mb"](r) == 6.0
    assert readers["vb_captures_per_mb"](r) is None
    assert readers["shortcut_pairs_per_mb"](r) is None
    # stand-in modules with no counters at all
    monkeypatch.setattr(models, "subclone_vb", types.ModuleType("subclone_vb"))
    monkeypatch.setattr(likelihood, "likelihood_array",
                        types.ModuleType("likelihood_array"))
    assert all(read(r) is None for read in readers.values())


# A second torch.profiler session in one process records no CUDA kernels
# on the card's machine (a traced rehearsal above has had one), so the
# clock check runs in a process of its own.
CLOCK = r"""
import json, sys, time
import torch
sys.path.insert(0, {root!r})
from benchmark import devtrace, probes

start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
torch.cuda._sleep(1000)
start.record()
torch.cuda._sleep(10_000_000)
end.record()
torch.cuda.synchronize()
cycles = int(20 * 10_000_000 / start.elapsed_time(end))
spans = probes.Spans()
prof = devtrace.profiler()
prof.__enter__()
wall_offset = time.time_ns() - time.perf_counter_ns()
t0 = time.perf_counter_ns()
with spans.span("probe"):
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
t1 = time.perf_counter_ns()
prof.__exit__(None, None, None)
trace = devtrace.read(prof, (t0 + wall_offset, t1 + wall_offset))
span = spans.spans[0]
print(json.dumps({{
    "span": (span.start + wall_offset, span.end + wall_offset),
    "kernels": [(s, e) for name, s, e in trace.ops if "spin_kernel" in name],
    "idle": trace.idle_by_phase(spans.self_intervals(), wall_offset)}}))
"""


def test_harness_clock_puts_a_kernel_inside_its_span():
    """cell.py's path: a ~20 ms sleep kernel and the synchronize after it,
    inside one `Spans` span, read back by `devtrace.read` over the window
    and moved by the same wall_offset, lie inside that span within 1 ms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "-c", CLOCK.format(root=str(cell.ROOT))],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    found = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(found["kernels"]) == 1, found
    (s0, s1), (k0, k1) = found["span"], found["kernels"][0]
    assert k1 - k0 >= 10_000_000
    assert k0 >= s0 - 1_000_000
    assert k1 <= s1 + 1_000_000
    assert s1 - k1 <= 1_000_000
    # the idle gaps around it go to the span, none to the harness
    assert found["idle"].get("harness", 0.0) <= 2e-3
