"""The port's phase timers (`octopus_tpu_torch.utils.timers`) and the spans
and counters the program opens with them.

On the CPU: the recorder (self time under nesting, a stack a thread,
nothing recorded while off, merge, reset, the report), the phases a small
`--caller cancer` run opens and their parents, and the counters
`ROUTING.shortcut_pairs` and `subclone_vb.COUNTS.captures`. With a card
(skipped without one): a card VB evaluation's phases and captures, and the
clock that `--profile`'s trace shares between host phases and kernels.
This file imports neither JAX nor the reference package, so the card's
machine runs it alone:

    python -m pytest --noconftest tests/test_torch_tracing.py -q
"""

import json
import subprocess
import sys
import threading
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
import torch

from octopus_tpu_torch import cli
from octopus_tpu_torch.core.likelihood import likelihood_array as la
from octopus_tpu_torch.core.models import subclone_vb
from octopus_tpu_torch.utils import synthetic, timers


@pytest.fixture
def recorder():
    """The recorder on and empty; its flags and totals restored after."""
    saved = timers.enabled, timers.annotate
    timers.reset()
    timers.enabled, timers.annotate = True, False
    yield timers
    timers.enabled, timers.annotate = saved
    timers.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


class Parents:
    """Wraps timers.phase: every phase opened, with its parent on the same
    thread, then the program's own recorder."""

    def __init__(self, phase):
        self.phase = phase
        self.opened: list = []          # (name, parent or None)
        self._stack: list = []

    @contextmanager
    def __call__(self, name):
        self.opened.append((name, self._stack[-1] if self._stack else None))
        self._stack.append(name)
        try:
            with self.phase(name):
                yield
        finally:
            self._stack.pop()

    def parents(self, name) -> set:
        return {p for n, p in self.opened if n == name}

    def children(self, name) -> set:
        return {n for n, p in self.opened if p == name}


# -- the recorder -----------------------------------------------------------

def test_self_time_leaves_out_nested_phases(recorder):
    with timers.phase("outer"):
        time.sleep(0.02)
        with timers.phase("inner"):
            time.sleep(0.03)
        with timers.phase("inner"):
            time.sleep(0.01)
    total, own, calls = timers.totals(), timers.self_totals(), timers.counts()
    assert calls == {"outer": 1, "inner": 2}
    assert total["inner"] >= 0.04 and total["outer"] >= 0.06
    assert own["inner"] == total["inner"]
    assert own["outer"] == pytest.approx(total["outer"] - total["inner"],
                                         abs=1e-9)
    assert 0.015 <= own["outer"] < total["outer"] - 0.035


def test_each_thread_keeps_its_own_stack(recorder):
    """A phase on another thread, inside this one's phase in time, is not
    nested in it."""
    opened, done = threading.Event(), threading.Event()

    def other():
        opened.wait(10)
        with timers.phase("other"):
            time.sleep(0.03)
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with timers.phase("mine"):
        opened.set()
        assert done.wait(10)
    t.join(10)
    assert not t.is_alive()
    total, own = timers.totals(), timers.self_totals()
    assert total["mine"] >= total["other"] >= 0.03
    assert own["mine"] == total["mine"]


def test_threads_lose_no_update(recorder):
    """More threads than cores, a short switch interval: every call
    counted, and each thread's self time still partitions its time."""
    import os
    n_threads, n_calls = 2 * (os.cpu_count() or 2), 200
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_calls):
                with timers.phase("a"):
                    with timers.phase("b"):
                        pass
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
    assert timers.counts() == {"a": n_threads * n_calls, "b": n_threads * n_calls}
    total, own = timers.totals(), timers.self_totals()
    assert own["a"] + own["b"] == pytest.approx(total["a"], rel=1e-9)


def test_nothing_recorded_while_off(recorder, monkeypatch):
    timers.enabled = False
    monkeypatch.setattr(timers, "_label", lambda name: pytest.fail(
        "a phase touched the profiler while not annotating"))
    ran = []
    with timers.phase("off"):
        ran.append(1)
    assert ran == [1]
    assert timers.totals() == timers.self_totals() == timers.counts() == {}
    # an exception passes through a disabled phase unchanged
    with pytest.raises(KeyError):
        with timers.phase("off"):
            raise KeyError("x")


def test_merge_adds_a_snapshot_and_reset_clears(recorder):
    with timers.phase("outer"):
        with timers.phase("inner"):
            time.sleep(0.005)
    delta = timers.snapshot()
    assert set(delta) == {"outer", "inner"}
    assert delta["outer"][2] == 1
    timers.merge(delta)
    timers.merge(delta)
    assert timers.counts() == {"outer": 3, "inner": 3}
    assert timers.totals()["outer"] == pytest.approx(3 * delta["outer"][0])
    assert timers.self_totals()["outer"] == pytest.approx(3 * delta["outer"][1])
    timers.reset()
    assert timers.totals() == timers.self_totals() == timers.counts() == {}
    assert timers.snapshot() == {}


def test_report_shows_self_and_total(recorder):
    timers.merge({"outer": (5.0, 2.0, 1), "inner": (3.0, 3.0, 4)})
    lines = timers.report().splitlines()
    assert "self" in lines[1] and "total" in lines[1]
    rows = {line.split()[0]: line.split()[1:] for line in lines[2:]}
    assert rows["outer"] == ["2.00s", "5.00s", "1"]
    assert rows["inner"] == ["3.00s", "3.00s", "4"]
    # ordered by self time
    assert [line.split()[0] for line in lines[2:]] == ["inner", "outer"]


def test_annotate_opens_a_profiler_range(recorder):
    from torch.profiler import ProfilerActivity, profile
    timers.enabled, timers.annotate = False, True
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timers.phase("probe_phase"):
            torch.ones(64).sum()
    assert "probe_phase" in {e.key for e in prof.key_averages()}
    assert timers.totals() == {}


# -- the program's spans and counters ---------------------------------------

@pytest.fixture(scope="module")
def tumour_normal(tmp_path_factory):
    d = tmp_path_factory.mktemp("tracing_tn")
    fa, bam_n, bam_t, _, somatic, _ = synthetic.simulate_tumour_normal(
        str(d), kb=6, depth=20, seed=11)
    return d, fa, bam_n, bam_t, somatic


def test_cancer_run_opens_its_phases_under_their_parents(tumour_normal,
                                                         recorder,
                                                         monkeypatch):
    d, fa, bam_n, bam_t, somatic = tumour_normal
    seen = Parents(timers.phase)
    monkeypatch.setattr(timers, "phase", seen)
    la.ROUTING.reset()
    subclone_vb.COUNTS.reset()
    out = str(d / "calls.vcf")
    # two somatic SNVs (2,048 and 2,160) in 400 bp
    assert cli.main(["-R", fa, "-I", bam_n, bam_t, "-o", out,
                     "-T", "chr1:1900-2300", "--device", "cpu",
                     "--caller", "cancer", "--normal-sample", "NORMAL",
                     "--benchmark"]) == 0
    users = {"likelihood_populate", "read_assignment", "hapgen_beam"}
    assert seen.parents("active_region") == {"calling"}
    assert seen.parents("infer_latents") == {"active_region"}
    assert seen.parents("vb_host") == {"infer_latents"}
    for name in ("populate_jobs", "populate_shortcut", "populate_stage"):
        assert seen.parents(name) and seen.parents(name) <= users, name
    assert "likelihood_populate" in seen.parents("populate_jobs")
    assert "read_assignment" in seen.parents("populate_stage")
    assert seen.children("hmm_host_dp") == set()
    assert not {"vb_card", "vb_capture", "vb_card_wait"} & {
        n for n, _ in seen.opened}
    # the recorder underneath: self times partition the root phases
    roots = {n for n, p in seen.opened if p is None}
    assert not roots & {n for n, p in seen.opened if p is not None}
    total = timers.totals()
    assert sum(timers.self_totals().values()) == pytest.approx(
        sum(total[r] for r in roots), rel=1e-9)
    assert timers.counts()["vb_host"] == subclone_vb.COUNTS.host > 0
    assert subclone_vb.COUNTS.captures == 0
    assert la.ROUTING.shortcut_pairs > 0


def test_shortcut_counter_is_apart_from_the_routes():
    routing = la.RoutingCounts()
    routing.record("populate", "host_dp", 5)
    routing.record("assignment", "pairhmm_plain", 3)
    routing.record_shortcuts(7)
    routing.record_shortcuts(2)
    assert routing.shortcut_pairs == 9
    assert (routing.host_pairs, routing.device_pairs) == (5, 3)
    assert (routing.host_job_sets, routing.device_job_sets) == (1, 1)
    routing.reset()
    assert routing.shortcut_pairs == 0 and routing.host_pairs == 0


def test_vb_counts_reset_clears_captures():
    counts = subclone_vb.VbCounts(host=2, device=1, host_elements=9,
                                  device_elements=90_000, captures=3)
    counts.reset()
    assert counts == subclone_vb.VbCounts()


def test_populate_counts_each_job_once(tumour_normal):
    """Every job of a populate goes to a shortcut or a scorer: the shortcut
    counter and the routes' pairs add up to the jobs gathered."""
    from octopus_tpu_torch.io.bam import BamFile
    from octopus_tpu_torch.io.fasta import IndexedFasta, ReferenceGenome
    d, fa, bam_n, bam_t, _ = tumour_normal
    ref = ReferenceGenome(IndexedFasta(fa))
    batch, = BamFile(bam_t).fetch("chr1", 1900, 2300).values()
    hap = ref.fetch_codes("chr1", 1700, 2500)
    alt = hap.copy()
    alt[348] = (alt[348] + 1) % 4
    arr = la.HaplotypeLikelihoodArray(la.LikelihoodConfig(device="cpu"))
    jobs = []
    real = arr._eval_jobs_fixed_len

    def counted(*args):
        jobs.append(len(args[4]))
        return real(*args)

    arr._eval_jobs_fixed_len = counted
    la.ROUTING.reset()
    arr.populate([batch], [hap, alt], 1700)
    routed = la.ROUTING.host_pairs + la.ROUTING.device_pairs
    assert la.ROUTING.shortcut_pairs > 0
    assert la.ROUTING.shortcut_pairs + routed == sum(jobs) > 0


# -- on the card --------------------------------------------------------------

def test_card_evaluation_opens_its_phases(cuda, recorder, monkeypatch):
    """One card evaluation in three genotype chunks: vb_card around it,
    one graph capture and one wait a chunk nested in it."""
    monkeypatch.setenv("OCTOPUS_TPU_VB_DEVICE_MIN", "0")
    G, K, N, S = 12, 3, 40, 2
    monkeypatch.setenv("OCTOPUS_TPU_VB_BUDGET_ELEMS", str(4 * S * K * N))
    seen = Parents(timers.phase)
    monkeypatch.setattr(timers, "phase", seen)
    subclone_vb.COUNTS.reset()
    rng = np.random.default_rng(5)
    lnl = -rng.random((6, N)) * 20
    tuples = rng.integers(0, 6, (G, K))
    model = subclone_vb.SubcloneModel(n_seeds=S, n_iter=10, device="cuda")
    card = model.evaluate(tuples, lnl)
    assert subclone_vb.COUNTS.device == 1 and subclone_vb.COUNTS.captures == 3
    assert seen.parents("vb_card") == {None}
    assert seen.parents("vb_capture") == {"vb_card"}
    assert seen.parents("vb_card_wait") == {"vb_card"}
    assert timers.counts() == {"vb_card": 1, "vb_capture": 3, "vb_card_wait": 3}
    own = timers.self_totals()
    assert own["vb_capture"] > 0 and own["vb_card_wait"] > 0
    # the same evaluation on the host: the same bits, no capture
    host = subclone_vb.SubcloneModel(n_seeds=S, n_iter=10,
                                     device="cpu").evaluate(tuples, lnl)
    assert np.array_equal(card.genotype_log_evidences,
                          host.genotype_log_evidences)
    assert subclone_vb.COUNTS.captures == 3


# A second torch.profiler session in one process records no CUDA kernels
# on the card's machine, so the clock check runs in a process of its own.
CLOCK = r"""
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, {root!r})
from octopus_tpu_torch.utils import timers

# cycles of torch.cuda._sleep (the spin_kernel) a millisecond, timed with
# CUDA events; the kernel is loaded on the way
start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
torch.cuda._sleep(1000)
start.record()
torch.cuda._sleep(10_000_000)
end.record()
torch.cuda.synchronize()
cycles = int(20 * 10_000_000 / start.elapsed_time(end))
timers.annotate = True
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    with timers.phase("probe"):
        torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
prof.export_chrome_trace({path!r})
events = json.load(open({path!r}))["traceEvents"]
print(json.dumps({{
    "ranges": [(e["ts"], e["dur"]) for e in events if e.get("name") == "probe"
               and e.get("cat") == "user_annotation"],
    "kernels": [(e["ts"], e["dur"]) for e in events if e.get("cat") == "kernel"
                and "spin_kernel" in e.get("name", "")]}}))
"""


def test_profile_trace_puts_kernels_inside_their_phase(cuda, tmp_path):
    """`--profile`'s clock: a ~20 ms sleep kernel and the synchronize after
    it, both inside one phase, lie inside that phase's record_function range
    in the exported trace, within 1 ms on each side."""
    root = str(Path(__file__).resolve().parent.parent)
    out = subprocess.run(
        [sys.executable, "-c", CLOCK.format(root=root,
                                            path=str(tmp_path / "trace.json"))],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    found = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(found["ranges"]) == 1 and len(found["kernels"]) == 1, found
    (r0, r_dur), (k0, k_dur) = found["ranges"][0], found["kernels"][0]
    r1, k1 = r0 + r_dur, k0 + k_dur                  # microseconds
    assert k_dur >= 10_000
    assert k0 >= r0 - 1000
    assert k1 <= r1 + 1000
    # the synchronize returns as the kernel ends: the range ends with it
    assert r1 - k1 <= 1000
