"""The window is one pass: each measured shard once, in order, with no
wrap, and none started once the cap has passed. `cell.one_pass` on a
clock the test sets, and one CPU rehearsal whose cap stops the pass after
its first shard, which the result line and the window's log report as
not complete."""

import contextlib
import io
import json

import pytest
import torch

from benchmark import cell

MEASURED = [(0, 10), (10, 20), (20, 30), (30, 40)]


class Clock:
    """A clock in ns that each shard moves on by its own cost."""

    def __init__(self):
        self.now = 1_000

    def __call__(self):
        return self.now


def run_pass(cost_s: dict, seconds: float):
    clock = Clock()
    calls = []

    def call_one(region):
        calls.append(region)
        clock.now += int(cost_s[region] * 1e9)

    t0, end, shard_s = cell.one_pass(MEASURED, seconds, call_one, clock=clock)
    return calls, (end - t0) / 1e9, shard_s


def test_every_shard_once_in_order_without_wrap():
    cost = {r: 2.0 + k for k, r in enumerate(MEASURED)}
    calls, window_s, shard_s = run_pass(cost, seconds=51)
    assert calls == MEASURED
    assert shard_s == [2.0, 3.0, 4.0, 5.0]
    assert window_s == 14.0


@pytest.mark.parametrize("seconds,started", [(1e-9, 1), (5.0, 2), (6.0, 2),
                                             (6.5, 3), (9.0, 3), (9.5, 4)])
def test_no_shard_starts_once_the_cap_has_passed(seconds, started):
    """Shards of 3 s each start at 0, 3, 6 and 9 s: a shard starts only
    while the cap has not been reached, and the last one started runs to
    its end."""
    calls, window_s, shard_s = run_pass({r: 3.0 for r in MEASURED}, seconds)
    assert calls == MEASURED[:started]
    assert window_s == 3.0 * started and len(shard_s) == started


def test_a_pass_cut_by_its_cap_is_not_complete(tmp_path, monkeypatch):
    """On the CPU at the rehearsal's size, a cap of 50 ms stops the pass
    after its first shard: the result line and the window's log say so,
    and the rate counts that shard alone."""
    monkeypatch.delenv("OCTOPUS_TPU_HOST_HMM_MAX", raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    log = io.StringIO()
    try:
        with contextlib.redirect_stderr(log):
            res = cell.run_cell("somatic-t60n30.subclonal", 2**31 + 5, 0.05, False,
                                device="cpu",
                                traffic_override={"contig_kb": 20, "shard_kb": 5},
                                tmp_root=str(tmp_path))
    finally:
        torch.set_num_threads(threads)
    window = next(json.loads(line)["window"] for line in log.getvalue().splitlines()
                  if line.startswith('{"window"'))
    assert not window["pass_complete"] and not res["pass_complete"]
    assert res["attempted"] == window["shards"] == 1
    assert window["regions"] == ["0-5000"] and window["called_kb"] == 5.0
    rate = res["metrics"]["called_kb_per_s"]["value"]
    assert rate == pytest.approx(5.0 / window["window_s"])
