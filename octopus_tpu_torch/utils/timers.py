"""Phase timers.

Capability-equivalent to the reference's BENCHMARK-gated timers
(src/timers.hpp:13-23: init/likelihood/latents/calling/phasing/output),
reported per run when enabled.

`phase(name)` records, per name, the inclusive seconds, the self seconds
(the inclusive time less that of the phases nested in it, on the same
thread) and the call count, while `enabled` is set (`--benchmark`). While
`annotate` is set (`--profile`), each phase also opens a
`torch.profiler.record_function` range of its name, so the profiler's
trace shows the host phases on its own clock beside the kernels and copies
they issue. With both off a phase is one flag test and a shared no-op
context manager. Nothing keeps a list of single phases: a whole-genome run
would grow it without bound.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

_totals: dict[str, float] = defaultdict(float)
_self: dict[str, float] = defaultdict(float)
_counts: dict[str, int] = defaultdict(int)
_lock = threading.Lock()
_local = threading.local()
enabled = False
annotate = False


def _label(name: str):
    from torch.profiler import record_function
    return record_function(name)


_OFF = nullcontext()


def phase(name: str):
    """A context manager timing `name`; with the recorder and the
    annotation off, one shared no-op."""
    if not (enabled or annotate):
        return _OFF
    return _phase(name)


@contextmanager
def _phase(name: str):
    with _label(name) if annotate else nullcontext():
        if not enabled:
            yield
            return
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        child = [0.0]               # seconds of the phases nested in this one
        stack.append(child)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            stack.pop()
            if stack:
                stack[-1][0] += dt
            with _lock:
                _totals[name] += dt
                _self[name] += dt - child[0]
                _counts[name] += 1


def totals() -> dict:
    """Inclusive seconds by phase name."""
    with _lock:
        return dict(_totals)


def self_totals() -> dict:
    """Self seconds by phase name: nested phases' time left out."""
    with _lock:
        return dict(_self)


def counts() -> dict:
    """Calls by phase name."""
    with _lock:
        return dict(_counts)


def snapshot() -> dict:
    """{name: (inclusive s, self s, calls)}, the form `merge` takes."""
    with _lock:
        return {k: (_totals[k], _self[k], _counts[k]) for k in _totals}


def merge(delta: dict) -> None:
    """Add another recorder's `snapshot()` (a pool worker's window)."""
    with _lock:
        for name, (total, self_s, calls) in delta.items():
            _totals[name] += total
            _self[name] += self_s
            _counts[name] += calls


def report() -> str:
    lines = ["phase timers:", f"  {'':<20} {'self':>9} {'total':>9}  calls"]
    for name, total, self_s, calls in sorted(
            ((k, v[0], v[1], v[2]) for k, v in snapshot().items()),
            key=lambda row: -row[2]):
        lines.append(f"  {name:<20} {self_s:8.2f}s {total:8.2f}s  {calls}")
    return "\n".join(lines)


def reset() -> None:
    with _lock:
        _totals.clear()
        _self.clear()
        _counts.clear()


__all__ = ["phase", "report", "reset", "totals", "self_totals", "counts",
           "snapshot", "merge", "enabled", "annotate"]
