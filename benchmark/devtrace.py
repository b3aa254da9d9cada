"""The card's side of a traced window, from `torch.profiler` (CUDA activity
only, so the host's torch operations are not recorded): every kernel,
copy and memset with its start and length, on the host's wall clock.

Busy time is the union of those intervals inside the window; the idle
gaps are the rest, each put on the program phase that was innermost on the
host at the time.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

PAIRHMM_KERNEL = re.compile(r"\bpairhmm(_wave)?_kernel\b")


def short_name(name: str) -> str:
    """A device operation's name without its argument list, return type
    or anonymous namespace."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].strip()
    return name[5:] if name.startswith("void ") else name


@dataclass
class DeviceTrace:
    ops: list                   # (name, start_ns, end_ns), wall clock
    window: tuple               # (start_ns, end_ns), wall clock

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> list:
        t0, t1 = self.window
        spans = sorted((max(s, t0), min(e, t1)) for _, s, e in self.ops
                       if e > t0 and s < t1)
        merged: list = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def idle_intervals(self) -> list:
        t0, t1 = self.window
        out, cursor = [], t0
        for s, e in self.busy_intervals():
            if s > cursor:
                out.append((cursor, s))
            cursor = max(cursor, e)
        if t1 > cursor:
            out.append((cursor, t1))
        return out

    def seconds_by_kernel(self) -> dict:
        """Device seconds inside the window by operation name (a kernel's
        name without its argument list)."""
        t0, t1 = self.window
        out: dict = {}
        for name, s, e in self.ops:
            s, e = max(s, t0), min(e, t1)
            if e > s:
                key = short_name(name)
                out[key] = out.get(key, 0.0) + (e - s) / 1e9
        return out

    def pairhmm_seconds(self) -> float:
        return sum(v for k, v in self.seconds_by_kernel().items()
                   if PAIRHMM_KERNEL.search(k))

    def idle_by_phase(self, intervals: list, offset_ns: int) -> dict:
        """Idle seconds by the innermost host span open during them.
        intervals: (start, end, name) in perf_counter_ns, non-overlapping
        and sorted; offset_ns turns them into wall-clock ns. Idle time in no
        span goes to "harness"."""
        idle = self.idle_intervals()
        out: dict = {}
        j = 0
        for s, e in idle:
            covered = 0
            while j < len(intervals) and intervals[j][1] + offset_ns <= s:
                j += 1
            k = j
            while k < len(intervals) and intervals[k][0] + offset_ns < e:
                a = max(s, intervals[k][0] + offset_ns)
                b = min(e, intervals[k][1] + offset_ns)
                if b > a:
                    out[intervals[k][2]] = out.get(intervals[k][2], 0.0) + (b - a) / 1e9
                    covered += b - a
                k += 1
            if e - s > covered:
                out["harness"] = out.get("harness", 0.0) + (e - s - covered) / 1e9
        return out


def profiler():
    """A torch.profiler over CUDA activity alone, not yet started."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def read(prof, window_ns: tuple) -> DeviceTrace:
    """The device operations of a finished profiler."""
    ops = []
    for ev in prof.profiler.kineto_results.events():
        if not str(ev.device_type()).endswith("CUDA"):
            continue
        start = ev.start_ns()
        ops.append((ev.name(), start, start + ev.duration_ns()))
    return DeviceTrace(ops=ops, window=window_ns)


__all__ = ["DeviceTrace", "profiler", "read", "PAIRHMM_KERNEL"]
