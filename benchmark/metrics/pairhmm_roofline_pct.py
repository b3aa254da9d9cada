"""Kernel #1's share of its roofline over the traced window: the least time
of every launch of #1 in the window (benchmark/roofline.py: 12 int32
ops a band cell over the rate derived from unit counts, or each byte once
over the published HBM rate, whichever is larger) over #1's kernel time in
the profiler. Nothing to read where the window launched no #1."""

from benchmark.roofline import launches_least_seconds


def read(r):
    if r.device is None or not r.launches:
        return None
    kernel_s = r.device.pairhmm_seconds()
    if kernel_s <= 0:
        return None
    return 100.0 * launches_least_seconds(r.launches) / kernel_s
