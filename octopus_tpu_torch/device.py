"""The torch device an entry point runs on.

Entry points take a device name and default to "cuda". A CUDA device that
this process cannot use raises: nothing quietly carries on on the CPU."""

from __future__ import annotations

import statistics

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def cuda_ms(fn, reps: int = 7) -> float:
    """Median CUDA-event time of fn, in ms, over `reps` runs after a
    warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


__all__ = ["cuda_ms", "resolve_device"]
