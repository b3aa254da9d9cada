"""The card's idle share of the traced window: 100 x (1 - the union of its
kernels', copies' and memsets' intervals / the window), from torch.profiler."""


def read(r):
    if r.device is None or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.device.busy_s / r.device.window_s)
