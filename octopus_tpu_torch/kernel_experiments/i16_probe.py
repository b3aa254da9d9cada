"""Port of experiments/i16_probe.py: the pair-HMM's op mix in int16.

`run(a, b)` computes the probe's function on (D, B) int16 arrays: fifty
rounds of a shifted add, minimums, a compare-select, `+2` and a 3-step
prefix minimum (see `kern_plain`), int16 sums wrapping. On a card it
launches csrc/exp_i16.cu, two int16 values a 32-bit register by default
(pack=2) or one a thread (pack=1); on the CPU it runs `kern_plain`. The
experiment ran itself at import; here `probe()` does, and nothing runs at
import.
"""

from __future__ import annotations

import time

import torch

from . import _common as c
from ..device import resolve_device

INF16 = 16000
ROUNDS = 50
D = 16                   # the probe's rows, the band of pad 8
PACKS = (2, 1)           # values a 32-bit register in csrc/exp_i16.cu
BENCH_SHAPE = (D, 1 << 20)


def _shift_down(x: torch.Tensor, s: int) -> torch.Tensor:
    return torch.cat([torch.full_like(x[:s], INF16), x[:-s]])


def kern_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The probe's `kern` in int16 torch (sums wrap)."""
    m, i = a, b
    eq = a == b
    for _ in range(ROUNDS):
        mn = torch.minimum(m + a, torch.minimum(i, _shift_down(m, 1)))
        u = torch.where(eq, mn, i + 2)
        s = 1
        while s < 8:
            u = torch.minimum(u, _shift_down(u, s))
            s *= 2
        m, i = mn, u
    return torch.minimum(m, i)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or a.shape != b.shape:
        raise ValueError("a and b must be one (D, B) shape")
    if a.dtype != torch.int16 or b.dtype != torch.int16:
        raise ValueError("a and b must be int16")
    if a.device != b.device:
        raise ValueError("a and b on two devices")


def run_cuda(a: torch.Tensor, b: torch.Tensor, *, pack: int = 2
             ) -> torch.Tensor:
    """One launch of csrc/exp_i16.cu on CUDA int16 (16, B) tensors (B even
    for pack=2)."""
    _check(a, b)
    c.require_cuda("run_cuda", [a, b], dtype=torch.int16)
    Dn, B = a.shape
    if Dn != D or pack not in PACKS or B % pack:
        raise ValueError(f"csrc/exp_i16.cu takes D = {D}, pack in {PACKS} "
                         f"and B a multiple of pack; got {tuple(a.shape)}, "
                         f"pack {pack}")
    out = torch.empty_like(a)
    return c.launch("i16", [a, b], out, (Dn, B, pack))


def run(a, b, *, device="cuda", pack: int = 2) -> torch.Tensor:
    """The probe on `device`: the kernel on a card, `kern_plain` on the
    CPU."""
    dev = resolve_device(device)
    a = torch.as_tensor(a).to(device=dev, dtype=torch.int16).contiguous()
    b = torch.as_tensor(b).to(device=dev, dtype=torch.int16).contiguous()
    if dev.type == "cuda":
        return run_cuda(a, b, pack=pack)
    _check(a, b)
    return kern_plain(a, b)


def probe(device="cuda") -> torch.Tensor:
    """The experiment's own run: ones and twos at (16, 128)."""
    a = torch.ones((D, 128), dtype=torch.int16)
    t0 = time.time()
    out = run(a, a * 2, device=device)
    if out.is_cuda:
        torch.cuda.synchronize()
    print("i16 kernel OK, build+run", round(time.time() - t0, 1),
          "s; out[0,0] =", int(out[0, 0]), flush=True)
    return out


def bench_inputs(shape=BENCH_SHAPE, seed: int = 0, device="cuda"):
    """(a, b) int16 in [0, 1000) on `device`, from a torch generator."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randint(0, 1000, shape, generator=gen, device=dev,
                          dtype=torch.int16) for _ in range(2)]


def main() -> None:
    probe()
    a, b = bench_inputs()
    want = kern_plain(a, b)
    for pack in PACKS:
        if not torch.equal(run_cuda(a, b, pack=pack), want):
            raise AssertionError(f"i16 pack={pack} differs from kern_plain")
        ms = c.cuda_ms(lambda: run_cuda(a, b, pack=pack))
        print(f"i16 pack={pack}: {a.numel() * ROUNDS / ms / 1e9:.2f} "
              f"G element-rounds/ms ({ms:.4f} ms, "
              f"{torch.cuda.get_device_name(0)})", flush=True)


if __name__ == "__main__":
    main()
