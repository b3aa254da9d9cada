"""What the five kernel experiments share: shapes, the builds and launches
of their CUDA libraries, launch counts, inputs, parity checks and timing.

The experiments take kernel-layout tracks, as experiments/*.py do: tgt and
qual (R, B), win/opn/ext/mask/prior (W, B) int32, W = R + 2*pad - 1, and
give (B,) int32 scores. Their kernels (csrc/exp_*.cu) are built at first
use, with nvcc for sm_90a, into build/torch_kernels/ and bound by ctypes,
as core/likelihood/pairhmm_batch.py binds its kernels.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.likelihood import pairhmm_batch as pb
from ..core.likelihood.pairhmm_batch import DEFAULT_NUC_PRIOR, KernelCounts
from ..device import cuda_ms, resolve_device

R = 150
PAD = 8                  # the only band the experiments (and their kernels) run
LANES = 128              # the experiments' pair-block width
BENCH_B = 65536          # the experiments' bench batch
PARITY_B = 1024          # their check_parity batch

# experiment -> (C entry point, device pointers including the output, ints
# after them); then the stream
ENTRIES = {
    "dual_chain": ("exp_dual_launch", 8, 6),   # B R W pad nuc_prior K
    "v13": ("exp_v13_launch", 8, 7),           # ... K schedule
    "v10": ("exp_v10_launch", 11, 6),          # B R W pad nuc_prior variant
    "v11": ("exp_v11_launch", 9, 6),           # B R W pad nuc_prior variant
    "i16": ("exp_i16_launch", 3, 3),           # D B pack
}
# experiment -> csrc/ sources besides csrc/exp_<name>.cu
HEADERS = {"dual_chain": ("exp_rows.cuh", "pairhmm_stage.cuh"),
           "v13": ("exp_rows.cuh", "pairhmm_stage.cuh"),
           "v10": ("exp_rows.cuh", "pairhmm_stage.cuh"),
           "v11": ("exp_rows.cuh", "pairhmm_stage.cuh"),
           "i16": ()}
# experiment -> (C occupancy query, ints before its (4,) output): blocks an
# SM, threads, shared memory and pairs a block of the variant the ints name
OCCUPANCY = {"dual_chain": ("exp_dual_occupancy", 1),   # K
             "v13": ("exp_v13_occupancy", 2),           # K schedule
             "v10": ("exp_v10_occupancy", 1),           # variant
             "v11": ("exp_v11_occupancy", 1)}           # variant
# launches of each experiment's kernel, counted where its wrapper launches it
COUNTS = {name: KernelCounts() for name in ENTRIES}
_libs: dict = {}


def library(name: str):
    """Build (first call only) and load csrc/exp_<name>.cu's library."""
    lib = _libs.get(name)
    if lib is None:
        from .._build import CSRC, build, nvcc_path
        src = CSRC / f"exp_{name}.cu"
        path = build(
            f"exp_{name}", [src] + [CSRC / h for h in HEADERS[name]],
            lambda out: [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                         "-Xptxas", "-v", src, "-o", out],
            ".so")
        lib = ctypes.CDLL(str(path))
        entry, n_ptr, n_int = ENTRIES[name]
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        if name in OCCUPANCY:
            query, n_q = OCCUPANCY[name]
            q = getattr(lib, query)
            q.restype = ctypes.c_int
            q.argtypes = [ctypes.c_int] * n_q + [ctypes.c_void_p]
        _libs[name] = lib
    return lib


def require_cuda(name: str, tensors, dtype=torch.int32) -> None:
    """Raise unless every tensor is a contiguous `dtype` CUDA tensor of one
    device whose data starts on a 16-byte boundary (the kernels copy rows
    in 16-byte pieces)."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    for t in tensors:
        if (t.dtype != dtype or not t.is_contiguous() or t.device != dev
                or t.data_ptr() % 16):
            raise ValueError(f"{name} tensors must be contiguous {dtype}, "
                             f"16-byte aligned, on {dev}")


def launch(name: str, tensors: list[torch.Tensor], out: torch.Tensor,
           ints: tuple) -> torch.Tensor:
    """One launch of experiment `name`'s kernel on checked CUDA tensors
    (None: a null pointer), writing `out`; counts it in COUNTS[name]."""
    fn = getattr(library(name), ENTRIES[name][0])
    dev = out.device
    args = ([None if t is None else t.data_ptr() for t in tensors]
            + [out.data_ptr(), *ints, pb._raw_stream(dev.index)])
    with torch.cuda.device(dev):
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"exp_{name} kernel launch failed: CUDA error {err}")
    COUNTS[name].add(int(out.shape[-1]))
    return out


def occupancy(name: str, *ints: int) -> dict:
    """What one SM of the current card holds of experiment `name`'s kernel
    variant `ints` (its occupancy query's arguments): blocks, warps, pairs,
    and the shared memory of a block and of a pair."""
    query = getattr(library(name), OCCUPANCY[name][0])
    out = (ctypes.c_int * 4)()
    err = query(*ints, out)
    if err != 0:
        raise RuntimeError(f"exp_{name} occupancy query failed: CUDA error "
                           f"{err}")
    blocks, threads, smem, pairs = out
    return {"blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32,
            "pairs_per_sm": blocks * pairs, "smem_bytes_per_block": smem,
            "smem_bytes_per_pair": smem / pairs}


def check_tracks(tracks, pad: int, multiple: int, what: str):
    """(R, B, W) of kernel-layout tracks tgt/qual (R, B) and
    win/opn/ext/mask/prior (W, B), W = R + 2*pad - 1, with B % multiple == 0
    (the experiment's own rule)."""
    if len(tracks) != 7 or any(t.dim() != 2 for t in tracks):
        raise ValueError("tracks must be (R, B) x 2 and (W, B) x 5")
    Rn, B = tracks[0].shape
    W = Rn + 2 * pad - 1
    if tracks[1].shape != (Rn, B) or any(t.shape != (W, B) for t in tracks[2:]):
        raise ValueError(f"tracks must be (R, B) x 2 and (W, B) x 5 with "
                         f"W = R + 2*pad - 1 = {W}")
    if B % multiple:
        raise ValueError(f"B = {B} is not a multiple of {multiple} ({what})")
    dev = tracks[0].device
    if any(t.device != dev for t in tracks):
        raise ValueError("tracks on more than one device")
    return Rn, B, W


def as_tracks(arrays, device) -> list[torch.Tensor]:
    """The tracks as contiguous int32 tensors on `device`."""
    return [torch.as_tensor(a).to(device=device, dtype=torch.int32).contiguous()
            for a in arrays]


def on_device(arrays, device):
    """(resolved device, tracks there) for an entry point's `device`."""
    dev = resolve_device(device)
    return dev, as_tracks(arrays, dev)


def dispatch(plain, kernel, arrays, device, **kw) -> torch.Tensor:
    """An entry point's work: the tracks to `device`, then `kernel` on a
    card or `plain` on the CPU, with the keywords `kw`."""
    dev, tracks = on_device(arrays, device)
    return (kernel if dev.type == "cuda" else plain)(*tracks, **kw)


def plain_v9(tracks, pad: int, nuc_prior: int) -> torch.Tensor:
    """v9's score of kernel-layout tracks: pairhmm_batch.pairhmm_scores_plain
    on the transposed (batch-major) tracks."""
    return pb.pairhmm_scores_plain(*(t.t() for t in tracks), pad=pad,
                                   nuc_prior=nuc_prior)


def parity_inputs(B: int = PARITY_B, win_hi: int = 5, seed: int = 0,
                  rows: int = R):
    """The experiments' check_parity tracks (numpy, kernel layout) of
    `rows` read bases: win in [0, win_hi), 4 being N."""
    rng = np.random.default_rng(seed)
    W = rows + 2 * PAD - 1
    return [rng.integers(lo, hi, shape).astype(np.int32)
            for lo, hi, shape in ((0, 4, (rows, B)), (10, 40, (rows, B)),
                                  (0, win_hi, (W, B)), (10, 50, (W, B)),
                                  (1, 8, (W, B)), (0, 4, (W, B)),
                                  (3, 40, (W, B)))]


# opn and ext stay below this (csrc/pairhmm.cu's overflow note: no int32
# sum wraps)
GAP_LIMIT = 1 << 22
# (read bases, kind) of the edge inputs the bench never hits: odd and even
# R from 2, R off the 16-row period and the 8-row chunk, window bases half
# N, opn and ext just below GAP_LIMIT
EDGE_CASES = ((2, "parity"), (3, "parity"), (17, "n_bases"),
              (24, "big_gaps"), (33, "parity"), (41, "big_gaps"))


def edge_inputs(B: int, rows: int, kind: str, seed: int = 0):
    """parity_inputs at `rows` read bases, changed by `kind`: "parity" as
    they are, "n_bases" with half the window bases N (4), "big_gaps" with
    opn and ext in [GAP_LIMIT - 64, GAP_LIMIT)."""
    tracks = parity_inputs(B, 5, seed, rows)
    rng = np.random.default_rng(seed + 1)
    if kind == "n_bases":
        tracks[2][rng.random(tracks[2].shape) < 0.5] = 4
    elif kind == "big_gaps":
        for i in (3, 4):
            tracks[i] = rng.integers(GAP_LIMIT - 64, GAP_LIMIT,
                                     tracks[i].shape).astype(np.int32)
    elif kind != "parity":
        raise ValueError(f"edge input kind {kind!r}")
    return tracks


def bench_inputs(B: int = BENCH_B, win_hi: int = 5, seed: int = 0,
                 device="cuda"):
    """The experiments' bench tracks at (R, B), made on `device` from a
    torch generator: the ranges of their bench (win in [0, win_hi))."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    W = R + 2 * PAD - 1
    return [torch.randint(lo, hi, shape, generator=gen, device=dev,
                          dtype=torch.int32)
            for lo, hi, shape in ((0, 4, (R, B)), (10, 40, (R, B)),
                                  (0, win_hi, (W, B)), (10, 50, (W, B)),
                                  (1, 8, (W, B)), (0, 4, (W, B)),
                                  (3, 40, (W, B)))]


def check_parity(label: str, fn, *, win_hi: int = 5, B: int = PARITY_B,
                 device="cuda", **kw) -> None:
    """fn on the experiment's check_parity inputs equals v9 (the plain
    version, and kernel #1 on a card), as experiments/*.py check it."""
    dev, tracks = on_device(parity_inputs(B, win_hi), device)
    got = fn(*tracks, pad=PAD, device=dev, **kw)
    want = [plain_v9(tracks, PAD, DEFAULT_NUC_PRIOR)]
    if dev.type == "cuda":
        want.append(pb.pairhmm_scores_cuda(*(t.t() for t in tracks), pad=PAD))
    for w in want:
        if not torch.equal(got, w):
            bad = torch.nonzero(got != w).flatten()[:5].tolist()
            raise AssertionError(f"parity {label}: differs at {bad}")
    print(f"parity {label} OK", flush=True)


def bench(label: str, fn, *, win_hi: int = 5, B: int = BENCH_B, **kw) -> float:
    """Time fn on the card at the bench shape (median of 7 CUDA-event runs)
    and print its rate, as the experiments' bench prints theirs; returns
    pairs a second."""
    tracks = bench_inputs(B, win_hi)
    ms = cuda_ms(lambda: fn(*tracks, pad=PAD, **kw))
    print(f"{label}: {B / ms / 1e3:.2f} M pairs/s ({ms:.4f} ms, "
          f"{torch.cuda.get_device_name(0)})", flush=True)
    return B / ms * 1e3


def v9_on_card(tgtT, qualT, winT, opnT, extT, maskT, priorT, *, pad=PAD,
               nuc_prior=DEFAULT_NUC_PRIOR, device="cuda"):
    """Kernel #1 (csrc/pairhmm.cu) on kernel-layout tracks, the baseline
    the experiments' bench times first."""
    return pb.pairhmm_scores_cuda(tgtT.t(), qualT.t(), winT.t(), opnT.t(),
                                  extT.t(), maskT.t(), priorT.t(), pad=pad,
                                  nuc_prior=nuc_prior)
