"""Batched banded pair-HMM scoring: three CUDA kernels and their plain twins.

The hot loop of the engine: one integer-phred banded Viterbi score per
read x haplotype pair. The contract is the reference package's
`pairhmm_scores` (batch-major):

* tgt/qual are (B, R) and win/opn/ext/mask/prior are (B, W) int32, with
  W = R + 2*pad - 1 and pad in {8, 16, 32};
* the band holds D = 2*pad diagonals; lane d of row y pairs read base y-1
  with window base y-1+d; states M/I/D advance row by row;
* ragged reads are padded with PAD_CODE at quality 0, which costs 0 on
  diagonal moves, so every row up to R runs and the last row's band
  minimum is the score;
* gaps out of row 0 start only at odd offsets (the reference kernel's
  parity rule), so scores are bit-identical to it;
* the output is (B,) int32.

All four TPU kernels of the reference compute this one function. The port
has three CUDA kernels, each with a plain PyTorch twin that runs on any
device and that the CPU tests hold against the reference:

* `pairhmm_scores_cuda` (csrc/pairhmm.cu, T threads a pair in a split
  chain or a wavefront schedule, tracks staged in shared memory; replaces
  Pallas v12 and v9) and its twin `pairhmm_scores_plain`, which ports the
  XLA wavefront (`_hmm_rows_fast`, `_match_cost_tensor`, `_deletion_scan`)
  and with threads=T runs the kernel's split chain (`_deletion_split`);
* `pairhmm_scores_lanes_cuda` (csrc/pairhmm_lanes.cu, the band on a warp's
  lanes, tracks staged in shared memory; replaces Pallas v8) and its twin
  `pairhmm_scores_lanes_plain`, which ports `_pallas_kernel_v8`'s own
  arithmetic (`pre = cumsum(ext)`, `_min_scan`);
* `pairhmm_scores_cost_cuda` (csrc/pairhmm_cost.cu, over a match-cost
  tensor built outside the kernel, T threads a pair in the split chain, cm
  staged in shared memory; replaces Pallas v2) and its twin
  `pairhmm_scores_cost_plain`, which with threads=T runs the kernel's
  split chain.

`pairhmm_scores` dispatches by the device of its inputs: the v12/v9
kernel on CUDA tensors and its twin on the CPU; with
OCTOPUS_TPU_UNROLLED_HMM=1, as the reference's dispatcher, the v8 kernel
on CUDA tensors and its twin on the CPU. The v2 entry points stay off the
dispatcher, as in the reference. Each CUDA wrapper counts its launches and
pairs in its own `KernelCounts`, and refuses CPU tensors. The kernels take
the tracks as they are: any row length, any alignment (4-byte copies).

Nothing here clamps the tracks to int8 (the TPU transfer width): like the
XLA path, every track is full int32.
"""

from __future__ import annotations

import ctypes
import os
import threading
from dataclasses import dataclass, field

import torch

from ...basics.sequence import N
from ...device import resolve_device

INF = 1 << 29
N_SCORE = 2
PAD_CODE = 5            # read padding: mismatches everything, costs 0 at qual 0
DEFAULT_NUC_PRIOR = 2
PADS = (8, 16, 32)
THREADS = (1, 2, 4, 8, 16)   # csrc/pairhmm.cu: threads a pair

# rows of match costs materialised at once by the plain scorer: bounds its
# memory at (rows * D, B) int32 whatever the read length
_COST_ROWS = 64

# The least time the card could take for the pair-HMM (chip_smoke.py's
# kernel table, bench.py's share of it): an NVIDIA H100 SXM5's int32 rate
# (SMs x INT32 lanes x boost clock) and its HBM3 rate.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
DRAM_BYTES_PER_S = 3.35e12
# the fewest int32 instructions a band cell needs on sm_90, with the DPX
# forms: match cost 6 (three compares, each with a predicated update), M 2
# (VIMNMX3 and an add), I 3 (an add, VIADDMNMX, nuc_prior), deletion open 2
# (a minimum and an add), deletion chain 1 (VIADDMNMX)
MATCH_COST_OPS = 6
OPS_PER_CELL = MATCH_COST_OPS + 2 + 3 + 2 + 1


def pairhmm_bound(B: int, R: int, pad: int) -> tuple[float, str]:
    """Least time, in ms, for B pairs of R rows at `pad`, and what binds it
    ("operations" or "bytes"): the larger of OPS_PER_CELL int32 ops per
    cell (plus row 0's deletion chain and the last row's band minimum, 3
    per lane each) over the int32 rate, and each track read once and the
    scores written once over the memory rate."""
    D = 2 * pad
    W = R + 2 * pad - 1
    ops = (OPS_PER_CELL * R + 6) * D * B
    nbytes = (2 * R + 5 * W) * 4 * B + 4 * B
    t_ops = ops / INT32_OPS_PER_S * 1e3
    t_bytes = nbytes / DRAM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _shift_down(a: torch.Tensor, fill: int) -> torch.Tensor:
    """Rows shift toward higher index: out[d] = a[d-1]; out[0] = fill."""
    return torch.cat([torch.full_like(a[:1], fill), a[:-1]], dim=0)


def _shift_up(a: torch.Tensor, fill: int) -> torch.Tensor:
    """out[d] = a[d+1]; out[D-1] = fill."""
    return torch.cat([a[1:], torch.full_like(a[:1], fill)], dim=0)


def _deletion_scan(bv: torch.Tensor, ev: torch.Tensor, D: int) -> torch.Tensor:
    """Inclusive min-plus prefix scan of the maps f_d: v -> min(bv[d], v+ev[d]).

    Returns the chain value at each lane when the chain is fed v=INF."""
    s = 1
    while s < D:
        bl = torch.cat([torch.full_like(bv[:s], INF), bv[:-s]], dim=0)
        el = torch.cat([torch.zeros_like(ev[:s]), ev[:-s]], dim=0)
        bv = torch.minimum(bv, bl + ev)
        ev = el + ev
        s *= 2
    return bv


def _deletion_split(bv: torch.Tensor, ev: torch.Tensor, D: int,
                    threads: int) -> torch.Tensor:
    """The chain of `_deletion_scan` computed as csrc/pairhmm.cu computes it
    with T = `threads` threads a pair: each thread runs the chain over its
    K = D/T consecutive diagonals from its segment's start, without input
    (lb) and with its ext sums (le); a log2(T)-step scan composes the
    segments' min-plus maps x -> min(B, x + E) across threads; thread t-1's
    map fed INF is thread t's input x, and the chain is min(lb, x + le).
    The same integers as `_deletion_scan`."""
    T = threads
    K = D // T
    B = bv.shape[1]
    bv = bv.reshape(T, K, B)
    ev = ev.reshape(T, K, B)
    lb = [bv[:, 0]]
    le = [ev[:, 0]]
    for k in range(1, K):
        lb.append(torch.minimum(bv[:, k], lb[-1] + ev[:, k]))
        le.append(le[-1] + ev[:, k])
    lb = torch.stack(lb, dim=1)
    le = torch.stack(le, dim=1)
    b, s = lb[:, -1], le[:, -1]
    t = torch.arange(T, device=bv.device)[:, None]
    step = 1
    while step < T:
        bp = torch.cat([torch.zeros_like(b[:step]), b[:-step]], dim=0)
        sp = torch.cat([torch.zeros_like(s[:step]), s[:-step]], dim=0)
        b, s = (torch.where(t >= step, torch.minimum(b, bp + s), b),
                torch.where(t >= step, s + sp, s))
        step *= 2
    end = torch.minimum(b, INF + s)
    x = torch.cat([torch.full_like(end[:1], INF), end[:-1]], dim=0)
    return torch.minimum(lb, x[:, None] + le).reshape(D, B)


def _min_scan(u: torch.Tensor, D: int) -> torch.Tensor:
    """Inclusive running minimum along the leading (diagonal) axis."""
    s = 1
    while s < D:
        u = torch.minimum(u, torch.cat([torch.full_like(u[:s], INF), u[:-s]],
                                       dim=0))
        s *= 2
    return u


def _match_cost_tensor(tgt, qual, win, mask, prior, y0: int, y1: int, D: int):
    """(y1-y0, D, B) match costs; [y, d] pairs target[y] with window[y+d]."""
    ids = (torch.arange(y0, y1, device=tgt.device)[:, None]
           + torch.arange(D, device=tgt.device)[None, :])          # (n, D)
    w_g, m_g, p_g = win[ids], mask[ids], prior[ids]                # (n, D, B)
    t = tgt[y0:y1, None, :]
    q = qual[y0:y1, None, :]
    capped = torch.where(m_g == t, torch.minimum(q, p_g), q)
    cm = torch.where(t == w_g, torch.zeros_like(capped), capped)
    return torch.where(w_g == N, torch.clamp(cm, max=N_SCORE), cm)


def _wavefront(cm_row, opn, ext, R: int, pad: int, nuc_prior: int,
               threads: int | None = None):
    """The XLA row wavefront (`_hmm_rows_fast`) over (D, B) match costs
    cm_row(y) of rows y = 1..R and (W, B) opn/ext -> (B,) scores. With
    `threads`, the deletion chain is `_deletion_split`'s, as
    csrc/pairhmm.cu runs it with that many threads a pair."""
    B = opn.shape[1]
    D = 2 * pad
    if threads is None:
        chain = _deletion_scan
    else:
        def chain(bv, ev, D):
            return _deletion_split(bv, ev, D, threads)
    d_odd = (torch.arange(D, device=opn.device) % 2 == 1)[:, None].expand(D, B)
    M = torch.zeros((D, B), dtype=torch.int32, device=opn.device)
    M_gap = torch.where(d_odd, M, torch.full_like(M, INF))
    Ii = torch.full_like(M, INF)
    Dd = chain(_shift_down(M_gap, INF) + _shift_down(opn[0:D], INF),
               _shift_down(ext[0:D], 0), D)
    for y in range(1, R + 1):
        off = y - 1
        cm = cm_row(y)
        opn_win = opn[off:off + D]
        ext_win = ext[off:off + D]
        # row 1: gap ops out of row 0 see the parity-masked M0
        M_for_gap = M_gap if y == 1 else M
        Mn = cm + torch.minimum(torch.minimum(M, Ii), Dd)
        In = nuc_prior + torch.minimum(_shift_up(M_for_gap, INF) + opn_win,
                                       _shift_up(Ii, INF) + ext_win)
        Dd = chain(_shift_down(torch.minimum(Mn, In), INF) + opn_win,
                   ext_win, D)
        M, Ii = Mn, In
    return torch.amin(torch.minimum(torch.minimum(M, Ii), Dd), dim=0)


def _hmm_rows(tgt, qual, win, opn, ext, mask, prior, pad: int, nuc_prior: int,
              threads: int | None = None):
    """Row wavefront over kernel-layout (rows, B) int32 tensors -> (B,),
    building the match costs _COST_ROWS rows at a time."""
    R = tgt.shape[0]
    D = 2 * pad
    block = {}

    def cm_row(y):
        off = y - 1
        if off % _COST_ROWS == 0:
            block["cm"] = _match_cost_tensor(tgt, qual, win, mask, prior, off,
                                             min(off + _COST_ROWS, R), D)
        return block["cm"][off % _COST_ROWS]

    return _wavefront(cm_row, opn, ext, R, pad, nuc_prior, threads)


def _hmm_rows_v8(tgt, qual, win, opn, ext, mask, prior, pad: int,
                 nuc_prior: int):
    """`_pallas_kernel_v8` on kernel-layout (rows, B) int32 tensors -> (B,):
    match costs per row, and the deletion chain as a running minimum over
    bv - pre with pre = cumsum(ext)."""
    R, B = tgt.shape
    D = 2 * pad
    pre = torch.cumsum(ext, dim=0, dtype=torch.int32)

    def cm_at(y):
        t = tgt[y - 1:y]
        q = qual[y - 1:y]
        w = win[y - 1:y - 1 + D]
        m = mask[y - 1:y - 1 + D]
        p = prior[y - 1:y - 1 + D]
        capped = torch.where(m == t, torch.minimum(q, p), q)
        pen = torch.where(t == w, torch.zeros_like(capped), capped)
        return torch.where(w == N, torch.clamp(pen, max=N_SCORE), pen)

    d_odd = (torch.arange(D, device=tgt.device) % 2 == 1)[:, None].expand(D, B)
    ZERO = torch.zeros((D, B), dtype=torch.int32, device=tgt.device)
    INFc = torch.full_like(ZERO, INF)
    M0_gap = torch.where(d_odd, ZERO, INFc)
    opn0 = _shift_down(opn[0:D], INF)
    pre0 = _shift_down(pre[0:D], 0)
    bv0 = _shift_down(M0_gap, INF) + opn0
    Dd = _min_scan(bv0 - pre0, D) + pre0
    M, Ii = ZERO, INFc
    for y in range(1, R + 1):
        cm = cm_at(y)
        opn_win = opn[y - 1:y - 1 + D]
        ext_win = ext[y - 1:y - 1 + D]
        pre_win = pre[y - 1:y - 1 + D]
        M_for_gap = M0_gap if y == 1 else M
        Mn = cm + torch.minimum(torch.minimum(M, Ii), Dd)
        In = nuc_prior + torch.minimum(_shift_up(M_for_gap, INF) + opn_win,
                                       _shift_up(Ii, INF) + ext_win)
        bv = _shift_down(torch.minimum(Mn, In), INF) + opn_win
        Dd = _min_scan(bv - pre_win, D) + pre_win
        M, Ii = Mn, In
    return torch.amin(torch.minimum(torch.minimum(M, Ii), Dd), dim=0)


def _check_shapes(tgt, qual, win, opn, ext, mask, prior, pad: int):
    if pad not in PADS:
        raise ValueError(f"pad {pad} not in {PADS}")
    B, R = tgt.shape
    W = R + 2 * pad - 1
    if qual.shape != (B, R):
        raise ValueError(f"qual {tuple(qual.shape)} != {(B, R)}")
    for name, a in zip(("win", "opn", "ext", "mask", "prior"),
                       (win, opn, ext, mask, prior)):
        if a.shape != (B, W):
            raise ValueError(f"{name} {tuple(a.shape)} != {(B, W)}")
    dev = tgt.device
    for a in (qual, win, opn, ext, mask, prior):
        if a.device != dev:
            raise ValueError(f"inputs on {a.device} and {dev}")
    return B, R, W


def _check_threads(threads: int | None, pad: int) -> None:
    if threads is not None and threads not in THREADS:
        raise ValueError(f"threads {threads} not in {THREADS}")
    if threads is not None and threads > 2 * pad:
        raise ValueError(f"threads {threads} > band {2 * pad}")


def _kernel_layout(*tracks) -> list[torch.Tensor]:
    """Batch-major tracks as contiguous int32 (rows, B)."""
    return [a.to(torch.int32).t().contiguous() for a in tracks]


def pairhmm_scores_plain(tgt, qual, win, opn, ext, mask, prior, *, pad: int = 8,
                         nuc_prior: int = DEFAULT_NUC_PRIOR,
                         threads: int | None = None) -> torch.Tensor:
    """Plain PyTorch scorer on any device (the XLA wavefront): (B,) int32.

    threads=T runs the deletion chain as csrc/pairhmm.cu does with T
    threads a pair (`_deletion_split`); the scores are the same."""
    _check_shapes(tgt, qual, win, opn, ext, mask, prior, pad)
    _check_threads(threads, pad)
    return _hmm_rows(*_kernel_layout(tgt, qual, win, opn, ext, mask, prior),
                     pad, nuc_prior, threads)


def pairhmm_scores_lanes_plain(tgt, qual, win, opn, ext, mask, prior, *,
                               pad: int = 8,
                               nuc_prior: int = DEFAULT_NUC_PRIOR
                               ) -> torch.Tensor:
    """Plain twin of the lanes kernel (Pallas v8's arithmetic) on any
    device: (B,) int32 scores."""
    _check_shapes(tgt, qual, win, opn, ext, mask, prior, pad)
    return _hmm_rows_v8(*_kernel_layout(tgt, qual, win, opn, ext, mask, prior),
                        pad, nuc_prior)


def match_cost_tensor(tgt, qual, win, mask, prior, *, pad: int) -> torch.Tensor:
    """The (R*D, B) int32 match-cost tensor of batch-major tracks, as XLA
    builds it outside Pallas v2 (row (y-1)*D + d pairs read base y-1 with
    window base y-1+d)."""
    R, B = tgt.shape[1], tgt.shape[0]
    D = 2 * pad
    t, q, w, m, p = _kernel_layout(tgt, qual, win, mask, prior)
    return _match_cost_tensor(t, q, w, m, p, 0, R, D).reshape(R * D, B)


def pairhmm_scores_cost_plain(tgt, qual, win, opn, ext, mask, prior, *,
                              pad: int = 8,
                              nuc_prior: int = DEFAULT_NUC_PRIOR,
                              threads: int | None = None) -> torch.Tensor:
    """Plain twin of the cost kernel (Pallas v2: the XLA wavefront over a
    whole match-cost tensor) on any device: (B,) int32 scores.

    threads=T runs the deletion chain as csrc/pairhmm_cost.cu does with T
    threads a pair (`_deletion_split`); the scores are the same."""
    _check_shapes(tgt, qual, win, opn, ext, mask, prior, pad)
    _check_threads(threads, pad)
    R = tgt.shape[1]
    D = 2 * pad
    cm = match_cost_tensor(tgt, qual, win, mask, prior, pad=pad)
    opnT, extT = _kernel_layout(opn, ext)
    return _wavefront(lambda y: cm[(y - 1) * D:y * D], opnT, extT, R, pad,
                      nuc_prior, threads)


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/pairhmm.cu, csrc/pairhmm_lanes.cu, csrc/pairhmm_cost.cu)
# ---------------------------------------------------------------------------

@dataclass
class KernelCounts:
    """Launches of one CUDA kernel, the pairs they scored and the most rows
    (read length R) of one launch."""

    launches: int = 0
    pairs: int = 0
    max_rows: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False,
                                  compare=False)

    def add(self, pairs: int, rows: int = 0) -> None:
        with self._lock:
            self.launches += 1
            self.pairs += pairs
            self.max_rows = max(self.max_rows, rows)

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.pairs = 0
            self.max_rows = 0


COUNTS = KernelCounts()          # csrc/pairhmm.cu (Pallas v12 and v9)
COUNTS_LANES = KernelCounts()    # csrc/pairhmm_lanes.cu (Pallas v8)
COUNTS_COST = KernelCounts()     # csrc/pairhmm_cost.cu (Pallas v2)
KERNEL_COUNTS = {"pairhmm": COUNTS, "pairhmm_lanes": COUNTS_LANES,
                 "pairhmm_cost": COUNTS_COST}

# kernel -> (C entry point, device pointers including the output, ints
# after B, R, W, pad, nuc_prior); then the stream. pairhmm takes its
# threads a pair and its schedule (split chain or wavefront);
# pairhmm_lanes its lanes a pair.
_ENTRY = {"pairhmm": ("pairhmm_launch", 8, 2),
          "pairhmm_lanes": ("pairhmm_lanes_launch", 8, 1),
          "pairhmm_cost": ("pairhmm_cost_launch", 4, 1)}
# kernel -> (C function (pad, *variant) -> dynamic shared memory of a
# block, number of variant ints)
_SMEM_ENTRY = {"pairhmm": ("pairhmm_smem_bytes", 2),
               "pairhmm_lanes": ("pairhmm_lanes_smem_bytes", 1),
               "pairhmm_cost": ("pairhmm_cost_smem_bytes", 1)}
_libs: dict = {}

# The rule for both kernels' variants, from chip_smoke.py's timing of every
# variant at the bench and main-path shapes and at 1024-32768 pairs
# (variant_sweep; PERF.md). Below WAVE_BELOW pairs a launch is latency, not
# work: csrc/pairhmm.cu's wavefront with two diagonals a thread (four at
# band 32, where T stops at 16), csrc/pairhmm_lanes.cu at full lane width.
# At and above it the batch fills the card: the split chain with
# SPLIT_THREADS threads a pair (the fastest at the bench shape) and half
# the lane width. No path of the port launches that many pairs today.
WAVE_BELOW = 8192
SPLIT_THREADS = 4


def pairhmm_threads(B: int, pad: int) -> int:
    """Threads a pair for a csrc/pairhmm.cu launch of B pairs at `pad`."""
    return min(pad, THREADS[-1]) if B < WAVE_BELOW else SPLIT_THREADS


def pairhmm_wave(B: int, pad: int) -> bool:
    """Whether a csrc/pairhmm.cu launch of B pairs runs the wavefront
    schedule (the split chain otherwise)."""
    return B < WAVE_BELOW


def wave_ok(threads: int, pad: int) -> bool:
    """csrc/pairhmm.cu has a wavefront variant at this T and pad."""
    return threads >= 2 and 2 * pad // threads >= 2


# csrc/pairhmm_cost.cu's rule, read off chip_smoke.py's timing of every T
# at every kernel case (variant_sweep; PERF.md): (launches below this many
# pairs, threads a pair). Under 2048 pairs only 16 threads a pair fill the
# card; up to 16384, 4 (a shorter carry a row); above, 2 (the bench shape).
COST_THREADS_BY_B = ((2048, 16), (16384, 4), (None, 2))
# a thread of csrc/pairhmm_cost.cu holds at most this many diagonals
COST_MAX_DIAGONALS = 16


def cost_threads_ok(threads: int, pad: int) -> bool:
    """csrc/pairhmm_cost.cu has a variant with `threads` a pair at `pad`."""
    return threads in THREADS and 2 * pad // COST_MAX_DIAGONALS <= threads <= 2 * pad


def cost_threads(B: int, pad: int) -> int:
    """Threads a pair for a csrc/pairhmm_cost.cu launch of B pairs (at
    least D/COST_MAX_DIAGONALS)."""
    T = next(t for below, t in COST_THREADS_BY_B if below is None or B < below)
    return max(T, 2 * pad // COST_MAX_DIAGONALS)


def lanes_width(B: int, pad: int) -> int:
    """Lanes a pair for a csrc/pairhmm_lanes.cu launch: min(D, 32) below
    WAVE_BELOW pairs (latency: the shorter scan loses less than the second
    diagonal costs), half of it above (throughput: fewer shuffles a cell)."""
    lw = min(2 * pad, 32)
    return lw if B < WAVE_BELOW else lw // 2


def lanes_widths(pad: int) -> tuple[int, int]:
    """The two lane widths csrc/pairhmm_lanes.cu is built for at `pad`."""
    lw = min(2 * pad, 32)
    return lw, lw // 2


def kernel_library(name: str = "pairhmm"):
    """Build (first call only) and load csrc/<name>.cu's shared library."""
    lib = _libs.get(name)
    if lib is None:
        from ..._build import CSRC, build, nvcc_path
        src = CSRC / f"{name}.cu"
        sources = [src] + ([CSRC / "pairhmm_stage.cuh"] if name in _SMEM_ENTRY
                           else [])
        path = build(
            name, sources,
            lambda out: [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                         "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                         "-Xptxas", "-v", src, "-o", out],
            ".so")
        lib = ctypes.CDLL(str(path))
        entry, n_ptr, n_extra = _ENTRY[name]
        fn = getattr(lib, entry)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * (5 + n_extra)
                       + [ctypes.c_void_p])
        if name in _SMEM_ENTRY:
            smem_fn, n_variant = _SMEM_ENTRY[name]
            smem = getattr(lib, smem_fn)
            smem.restype = ctypes.c_int
            smem.argtypes = [ctypes.c_int] * (1 + n_variant)
        _libs[name] = lib
    return lib


def smem_bytes(name: str, pad: int, *variant: int) -> int:
    """Dynamic shared memory of one block of kernel `name` (built on first
    use) at `pad` and its variant: (threads a pair, wavefront) for pairhmm,
    (lanes a pair,) for pairhmm_lanes, (threads a pair,) for
    pairhmm_cost."""
    n = getattr(kernel_library(name), _SMEM_ENTRY[name][0])(pad, *variant)
    if n < 0:
        raise ValueError(f"{name}: no variant {variant} at pad {pad}")
    return n


def _raw_stream(index: int) -> int:
    """The current CUDA stream of device `index` as an int."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def _launch(name: str, tensors: list[torch.Tensor], B: int, R: int, W: int,
            pad: int, nuc_prior: int, extra: tuple = ()) -> torch.Tensor:
    """One launch of kernel `name` on contiguous int32 tensors of one CUDA
    device; counts it in KERNEL_COUNTS[name]. A main-path launch scores a
    few hundred pairs in tens of microseconds of card time, so the host
    work here is kept to the checks and one ctypes call."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    index = dev.index
    for t in tensors:
        if (t.dtype != torch.int32 or not t.is_contiguous()
                or t.get_device() != index):
            raise ValueError(f"{name} tracks must be contiguous int32 on {dev}")
    out = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return out
    fn = getattr(kernel_library(name), _ENTRY[name][0])
    args = [t.data_ptr() for t in tensors]
    args += [out.data_ptr(), B, R, W, pad, nuc_prior, *extra,
             _raw_stream(index)]
    if index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    KERNEL_COUNTS[name].add(B, R)
    return out


def _require_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {t.device}")


def _batch_major(name: str, tracks: list[torch.Tensor]) -> tuple[int, int, int]:
    """(B, R, W) of batch-major tracks: tgt/qual (B, R) and the five window
    tracks (B, W)."""
    message = f"{name} tracks must be (B, R) x 2 and (B, W) x 5"
    if len(tracks) != 7 or any(t.dim() != 2 for t in tracks):
        raise ValueError(message)
    B, R = tracks[0].shape
    W = tracks[2].shape[1]
    if tracks[1].shape != (B, R) or any(t.shape != (B, W) for t in tracks[2:]):
        raise ValueError(message)
    return B, R, W


def pairhmm_scores_cuda(tgt, qual, win, opn, ext, mask, prior, *, pad: int = 8,
                        nuc_prior: int = DEFAULT_NUC_PRIOR) -> torch.Tensor:
    """Launch csrc/pairhmm.cu on CUDA int32 tensors: (B,) int32 scores. The
    kernel reads batch-major tracks, so nothing is transposed."""
    _check_shapes(tgt, qual, win, opn, ext, mask, prior, pad)
    _require_cuda("pairhmm_scores_cuda", tgt)
    return launch_kernel([a.to(torch.int32).contiguous()
                          for a in (tgt, qual, win, opn, ext, mask, prior)],
                         pad=pad, nuc_prior=nuc_prior)


def launch_kernel(tracks: list[torch.Tensor], *, pad: int,
                  nuc_prior: int = DEFAULT_NUC_PRIOR, threads: int | None = None,
                  wave: bool | None = None) -> torch.Tensor:
    """One launch of csrc/pairhmm.cu on batch-major tracks: tgt/qual (B, R)
    and win/opn/ext/mask/prior (B, W), contiguous int32 on one CUDA device.
    threads (T a pair) defaults to `pairhmm_threads`, wave to
    `pairhmm_wave`."""
    B, R, W = _batch_major("pairhmm", tracks)
    if threads is None:
        T = pairhmm_threads(B, pad)
        wave = pairhmm_wave(B, pad) if wave is None else wave
    else:
        T, wave = threads, bool(wave)
    if T not in THREADS or T > 2 * pad:
        raise ValueError(f"threads {T} not in {THREADS} up to band {2 * pad}")
    if wave and not wave_ok(T, pad):
        raise ValueError(f"no wavefront at {T} threads, band {2 * pad}")
    return _launch("pairhmm", tracks, B, R, W, pad, nuc_prior,
                   (T, int(wave)))


def pairhmm_scores_lanes_cuda(tgt, qual, win, opn, ext, mask, prior, *,
                              pad: int = 8,
                              nuc_prior: int = DEFAULT_NUC_PRIOR
                              ) -> torch.Tensor:
    """Launch csrc/pairhmm_lanes.cu on CUDA int32 tensors: (B,) int32
    scores. The kernel reads batch-major tracks, so nothing is transposed."""
    _check_shapes(tgt, qual, win, opn, ext, mask, prior, pad)
    _require_cuda("pairhmm_scores_lanes_cuda", tgt)
    return launch_lanes([a.to(torch.int32).contiguous()
                         for a in (tgt, qual, win, opn, ext, mask, prior)],
                        pad=pad, nuc_prior=nuc_prior)


def launch_lanes(tracks: list[torch.Tensor], *, pad: int,
                 nuc_prior: int = DEFAULT_NUC_PRIOR, lanes: int | None = None
                 ) -> torch.Tensor:
    """One launch of csrc/pairhmm_lanes.cu on batch-major tracks: tgt/qual
    (B, R) and win/opn/ext/mask/prior (B, W), contiguous int32 on one CUDA
    device. lanes (LW a pair) defaults to `lanes_width`."""
    B, R, W = _batch_major("pairhmm_lanes", tracks)
    LW = lanes_width(B, pad) if lanes is None else lanes
    if pad not in PADS or LW not in lanes_widths(pad):
        raise ValueError(f"lanes {LW} not in {lanes_widths(pad) if pad in PADS else ()}")
    return _launch("pairhmm_lanes", tracks, B, R, W, pad, nuc_prior,
                   (LW,))


def pairhmm_scores_cost_cuda(tgt, qual, win, opn, ext, mask, prior, *,
                             pad: int = 8,
                             nuc_prior: int = DEFAULT_NUC_PRIOR
                             ) -> torch.Tensor:
    """Build the match-cost tensor with torch (as XLA does outside Pallas v2)
    and launch csrc/pairhmm_cost.cu on it: (B,) int32 scores."""
    _check_shapes(tgt, qual, win, opn, ext, mask, prior, pad)
    _require_cuda("pairhmm_scores_cost_cuda", tgt)
    cm = match_cost_tensor(tgt, qual, win, mask, prior, pad=pad)
    opnT, extT = _kernel_layout(opn, ext)
    return launch_cost(cm, opnT, extT, pad=pad, nuc_prior=nuc_prior)


def launch_cost(cm: torch.Tensor, opn: torch.Tensor, ext: torch.Tensor, *,
                pad: int, nuc_prior: int = DEFAULT_NUC_PRIOR,
                threads: int | None = None) -> torch.Tensor:
    """One launch of csrc/pairhmm_cost.cu: cm (R*D, B) and opn/ext (W, B),
    contiguous int32 on one CUDA device. threads (T a pair) defaults to
    `cost_threads`."""
    D = 2 * pad
    RD, B = cm.shape
    W = opn.shape[0]
    if RD % D or ext.shape != opn.shape or opn.shape[1] != B:
        raise ValueError(f"cm {tuple(cm.shape)} / opn {tuple(opn.shape)} / "
                         f"ext {tuple(ext.shape)} do not fit band {D}")
    T = cost_threads(B, pad) if threads is None else threads
    if pad not in PADS or not cost_threads_ok(T, pad):
        raise ValueError(f"no csrc/pairhmm_cost.cu variant at {T} threads, "
                         f"band {D}")
    return _launch("pairhmm_cost", [cm, opn, ext], B, RD // D, W, pad,
                   nuc_prior, (T,))


def unrolled_hmm() -> bool:
    """OCTOPUS_TPU_UNROLLED_HMM=1 selects the v8 scorer, as in the
    reference's dispatcher."""
    return os.environ.get("OCTOPUS_TPU_UNROLLED_HMM") == "1"


def scorer_name(device: torch.device) -> str:
    """The scorer `pairhmm_scores` runs on `device` now: a kernel name on
    CUDA, its plain twin's name on the CPU."""
    kernel = "pairhmm_lanes" if unrolled_hmm() else "pairhmm"
    return kernel if device.type == "cuda" else kernel + "_plain"


def _scorer(device: torch.device):
    """The function `scorer_name(device)` names."""
    return {"pairhmm": pairhmm_scores_cuda,
            "pairhmm_plain": pairhmm_scores_plain,
            "pairhmm_lanes": pairhmm_scores_lanes_cuda,
            "pairhmm_lanes_plain": pairhmm_scores_lanes_plain}[scorer_name(device)]


# The fewest pairs a batch holds before it shards over several cards; None
# shards none. Set from scripts/torch_shard_floor.py (PERF.md, Findings).
SHARD_MIN_PAIRS: int | None = None


def _shardable_devices(B: int, device: torch.device) -> list[torch.device]:
    """The local cards one batch of B pairs shards over; [device] alone
    means unsharded.

    Pairs are independent, so a batch of at least SHARD_MIN_PAIRS pairs
    shards whenever every card gets a whole number of pairs: the most local
    cards n with B % n == 0 (the reference's quantum off the TPU, one
    pair), from `device` on. Only a CUDA device shards;
    OCTOPUS_TPU_NO_SHARD=1 turns sharding off."""
    if (device.type != "cuda" or SHARD_MIN_PAIRS is None
            or B < SHARD_MIN_PAIRS
            or os.environ.get("OCTOPUS_TPU_NO_SHARD") == "1"):
        return [device]
    n = torch.cuda.device_count()
    while n > 1 and B % n:
        n -= 1
    if n <= 1:
        return [device]
    from ...parallel.sharding import make_mesh
    first = device.index if device.index is not None \
        else torch.cuda.current_device()
    return make_mesh(n, first)


def _pairhmm_scores_sharded(devices, tgt, qual, win, opn, ext, mask, prior, *,
                            pad: int, nuc_prior: int) -> torch.Tensor:
    """Data-parallel pair-HMM over `devices`: pure batch sharding, no
    collectives. Shard i, the i-th of len(devices) near-equal contiguous
    parts of the batch, is copied to devices[i] and scored there by the
    scorer `scorer_name` picks for it (one kernel launch a card, on its
    current stream, so the cards overlap); the host gathers the scores in
    shard order: (B,) int32 on the CPU."""
    tracks = [torch.as_tensor(a) for a in (tgt, qual, win, opn, ext, mask, prior)]
    parts = [torch.tensor_split(t, len(devices)) for t in tracks]
    scores = []
    for i, dev in enumerate(devices):
        shard = [p[i].to(device=dev, dtype=torch.int32) for p in parts]
        scores.append(_scorer(dev)(*shard, pad=pad, nuc_prior=nuc_prior))
    return torch.cat([s.cpu() for s in scores])


def pairhmm_scores(tgt, qual, win, opn, ext, mask, prior, *, pad: int = 8,
                   nuc_prior: int = DEFAULT_NUC_PRIOR,
                   device: torch.device | str | None = None) -> torch.Tensor:
    """Score a batch on `device`.

    The default is the device of torch inputs, and "cuda" for numpy inputs,
    which raises without CUDA; pass device="cpu" to run on the CPU. Inputs
    are copied to `device`. A CUDA device runs csrc/pairhmm.cu, or
    csrc/pairhmm_lanes.cu under OCTOPUS_TPU_UNROLLED_HMM=1; the CPU runs
    the kernel's plain twin. On a host with several cards a batch of
    SHARD_MIN_PAIRS or more shards over them (`_shardable_devices`) and the
    scores come back on the CPU."""
    if device is None:
        device = tgt.device if isinstance(tgt, torch.Tensor) else "cuda"
    dev = resolve_device(device)
    devices = _shardable_devices(int(tgt.shape[0]), dev)
    if len(devices) > 1:
        return _pairhmm_scores_sharded(devices, tgt, qual, win, opn, ext,
                                       mask, prior, pad=pad,
                                       nuc_prior=nuc_prior)
    args = [torch.as_tensor(a).to(device=dev, dtype=torch.int32)
            for a in (tgt, qual, win, opn, ext, mask, prior)]
    return _scorer(dev)(*args, pad=pad, nuc_prior=nuc_prior)


__all__ = [
    "pairhmm_scores",
    "pairhmm_scores_plain",
    "pairhmm_scores_cuda",
    "pairhmm_scores_lanes_plain",
    "pairhmm_scores_lanes_cuda",
    "pairhmm_scores_cost_plain",
    "pairhmm_scores_cost_cuda",
    "match_cost_tensor",
    "launch_kernel",
    "launch_lanes",
    "launch_cost",
    "kernel_library",
    "smem_bytes",
    "pairhmm_threads",
    "pairhmm_wave",
    "wave_ok",
    "lanes_width",
    "lanes_widths",
    "cost_threads",
    "cost_threads_ok",
    "THREADS",
    "scorer_name",
    "COUNTS",
    "COUNTS_LANES",
    "COUNTS_COST",
    "KERNEL_COUNTS",
    "KernelCounts",
    "PAD_CODE",
    "INF",
    "N_SCORE",
]
