"""rANS 4x8 entropy codec (CRAM block compression method 4).

Implements the rANS4x8 order-0 and order-1 byte codec from the CRAM codecs
specification (the reference reads CRAM via htslib, whose rANS_static.c is
the canonical implementation; see src/io/read/htslib_sam_facade.cpp for the
facade this replaces).  Four interleaved 32-bit range-coder states, 12-bit
normalised frequencies, byte-wise renormalisation at 2^23.

Pure numpy/python; streams are small (CRAM slice blocks) and decode is
table-driven, so this is host-side I/O work, not device work.
"""

from __future__ import annotations

import struct

import numpy as np

# native decode hot loop (csrc/octopus_native.cpp); built at first use,
# falsy on a host without a toolchain (the python fallback then runs)
from .._build import NATIVE as _native

TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT          # 4096
RANS_LOW = 1 << 23


# ---------------------------------------------------------------------------
# frequency tables
# ---------------------------------------------------------------------------

def _normalise(counts: np.ndarray, total: int = TOTFREQ) -> np.ndarray:
    """Scale counts to sum exactly `total`, keeping nonzero counts >= 1."""
    n = counts.sum()
    if n == 0:
        return counts.astype(np.int64)
    freqs = np.floor(counts * (total / n)).astype(np.int64)
    freqs[(counts > 0) & (freqs == 0)] = 1
    # fix the rounding drift, never driving a present symbol to zero
    drift = total - int(freqs.sum())
    while drift != 0:
        i = int(np.argmax(freqs))
        adj = drift if drift > 0 else -min(int(freqs[i]) - 1, -drift)
        freqs[i] += adj
        drift -= adj
    return freqs


def _write_freqs(freqs: np.ndarray, out: bytearray) -> None:
    """Order-0 table serialisation (symbol run-length + 1/2-byte freqs)."""
    syms = np.flatnonzero(freqs)
    rle = 0
    for i, s in enumerate(syms):
        if rle > 0:
            rle -= 1
        else:
            out.append(int(s))
            if i > 0 and syms[i - 1] == s - 1:
                # count how many more consecutive symbols follow
                j = i
                while j + 1 < len(syms) and syms[j + 1] == syms[j] + 1:
                    j += 1
                rle = j - i
                out.append(rle)
        f = int(freqs[s])
        if f < 128:
            out.append(f)
        else:
            out.append(128 | (f >> 8))
            out.append(f & 0xFF)
    out.append(0)


def _read_freqs(data: bytes, off: int) -> tuple[np.ndarray, int]:
    freqs = np.zeros(256, dtype=np.int64)
    rle = 0
    j = data[off]
    off += 1
    while True:
        f = data[off]
        off += 1
        if f >= 128:
            f = ((f & 127) << 8) | data[off]
            off += 1
        freqs[j] = f
        if rle > 0:
            rle -= 1
            j += 1
        elif data[off] == j + 1:
            j = data[off]
            rle = data[off + 1]
            off += 2
        else:
            j = data[off]
            off += 1
        if j == 0:
            break
    return freqs, off


def _tables(freqs: np.ndarray):
    cum = np.zeros(257, dtype=np.int64)
    np.cumsum(freqs, out=cum[1:])
    # symbol lookup by 12-bit slot
    sym_of = np.zeros(TOTFREQ, dtype=np.uint8)
    for s in np.flatnonzero(freqs):
        sym_of[cum[s]:cum[s + 1]] = s
    return cum, sym_of


# ---------------------------------------------------------------------------
# order-0
# ---------------------------------------------------------------------------

def _enc_flush(state: int, out: bytearray) -> None:
    out += struct.pack("<I", state)[::-1]   # bytes reversed (stream reversed later)


def _enc_put(state: int, freq: int, start: int, out: bytearray) -> int:
    x_max = ((RANS_LOW >> TF_SHIFT) << 8) * freq
    while state >= x_max:
        out.append(state & 0xFF)
        state >>= 8
    return ((state // freq) << TF_SHIFT) + (state % freq) + start


def _encode0_payload(data: bytes, freqs: np.ndarray) -> bytes:
    cum, _ = _tables(freqs)
    out = bytearray()
    states = [RANS_LOW] * 4
    n = len(data)
    # symbols encoded in reverse; symbol i belongs to state i % 4
    for i in range(n - 1, -1, -1):
        s = data[i]
        states[i & 3] = _enc_put(states[i & 3], int(freqs[s]), int(cum[s]), out)
    for j in (3, 2, 1, 0):
        _enc_flush(states[j], out)
    return bytes(out[::-1])


def _decode0_payload(comp: bytes, freqs: np.ndarray, out_sz: int) -> bytes:
    cum, sym_of = _tables(freqs)
    states = list(struct.unpack_from("<4I", comp, 0))
    ptr = 16
    out = bytearray(out_sz)
    for i in range(out_sz):
        j = i & 3
        x = states[j]
        slot = x & (TOTFREQ - 1)
        s = int(sym_of[slot])
        out[i] = s
        x = int(freqs[s]) * (x >> TF_SHIFT) + slot - int(cum[s])
        while x < RANS_LOW and ptr < len(comp):
            x = (x << 8) | comp[ptr]
            ptr += 1
        states[j] = x
    return bytes(out)


# ---------------------------------------------------------------------------
# order-1
# ---------------------------------------------------------------------------

def _encode1_payload(data: bytes, freqs: np.ndarray) -> bytes:
    """freqs: (256, 256) context tables, each normalised to TOTFREQ."""
    cums = np.zeros((256, 257), dtype=np.int64)
    np.cumsum(freqs, axis=1, out=cums[:, 1:])
    n = len(data)
    isz4 = n >> 2
    out = bytearray()
    states = [RANS_LOW] * 4
    # fragment j covers [j*isz4, (j+1)*isz4); tail belongs to fragment 3
    ends = [isz4, 2 * isz4, 3 * isz4, n]
    startpos = [0, isz4, 2 * isz4, 3 * isz4]
    # encode reverse-interleaved: process positions from the back of each
    # fragment; tail of fragment 3 first (it is longest)
    pos = [ends[j] - 1 for j in range(4)]
    while pos[3] >= startpos[3] + isz4:          # tail: state 3 alone
        p = pos[3]
        ctx = data[p - 1] if p > startpos[3] else 0
        s = data[p]
        states[3] = _enc_put(states[3], int(freqs[ctx, s]), int(cums[ctx, s]), out)
        pos[3] -= 1
    for _ in range(isz4):
        for j in (3, 2, 1, 0):
            p = pos[j]
            ctx = data[p - 1] if p > startpos[j] else 0
            s = data[p]
            states[j] = _enc_put(states[j], int(freqs[ctx, s]), int(cums[ctx, s]), out)
            pos[j] -= 1
    for j in (3, 2, 1, 0):
        _enc_flush(states[j], out)
    return bytes(out[::-1])


def _decode1_payload(comp: bytes, freqs: np.ndarray, out_sz: int) -> bytes:
    cums = np.zeros((256, 257), dtype=np.int64)
    np.cumsum(freqs, axis=1, out=cums[:, 1:])
    sym_of = np.zeros((256, TOTFREQ), dtype=np.uint8)
    for c in range(256):
        f = freqs[c]
        for s in np.flatnonzero(f):
            sym_of[c, cums[c, s]:cums[c, s + 1]] = s
    states = list(struct.unpack_from("<4I", comp, 0))
    ptr = 16
    isz4 = out_sz >> 2
    out = bytearray(out_sz)
    ctx = [0, 0, 0, 0]
    pos = [0, isz4, 2 * isz4, 3 * isz4]

    def step(j):
        nonlocal ptr
        x = states[j]
        slot = x & (TOTFREQ - 1)
        s = int(sym_of[ctx[j], slot])
        out[pos[j]] = s
        x = int(freqs[ctx[j], s]) * (x >> TF_SHIFT) + slot - int(cums[ctx[j], s])
        while x < RANS_LOW and ptr < len(comp):
            x = (x << 8) | comp[ptr]
            ptr += 1
        states[j] = x
        ctx[j] = s
        pos[j] += 1

    for _ in range(isz4):
        for j in range(4):
            step(j)
    while pos[3] < out_sz:                       # remainder: state 3
        step(3)
    return bytes(out)


# ---------------------------------------------------------------------------
# public stream API (9-byte header + freq table + payload)
# ---------------------------------------------------------------------------

def compress(data: bytes, order: int = 0) -> bytes:
    if order == 1 and len(data) < 8:
        order = 0
    body = bytearray()
    if order == 0:
        counts = np.bincount(np.frombuffer(data, np.uint8), minlength=256) \
            if data else np.zeros(256, np.int64)
        if not data:
            counts = counts.copy()
            counts[0] = 1
        freqs = _normalise(counts)
        _write_freqs(freqs, body)
        body += _encode0_payload(data, freqs)
    else:
        arr = np.frombuffer(data, np.uint8)
        n = len(arr)
        isz4 = n >> 2
        counts = np.zeros((256, 256), dtype=np.int64)
        ctx = np.empty(n, np.uint8)
        ctx[0] = 0
        ctx[1:] = arr[:-1]
        for j in range(1, 4):                    # fragment starts use context 0
            ctx[j * isz4] = 0
        np.add.at(counts, (ctx, arr), 1)
        freqs = np.zeros_like(counts)
        outer = bytearray()
        present = np.flatnonzero(counts.sum(axis=1))
        rle = 0
        for i, c in enumerate(present):
            if rle > 0:
                rle -= 1
            else:
                outer.append(int(c))
                if i > 0 and present[i - 1] == c - 1:
                    j = i
                    while j + 1 < len(present) and present[j + 1] == present[j] + 1:
                        j += 1
                    rle = j - i
                    outer.append(rle)
            freqs[c] = _normalise(counts[c])
            _write_freqs(freqs[c], outer)
        outer.append(0)
        body += outer
        body += _encode1_payload(data, freqs)
    return struct.pack("<BII", order, len(body), len(data)) + bytes(body)


def uncompress(stream: bytes) -> bytes:
    if _native:
        return _native.rans_uncompress(stream)
    return _uncompress_py(stream)


def _uncompress_py(stream: bytes) -> bytes:
    order, comp_sz, out_sz = struct.unpack_from("<BII", stream, 0)
    off = 9
    if out_sz == 0:
        return b""
    if order == 0:
        freqs, off = _read_freqs(stream, off)
        return _decode0_payload(stream[off:], freqs, out_sz)
    if order != 1:
        raise ValueError(f"rANS order {order} not supported")
    freqs = np.zeros((256, 256), dtype=np.int64)
    rle = 0
    c = stream[off]
    off += 1
    while True:
        freqs[c], off = _read_freqs(stream, off)
        if rle > 0:
            rle -= 1
            c += 1
        elif stream[off] == c + 1:
            c = stream[off]
            rle = stream[off + 1]
            off += 2
        else:
            c = stream[off]
            off += 1
        if c == 0:
            break
    return _decode1_payload(stream[off:], freqs, out_sz)


__all__ = ["compress", "uncompress"]
