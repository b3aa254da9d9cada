"""rANS 4x8 entropy codec (CRAM block compression method 4).

Implements the rANS4x8 order-0 and order-1 byte codec from the CRAM codecs
specification (the reference reads CRAM via htslib, whose rANS_static.c is
the canonical implementation; see src/io/read/htslib_sam_facade.cpp for the
facade this replaces).  Four interleaved 32-bit range-coder states, 12-bit
normalised frequencies, byte-wise renormalisation at 2^23.

Encoding is numpy/python (the CRAM writer); decoding runs in the host
extension (csrc/octopus_native.cpp:rans_uncompress). Streams are small
(CRAM slice blocks), so this is host-side I/O work, not device work.
"""

from __future__ import annotations

import struct

import numpy as np

# native decode (csrc/octopus_native.cpp), built at first use
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
    cum = np.zeros(257, dtype=np.int64)
    np.cumsum(freqs, out=cum[1:])
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
    return _native.rans_uncompress(stream)


__all__ = ["compress", "uncompress"]
