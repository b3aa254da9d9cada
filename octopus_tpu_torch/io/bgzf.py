"""BGZF (blocked gzip) reading/writing — the container format of BAM and
bgzipped VCF.

Capability-equivalent to htslib's bgzf layer as used by the reference's
HtslibSamFacade/HtslibBcfFacade.  Supports virtual file offsets
((coffset << 16) | uoffset) for index-driven random access, and writing with
per-block deflate + the BGZF EOF marker.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_HDR = struct.Struct("<4BI2BH")   # magic(4) mtime xfl os xlen

# native inflate (csrc/octopus_native.cpp), built at first use
from .._build import NATIVE as _native


class BgzfReader:
    """Random-access BGZF reader with a small decompressed-block cache."""

    def __init__(self, path: str, cache_blocks: int = 64):
        import threading
        self.path = path
        self._fh = open(path, "rb")
        self._cache: dict[int, bytes] = {}
        self._cache_order: list[int] = []
        self._cache_blocks = cache_blocks
        self._file_size = self._get_size()
        self._io_lock = threading.Lock()

    def _get_size(self) -> int:
        self._fh.seek(0, 2)
        return self._fh.tell()

    def close(self) -> None:
        self._fh.close()

    def _read_block(self, coffset: int) -> tuple[bytes, int]:
        """Decompressed data + compressed block length at coffset."""
        hit = self._cache.get(coffset)
        if hit is not None:
            return hit
        with self._io_lock:
            return self._read_block_locked(coffset)

    def _read_block_locked(self, coffset: int) -> tuple[bytes, int]:
        self._fh.seek(coffset)
        header = self._fh.read(18)
        if len(header) < 18:
            return b"", 0
        if header[0] != 0x1F or header[1] != 0x8B:
            raise ValueError(f"{self.path}: not BGZF at offset {coffset}")
        xlen = struct.unpack_from("<H", header, 10)[0]
        extra = header[12:12 + xlen]
        if len(extra) < xlen:
            extra += self._fh.read(xlen - len(extra))
        bsize = None
        i = 0
        while i + 4 <= len(extra):
            si1, si2, slen = extra[i], extra[i + 1], struct.unpack_from("<H", extra, i + 2)[0]
            if si1 == 66 and si2 == 67:
                bsize = struct.unpack_from("<H", extra, i + 4)[0] + 1
                break
            i += 4 + slen
        if bsize is None:
            raise ValueError(f"{self.path}: missing BGZF BSIZE at {coffset}")
        self._fh.seek(coffset + 12 + xlen)
        cdata = self._fh.read(bsize - 12 - xlen - 8)
        data = zlib.decompress(cdata, wbits=-15)
        entry = (data, bsize)
        self._cache[coffset] = entry
        self._cache_order.append(coffset)
        if len(self._cache_order) > self._cache_blocks:
            old = self._cache_order.pop(0)
            self._cache.pop(old, None)
        return entry

    def read_range(self, vstart: int, vend: int) -> bytes:
        """Bytes between two virtual offsets: one disk read of the
        compressed span, one inflate pass in the host extension (GIL
        released)."""
        coff = vstart >> 16
        uoff = vstart & 0xFFFF
        end_coff = vend >> 16
        end_uoff = vend & 0xFFFF
        # include the final block (max BGZF block = 64 KiB)
        with self._io_lock:
            self._fh.seek(coff)
            raw = self._fh.read((end_coff - coff) + (1 << 16) + 64)
        data, coffs_b, uoffs_b = _native.inflate_bgzf(raw)
        if end_coff == coff:
            return data[uoff:end_uoff]
        coffs = np.frombuffer(coffs_b, "<u8")
        uoffs = np.frombuffer(uoffs_b, "<u8")
        # locate the block at end_coff (relative offset end_coff - coff)
        rel = end_coff - coff
        idx = np.searchsorted(coffs, rel)
        if idx < len(coffs) and coffs[idx] == rel:
            end_abs = int(uoffs[idx]) + end_uoff
        else:
            end_abs = len(data)
        return data[uoff:end_abs]

    def read_from(self, vstart: int, n_bytes: int) -> bytes:
        """At least n_bytes starting at a virtual offset (until EOF)."""
        coff = vstart >> 16
        uoff = vstart & 0xFFFF
        parts: list[bytes] = []
        got = 0
        while got < n_bytes and coff < self._file_size:
            data, bsize = self._read_block(coff)
            if bsize == 0 or not data:
                break
            chunk = data[uoff:]
            parts.append(chunk)
            got += len(chunk)
            coff += bsize
            uoff = 0
        return b"".join(parts)

    def read_all(self) -> bytes:
        parts = []
        coff = 0
        while coff < self._file_size:
            data, bsize = self._read_block(coff)
            if bsize == 0:
                break
            parts.append(data)
            coff += bsize
        return b"".join(parts)


class BgzfWriter:
    def __init__(self, path: str, level: int = 6, block_size: int = 0xFF00):
        self._fh = open(path, "wb")
        self._buf = bytearray()
        self._level = level
        self._block_size = block_size

    def write(self, data: bytes) -> None:
        self._buf.extend(data)
        while len(self._buf) >= self._block_size:
            self._flush_block(self._buf[:self._block_size])
            del self._buf[:self._block_size]

    def _flush_block(self, data: bytes) -> None:
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = co.compress(bytes(data)) + co.flush()
        bsize = len(cdata) + 26
        header = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"
                  + struct.pack("<H", bsize - 1))
        footer = struct.pack("<II", zlib.crc32(bytes(data)) & 0xFFFFFFFF, len(data))
        self._fh.write(header + cdata + footer)

    def close(self) -> None:
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()
        self._fh.write(BGZF_EOF)
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


__all__ = ["BgzfReader", "BgzfWriter", "BGZF_EOF"]
