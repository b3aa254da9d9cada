"""Tabix (.tbi) indexing of bgzipped VCFs.

Capability-equivalent to the reference's vcf_utils::index_vcf
(src/io/variant/vcf_utils.hpp:33-47, which calls htslib's tbx_index_build):
walks the BGZF blocks of a .vcf.gz recording each record's virtual offset,
bins records with the UCSC binning scheme, and writes the standard
BGZF-wrapped TBI payload that htslib/tabix/IGV can consume.
"""

from __future__ import annotations

import struct
import zlib

from .bgzf import BgzfWriter


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _walk_lines(path: str):
    """Yield (virtual_offset, line_bytes) for each line of a BGZF text file."""
    with open(path, "rb") as fh:
        raw_all = fh.read()
    pos = 0
    pending = b""
    pending_voff = 0
    while pos + 18 <= len(raw_all):
        if raw_all[pos:pos + 2] != b"\x1f\x8b":
            raise ValueError(f"{path}: not BGZF at {pos}")
        bsize = struct.unpack_from("<H", raw_all, pos + 16)[0] + 1
        cdata = raw_all[pos + 18:pos + bsize - 8]
        data = zlib.decompress(cdata, -15)
        start = 0
        while True:
            nl = data.find(b"\n", start)
            if nl < 0:
                break
            if pending:
                yield pending_voff, pending + data[start:nl]
                pending = b""
            else:
                yield (pos << 16) | start, data[start:nl]
            start = nl + 1
        if start < len(data):
            if not pending:
                pending_voff = (pos << 16) | start
            pending += data[start:]
        pos += bsize
    if pending:
        yield pending_voff, pending


def index_vcf(path: str, tbi_path: str | None = None) -> str:
    """Build a .tbi index for a coordinate-sorted bgzipped VCF."""
    tbi_path = tbi_path or path + ".tbi"
    names: list[bytes] = []
    rid_of: dict[bytes, int] = {}
    bins: list[dict[int, list[list[int]]]] = []
    linear: list[dict[int, int]] = []
    records: list[tuple[int, int, int, int]] = []   # (voff, rid, beg, end)
    import os
    eof_voff = os.path.getsize(path) << 16
    for voff, line in _walk_lines(path):
        if line.startswith(b"#"):
            continue
        fields = line.split(b"\t", 8)
        chrom = fields[0]
        rid = rid_of.get(chrom)
        if rid is None:
            rid = len(names)
            rid_of[chrom] = rid
            names.append(chrom)
            bins.append({})
            linear.append({})
        beg = int(fields[1]) - 1
        end = beg + max(len(fields[3]), 1)
        records.append((voff, rid, beg, end))
    for i, (voff, rid, beg, end) in enumerate(records):
        # chunk end = next record's virtual offset (htslib convention)
        next_voff = records[i + 1][0] if i + 1 < len(records) else eof_voff
        b = _reg2bin(beg, end)
        chunk_list = bins[rid].setdefault(b, [])
        if chunk_list and chunk_list[-1][1] >= voff:
            chunk_list[-1][1] = max(chunk_list[-1][1], next_voff)
        else:
            chunk_list.append([voff, next_voff])
        for win in range(beg >> 14, ((end - 1) >> 14) + 1):
            if win not in linear[rid] or voff < linear[rid][win]:
                linear[rid][win] = voff
    payload = bytearray()
    payload += b"TBI\x01"
    payload += struct.pack("<i", len(names))
    concat = b"\x00".join(names) + b"\x00" if names else b""
    payload += struct.pack("<6i", 2, 1, 2, 0, ord("#"), 0)
    payload += struct.pack("<i", len(concat))
    payload += concat
    for rid in range(len(names)):
        payload += struct.pack("<i", len(bins[rid]))
        for b, chunks in sorted(bins[rid].items()):
            payload += struct.pack("<Ii", b, len(chunks))
            for cb, ce in chunks:
                payload += struct.pack("<QQ", cb, ce)
        if linear[rid]:
            n_intv = max(linear[rid]) + 1
            intv = []
            prev = 0
            for w in range(n_intv):
                if w in linear[rid]:
                    prev = linear[rid][w]
                intv.append(prev)
            payload += struct.pack("<i", n_intv)
            payload += b"".join(struct.pack("<Q", v) for v in intv)
        else:
            payload += struct.pack("<i", 0)
    w = BgzfWriter(tbi_path)
    w.write(bytes(payload))
    w.close()
    return tbi_path


__all__ = ["index_vcf"]
