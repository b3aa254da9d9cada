"""BAM writing (+ BAI index generation).

Counterpart of the reference's ReadWriter (src/io/read/read_writer.hpp) used
for evidence BAM output (--bamout), and the test-side generator of BAM
fixtures.  Produces spec-conformant BAM over BGZF and a matching BAI using
the UCSC binning scheme.
"""

from __future__ import annotations

import struct

import numpy as np

from ..basics import cigar as cg
from ..basics.reads import ReadBatch
from .bgzf import BgzfWriter

_CODE_TO_SEQ4 = np.array([1, 2, 4, 8, 15, 15], dtype=np.uint8)  # A C G T N PAD


def _reg2bin(begin: int, end: int) -> int:
    end -= 1
    if begin >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (begin >> 14)
    if begin >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (begin >> 17)
    if begin >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (begin >> 20)
    if begin >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (begin >> 23)
    if begin >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (begin >> 26)
    return 0


class BamWriter:
    def __init__(self, path: str, ref_names: list[str], ref_lengths: list[int],
                 samples: list[str] | None = None, extra_header: str = ""):
        self.path = str(path)
        self.ref_names = list(ref_names)
        self.ref_lengths = list(ref_lengths)
        self._w = BgzfWriter(self.path)
        header_text = "@HD\tVN:1.6\tSO:coordinate\n"
        for name, length in zip(ref_names, ref_lengths):
            header_text += f"@SQ\tSN:{name}\tLN:{length}\n"
        for s in samples or []:
            header_text += f"@RG\tID:{s}\tSM:{s}\n"
        header_text += extra_header
        payload = header_text.encode()
        blob = b"BAM\x01" + struct.pack("<i", len(payload)) + payload
        blob += struct.pack("<i", len(ref_names))
        for name, length in zip(ref_names, ref_lengths):
            nb = name.encode() + b"\x00"
            blob += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
        self._w.write(blob)
        self._count = 0

    def write_batch(self, batch: ReadBatch, sample: str | None = None,
                    tags: list[bytes] | None = None) -> None:
        """tags: optional per-read pre-encoded aux bytes (see encode_tag),
        appended after the RG tag — used by the evidence-BAM realigner for
        HP/PS/LK annotations (the reference's bam_realigner.cpp:167-196)."""
        ref_id = self.ref_names.index(batch.contig)
        for i in range(len(batch)):
            name = (batch.names[i] if batch.names is not None
                    else f"read{self._count}")
            self._count += 1
            self._write_record(ref_id, batch, i, name, sample,
                               tags[i] if tags is not None else b"")

    def _write_record(self, ref_id: int, batch: ReadBatch, i: int, name: str,
                      sample: str | None, extra_tags: bytes = b"") -> None:
        seq = batch.sequence(i)
        quals = batch.qualities(i)
        cigar = batch.cigar(i)
        pos = int(batch.begins[i])
        end = int(batch.ends[i])
        name_b = name.encode() + b"\x00"
        n_cigar = len(cigar)
        l_seq = len(seq)
        mate_ref = ref_id if (batch.mate_same_contig is None or batch.mate_same_contig[i]) else -1
        mate_pos = int(batch.mate_begins[i]) if batch.mate_begins is not None else -1
        tlen = int(batch.template_lengths[i]) if batch.template_lengths is not None else 0
        rec = struct.pack(
            "<iiBBHHHiiii",
            ref_id, pos, len(name_b), int(batch.mapq[i]),
            _reg2bin(pos, max(end, pos + 1)), n_cigar, int(batch.flags[i]),
            l_seq, mate_ref, mate_pos, tlen,
        )
        rec += name_b
        words = (cigar[:, 0].astype(np.uint32) << 4) | cigar[:, 1].astype(np.uint32)
        rec += words.astype("<u4").tobytes()
        nib = _CODE_TO_SEQ4[seq]
        if l_seq % 2:
            nib = np.concatenate([nib, [0]])
        packed = (nib[0::2] << 4) | nib[1::2]
        rec += packed.astype(np.uint8).tobytes()
        rec += quals.astype(np.uint8).tobytes()
        if sample is not None:
            rec += b"RGZ" + sample.encode() + b"\x00"
        rec += extra_tags
        self._w.write(struct.pack("<i", len(rec)) + rec)

    def close(self) -> None:
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def build_bai(bam_path: str, bai_path: str | None = None) -> str:
    """Build a BAI index by scanning the BAM sequentially."""
    from .bgzf import BgzfReader

    bai_path = bai_path or bam_path + ".bai"
    r = BgzfReader(bam_path)
    # walk blocks tracking virtual offsets
    # decompress whole file while recording block boundaries
    blocks: list[tuple[int, int, int]] = []   # (coffset, uncompressed_start, len)
    coff = 0
    total = 0
    datas = []
    while True:
        data, bsize = r._read_block(coff)
        if bsize == 0:
            break
        blocks.append((coff, total, len(data)))
        datas.append(data)
        total += len(data)
        coff += bsize
    buf = b"".join(datas)

    def voffset(uoff: int) -> int:
        # binary search block containing uncompressed offset
        lo, hi = 0, len(blocks) - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if blocks[mid][1] <= uoff:
                lo = mid
            else:
                hi = mid - 1
        cb, ub, _ = blocks[lo]
        return (cb << 16) | (uoff - ub)

    if buf[:4] != b"BAM\x01":
        raise ValueError("not BAM")
    (l_text,) = struct.unpack_from("<i", buf, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", buf, off)
    off += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", buf, off)
        off += 4 + l_name + 4
    bins: list[dict[int, list[list[int]]]] = [dict() for _ in range(n_ref)]
    linear: list[dict[int, int]] = [dict() for _ in range(n_ref)]
    n_mapped = [0] * n_ref
    n_unmapped = [0] * n_ref
    ref_span: list[list[int]] = [[0, 0] for _ in range(n_ref)]  # voffset range
    while off + 4 <= len(buf):
        (block_size,) = struct.unpack_from("<i", buf, off)
        if block_size <= 0 or off + 4 + block_size > len(buf):
            break
        rec_start_v = voffset(off)
        rec_end_v = voffset(off + 4 + block_size)
        ref_id, pos = struct.unpack_from("<ii", buf, off + 4)
        if ref_id >= 0:
            flag = struct.unpack_from("<H", buf, off + 18)[0]
            if flag & 0x4:
                n_unmapped[ref_id] += 1
            else:
                n_mapped[ref_id] += 1
            if ref_span[ref_id][0] == 0:
                ref_span[ref_id][0] = rec_start_v
            ref_span[ref_id][1] = rec_end_v
            l_read_name = buf[off + 12]
            n_cigar = struct.unpack_from("<H", buf, off + 16)[0]
            cig_off = off + 4 + 32 + l_read_name
            span = 0
            for k in range(n_cigar):
                (w,) = struct.unpack_from("<I", buf, cig_off + 4 * k)
                op = w & 0xF
                if cg.CONSUMES_REF[op]:
                    span += w >> 4
            end = pos + max(span, 1)
            b = _reg2bin(pos, end)
            bins[ref_id].setdefault(b, [])
            if bins[ref_id][b] and bins[ref_id][b][-1][1] == rec_start_v:
                bins[ref_id][b][-1][1] = rec_end_v
            else:
                bins[ref_id][b].append([rec_start_v, rec_end_v])
            for win in range(pos >> 14, (end - 1 >> 14) + 1):
                if win not in linear[ref_id] or rec_start_v < linear[ref_id][win]:
                    linear[ref_id][win] = rec_start_v
        off += 4 + block_size
    out = bytearray(b"BAI\x01")
    out += struct.pack("<i", n_ref)
    for rid in range(n_ref):
        # samtools-style pseudo-bin 37450 carries (mapped, unmapped) counts;
        # readers use it for read-budget estimation (propose_windows)
        out += struct.pack("<i", len(bins[rid]) + 1)
        for b, chunks in sorted(bins[rid].items()):
            out += struct.pack("<Ii", b, len(chunks))
            for beg, cend in chunks:
                out += struct.pack("<QQ", beg, cend)
        out += struct.pack("<Ii", 37450, 2)
        out += struct.pack("<QQ", ref_span[rid][0], ref_span[rid][1])
        out += struct.pack("<QQ", n_mapped[rid], n_unmapped[rid])
        if linear[rid]:
            n_intv = max(linear[rid]) + 1
            intv = [0] * n_intv
            prev = 0
            for wI in range(n_intv):
                if wI in linear[rid]:
                    prev = linear[rid][wI]
                elif prev == 0 and wI > 0:
                    prev = intv[wI - 1]
                intv[wI] = linear[rid].get(wI, prev)
            out += struct.pack("<i", n_intv)
            out += np.asarray(intv, "<u8").tobytes()
        else:
            out += struct.pack("<i", 0)
    with open(bai_path, "wb") as fh:
        fh.write(bytes(out))
    return bai_path


def encode_tag(name: str, value) -> bytes:
    """Encode one BAM aux tag: str -> Z, int -> i (int32)."""
    tag = name.encode()
    if len(tag) != 2:
        raise ValueError(f"aux tag name must be 2 chars: {name!r}")
    if isinstance(value, str):
        return tag + b"Z" + value.encode() + b"\x00"
    if isinstance(value, (int, np.integer)):
        return tag + b"i" + struct.pack("<i", int(value))
    raise TypeError(f"unsupported aux tag value type: {type(value)}")


__all__ = ["BamWriter", "build_bai", "encode_tag"]
