"""A minimal writer of the benchmark's inputs: FASTA with its .fai, and a
coordinate-sorted BAM over BGZF with its BAI (SAM specification, sections 4
and 5), built in bulk with numpy. Reads are those of `simulate.SampleReads`:
one sample a file, one read group, single-end, no tags but RG.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .simulate import ACGT, OP_M, SampleReads

BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
BLOCK = 0xFF00              # uncompressed bytes a BGZF block
LEVEL = 1                   # deflate level: speed over size
NAME_LEN = 9                # "%08x" + NUL
SEQ4 = np.array([1, 2, 4, 8], np.uint8)     # A C G T as BAM's 4-bit codes


def write_fasta(path: str, contig: str, reference: np.ndarray,
                width: int = 70) -> None:
    """FASTA of one contig and its .fai."""
    n = len(reference)
    text = ACGT[reference]
    rows = (n + width - 1) // width
    padded = np.full(rows * (width + 1), ord("\n"), np.uint8)
    grid = padded.reshape(rows, width + 1)
    full = n // width
    grid[:full, :width] = text[:full * width].reshape(full, width)
    body = grid.reshape(-1)
    if n % width:
        grid[full, :n % width] = text[full * width:]
        body = np.concatenate((body[:full * (width + 1)],
                               grid[full, :n % width + 1]))
    header = f">{contig}\n".encode()
    with open(path, "wb") as fh:
        fh.write(header)
        fh.write(body.tobytes())
    with open(path + ".fai", "w") as fh:
        fh.write(f"{contig}\t{n}\t{len(header)}\t{width}\t{width + 1}\n")


def reg2bin(begin: np.ndarray, end: np.ndarray) -> np.ndarray:
    """SAM's reg2bin, vectorised; end exclusive."""
    end = end - 1
    out = np.zeros(len(begin), np.int64)
    done = np.zeros(len(begin), bool)
    for shift, offset in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        same = ~done & ((begin >> shift) == (end >> shift))
        out[same] = offset + (begin[same] >> shift)
        done |= same
    return out


def _records(reads: SampleReads, contig_id: int, qual: int, mapq: int):
    """(record bytes, offset of each record in them) for every read."""
    n, rl = reads.seq.shape
    tag = b"RGZ" + reads.name.encode() + b"\x00"
    n_cigar = np.ones(n, np.int64)
    for i, ops in reads.cigars.items():
        n_cigar[i] = len(ops)
    seq_bytes = (rl + 1) // 2
    sizes = 4 + 32 + NAME_LEN + 4 * n_cigar + seq_bytes + rl + len(tag)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    # the fixed part of every record, in one structured array
    fixed = np.zeros(n, dtype=np.dtype([
        ("block_size", "<i4"), ("ref_id", "<i4"), ("pos", "<i4"),
        ("l_read_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
        ("n_cigar", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
        ("next_ref", "<i4"), ("next_pos", "<i4"), ("tlen", "<i4")]))
    fixed["block_size"] = sizes - 4
    fixed["ref_id"] = contig_id
    fixed["pos"] = reads.begins
    fixed["l_read_name"] = NAME_LEN
    fixed["mapq"] = mapq
    fixed["bin"] = reg2bin(reads.begins, np.maximum(reads.ends, reads.begins + 1))
    fixed["n_cigar"] = n_cigar
    fixed["flag"] = reads.flags
    fixed["l_seq"] = rl
    fixed["next_ref"] = -1
    fixed["next_pos"] = -1
    raw_fixed = fixed.view(np.uint8).reshape(n, 36)
    names = np.frombuffer("".join(f"{i:08x}\0" for i in range(n)).encode(),
                          np.uint8).reshape(n, NAME_LEN)
    nib = SEQ4[reads.seq]
    if rl % 2:
        nib = np.concatenate((nib, np.zeros((n, 1), np.uint8)), axis=1)
    packed = (nib[:, 0::2] << 4) | nib[:, 1::2]
    tail = np.frombuffer(bytes([qual]) * rl + tag, np.uint8)
    word = np.frombuffer(struct.pack("<I", (rl << 4) | OP_M), np.uint8)
    # every record as if all M; the others are rebuilt one by one
    block = np.concatenate(
        (raw_fixed, names, np.broadcast_to(word, (n, 4)), packed,
         np.broadcast_to(tail, (n, len(tail)))), axis=1)
    pieces, prev = [], 0
    for i in sorted(reads.cigars):
        pieces.append(block[prev:i].tobytes())
        words = b"".join(struct.pack("<I", (length << 4) | op)
                         for length, op in reads.cigars[i])
        pieces.append(raw_fixed[i].tobytes() + names[i].tobytes() + words
                      + packed[i].tobytes() + tail.tobytes())
        prev = i + 1
    pieces.append(block[prev:].tobytes())
    del block
    buf = np.frombuffer(b"".join(pieces), np.uint8)
    return buf, offsets


def write_bam(path: str, contig: str, length: int, reads: SampleReads,
              qual: int, mapq: int) -> None:
    """BAM of one sample's reads and its BAI at path + ".bai"."""
    text = (f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:{contig}\tLN:{length}\n"
            f"@RG\tID:{reads.name}\tSM:{reads.name}\n").encode()
    name = contig.encode() + b"\x00"
    head = (b"BAM\x01" + struct.pack("<i", len(text)) + text
            + struct.pack("<i", 1) + struct.pack("<i", len(name)) + name
            + struct.pack("<i", length))
    recs, rec_offsets = _records(reads, 0, qual, mapq)
    data = np.concatenate((np.frombuffer(head, np.uint8), recs))
    rec_offsets = rec_offsets + len(head)
    # BGZF blocks, and the compressed offset of each block
    starts = np.arange(0, len(data), BLOCK)
    coffsets = np.zeros(len(starts) + 1, np.int64)
    mv = memoryview(data)
    with open(path, "wb") as fh:
        for k, s in enumerate(starts):
            chunk = mv[s:s + BLOCK]
            co = zlib.compressobj(LEVEL, zlib.DEFLATED, -15)
            cdata = co.compress(chunk) + co.flush()
            bsize = len(cdata) + 26
            fh.write(b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"
                     + struct.pack("<H", bsize - 1) + cdata
                     + struct.pack("<II", zlib.crc32(chunk) & 0xFFFFFFFF,
                                   len(chunk)))
            coffsets[k + 1] = coffsets[k] + bsize
        fh.write(BGZF_EOF)

    def voffset(u: np.ndarray) -> np.ndarray:
        block = u // BLOCK
        return (coffsets[block] << 16) | (u - block * BLOCK)

    write_bai(path + ".bai", reads, voffset(rec_offsets[:-1]),
              voffset(rec_offsets[1:]))


def write_bai(path: str, reads: SampleReads, vbeg: np.ndarray,
              vend: np.ndarray) -> None:
    """BAI of one reference: bins with merged chunks, the linear index and
    samtools' pseudo-bin (the span and the mapped count)."""
    n = len(reads.begins)
    out = bytearray(b"BAI\x01" + struct.pack("<i", 1))
    if n == 0:
        out += struct.pack("<ii", 0, 0)
    else:
        bins = reg2bin(reads.begins, np.maximum(reads.ends, reads.begins + 1))
        order = np.argsort(bins, kind="stable")
        b_sorted = bins[order]
        # a new chunk wherever the bin changes or its records are not
        # adjacent in the file
        new = np.ones(n, bool)
        new[1:] = (b_sorted[1:] != b_sorted[:-1]) | (order[1:] != order[:-1] + 1)
        starts = np.flatnonzero(new)
        ends = np.append(starts[1:], n) - 1
        chunk_bin = b_sorted[starts]
        chunk_beg = vbeg[order[starts]]
        chunk_end = vend[order[ends]]
        uniq, first = np.unique(chunk_bin, return_index=True)
        counts = np.diff(np.append(first, len(chunk_bin)))
        out += struct.pack("<i", len(uniq) + 1)
        for b, f, c in zip(uniq, first, counts):
            out += struct.pack("<Ii", int(b), int(c))
            out += np.stack((chunk_beg[f:f + c], chunk_end[f:f + c]),
                            axis=1).astype("<u8").tobytes()
        out += struct.pack("<Ii", 37450, 2)
        out += struct.pack("<QQQQ", int(vbeg[0]), int(vend[-1]), n, 0)
        # linear index: each 16 kb window's first record that may overlap it
        last_window = (reads.ends - 1) >> 14
        reach = np.maximum.accumulate(last_window)
        n_intv = int(reach[-1]) + 1
        first_rec = np.searchsorted(reach, np.arange(n_intv), side="left")
        out += struct.pack("<i", n_intv)
        out += vbeg[first_rec].astype("<u8").tobytes()
    out += struct.pack("<Q", 0)
    with open(path, "wb") as fh:
        fh.write(bytes(out))


__all__ = ["write_fasta", "write_bam", "write_bai", "reg2bin", "BGZF_EOF"]
