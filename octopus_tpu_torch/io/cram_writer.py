"""CRAM 3.0 writer.

Spec-conformant single-slice-per-container writer used for evidence output
and to round-trip-test the reader (no htslib in this environment).  Mirrors
the BAM writer surface (io/bam_writer.py); reference-based: matches become
implicit reference copies, mismatches become X substitution features exactly
as htslib encodes them, so the reader's reconstruction path is the real one.
Also emits the `.crai` index (gzip text: ref id, start, span, container
offset, slice offset, slice size).
"""

from __future__ import annotations

import gzip
import hashlib
import struct

import numpy as np

from ..basics.reads import (FLAG_MATE_REVERSE, FLAG_MATE_UNMAPPED, ReadBatch)
from ..basics import cigar as cg
from ..basics.sequence import decode_sequence
from .cram import (Block, CompressionHeader, ContainerHeader, CRAM_MAGIC,
                   CT_COMPRESSION_HEADER, CT_CORE, CT_EXTERNAL, CT_FILE_HEADER,
                   CT_SLICE_HEADER, EOF_CONTAINER, Encoding, GZIP, RANS4x8, RAW,
                   SliceHeader, serialise_compression_header,
                   serialise_slice_header, write_block, write_container_header,
                   write_itf8, _BASES, _BASE_INDEX)

# external block content ids, one per data series
_IDS = {"BF": 1, "RL": 2, "AP": 3, "RG": 4, "RN": 5, "MF": 6, "NS": 7,
        "NP": 8, "TS": 9, "FN": 10, "FC": 11, "FP": 12, "BS": 13, "IN": 14,
        "SC": 15, "DL": 16, "BB": 17, "RS": 18, "PD": 19, "HC": 20, "BA": 21,
        "QS": 22}
_EMBED_REF_ID = 30
_RANS_SERIES = {"QS", "BA"}          # entropy-coded byte streams


def _make_encodings() -> dict[str, Encoding]:
    enc: dict[str, Encoding] = {}
    for key, cid in _IDS.items():
        if key == "RN":
            enc[key] = Encoding(5, content_id=cid, stop=0x09)   # tab-stopped
        elif key in ("IN", "SC", "BB"):
            enc[key] = Encoding(5, content_id=cid, stop=0x00)
        else:
            enc[key] = Encoding(1, content_id=cid)
    # constants via zero-bit huffman; MQ through the core bitstream (beta)
    enc["CF"] = Encoding(3, values=[0x3], lengths=[0])    # detached + quals
    enc["TL"] = Encoding(3, values=[0], lengths=[0])
    enc["MQ"] = Encoding(6, offset=0, nbits=8)
    return enc


class CramWriter:
    def __init__(self, path: str, ref_names: list[str], ref_lengths: list[int],
                 samples: list[str] | None = None, reference=None,
                 embed_reference: bool = False, records_per_slice: int = 10000):
        self.path = str(path)
        self.ref_names = list(ref_names)
        self.ref_lengths = list(ref_lengths)
        self.samples = list(samples or ["SAMPLE"])
        self.reference = reference
        self.embed_reference = embed_reference
        self.records_per_slice = records_per_slice
        self._fh = open(self.path, "wb")
        self._counter = 0
        self._crai: list[tuple[int, int, int, int, int, int]] = []
        self._write_file_header()

    # -- header ----------------------------------------------------------
    def _sam_text(self) -> str:
        lines = ["@HD\tVN:1.6\tSO:coordinate"]
        for name, length in zip(self.ref_names, self.ref_lengths):
            lines.append(f"@SQ\tSN:{name}\tLN:{length}")
        for i, s in enumerate(self.samples):
            lines.append(f"@RG\tID:rg{i}\tSM:{s}")
        return "\n".join(lines) + "\n"

    def _write_file_header(self) -> None:
        self._fh.write(CRAM_MAGIC + bytes([3, 0]))
        self._fh.write(hashlib.md5(self.path.encode()).digest()[:20].ljust(20, b"\x00"))
        text = self._sam_text().encode()
        block = write_block(Block(GZIP, CT_FILE_HEADER, 0,
                                  struct.pack("<i", len(text)) + text))
        h = ContainerHeader(len(block), -1, 0, 0, 0, 0, 0, 1, [0])
        self._fh.write(write_container_header(h))
        self._fh.write(block)

    # -- records -----------------------------------------------------------
    def _ref_slice(self, rid: int, begin: int, end: int) -> bytes:
        if self.reference is None:
            return b""
        contig = self.ref_names[rid]
        if hasattr(self.reference, "fetch_codes"):
            codes = self.reference.fetch_codes(contig, begin, end)
        else:
            codes = self.reference.fetch(contig, begin, end)
        return bytes(np.frombuffer(_BASES, np.uint8)[np.asarray(codes)])

    def write_batch(self, batch: ReadBatch, sample: str | None = None) -> None:
        if not len(batch):
            return
        rg = self.samples.index(sample) if sample in self.samples else 0
        rid = self.ref_names.index(batch.contig)
        for lo in range(0, len(batch), self.records_per_slice):
            idx = np.arange(lo, min(lo + self.records_per_slice, len(batch)))
            self._write_container(batch, idx, rid, rg)

    def _subst_code(self, matrix: bytes, ref_idx: int, base_idx: int) -> int:
        alts = [i for i in range(5) if i != ref_idx]
        j = alts.index(base_idx)
        return (matrix[ref_idx] >> (6 - 2 * j)) & 3

    def _write_container(self, batch: ReadBatch, idx: np.ndarray, rid: int,
                         rg: int) -> None:
        comp = CompressionHeader(
            read_names_included=True, ap_delta=False, reference_required=True,
            substitution_matrix=CompressionHeader.default_substitution_matrix(),
            tag_dict=[[]], data_series=_make_encodings())
        start = int(batch.begins[idx[0]])
        end = int(batch.ends[idx].max())
        ref_bases = self._ref_slice(rid, start, end)
        ext: dict[str, bytearray] = {k: bytearray() for k in _IDS}
        from .cram import BitWriter
        core = BitWriter()

        def put_int(key: str, v: int) -> None:
            ext[key] += write_itf8(v)

        n_bases = 0
        matrix = comp.substitution_matrix
        for k in idx:
            k = int(k)
            flags = int(batch.flags[k])
            bf = flags & ~(FLAG_MATE_REVERSE | FLAG_MATE_UNMAPPED)
            put_int("BF", bf)
            rl = batch.read_length(k)
            n_bases += rl
            put_int("RL", rl)
            put_int("AP", int(batch.begins[k]) + 1)
            put_int("RG", rg)
            name = (batch.names[k] if batch.names else f"read{k}").encode()
            ext["RN"] += name + b"\t"
            mf = (0x1 if flags & FLAG_MATE_REVERSE else 0) \
                | (0x2 if flags & FLAG_MATE_UNMAPPED else 0)
            put_int("MF", mf)
            mate_pos = int(batch.mate_begins[k]) if batch.mate_begins is not None else -1
            same = bool(batch.mate_same_contig[k]) if batch.mate_same_contig is not None else False
            put_int("NS", rid if (same and mate_pos >= 0) else -1)
            put_int("NP", mate_pos + 1 if mate_pos >= 0 else 0)
            put_int("TS", int(batch.template_lengths[k])
                    if batch.template_lengths is not None else 0)
            # features from cigar + mismatches vs reference
            feats: list[tuple[str, int, object]] = []
            seq = bytes(np.frombuffer(_BASES, np.uint8)[batch.sequence(k)])
            quals = bytes(batch.qualities(k))
            read_pos = 0
            ref_off = int(batch.begins[k]) - start
            for length, op in batch.cigar(k):
                length, op = int(length), int(op)
                if op in (cg.M, cg.EQ, cg.X):
                    seg = ref_bases[ref_off:ref_off + length]
                    for j in range(length):
                        rb = seg[j] if j < len(seg) else ord("N")
                        qb = seq[read_pos + j]
                        if qb != rb:
                            ri = _BASE_INDEX.get(rb, 4)
                            qi = _BASE_INDEX.get(qb, 4)
                            if qi != ri:
                                feats.append(("X", read_pos + j,
                                              self._subst_code(matrix, ri, qi)))
                    read_pos += length
                    ref_off += length
                elif op == cg.I:
                    feats.append(("I", read_pos, seq[read_pos:read_pos + length]))
                    read_pos += length
                elif op == cg.S:
                    feats.append(("S", read_pos, seq[read_pos:read_pos + length]))
                    read_pos += length
                elif op == cg.D:
                    feats.append(("D", read_pos, length))
                    ref_off += length
                elif op == cg.NSKIP:
                    feats.append(("N", read_pos, length))
                    ref_off += length
                elif op == cg.P:
                    feats.append(("P", read_pos, length))
                elif op == cg.H:
                    feats.append(("H", read_pos, length))
            put_int("FN", len(feats))
            prev_fp = 0
            for code, rpos, payload in feats:
                ext["FC"].append(ord(code))
                fp = rpos + 1
                put_int("FP", fp - prev_fp)
                prev_fp = fp
                if code == "X":
                    ext["BS"].append(payload)
                elif code == "I":
                    ext["IN"] += payload + b"\x00"
                elif code == "S":
                    ext["SC"] += payload + b"\x00"
                elif code in ("D", "N", "P", "H"):
                    key = {"D": "DL", "N": "RS", "P": "PD", "H": "HC"}[code]
                    put_int(key, payload)
            core.write(int(batch.mapq[k]), 8)      # MQ beta(0,8)
            ext["QS"] += quals
        # blocks
        blocks = [Block(RAW, CT_CORE, 0, core.getvalue())]
        content_ids = [0]
        for key, cid in _IDS.items():
            data = bytes(ext[key])
            if not data:
                continue
            method = RANS4x8 if key in _RANS_SERIES else GZIP
            blocks.append(Block(method, CT_EXTERNAL, cid, data))
            content_ids.append(cid)
        embedded_id = -1
        if self.embed_reference and ref_bases:
            blocks.append(Block(GZIP, CT_EXTERNAL, _EMBED_REF_ID, ref_bases))
            content_ids.append(_EMBED_REF_ID)
            embedded_id = _EMBED_REF_ID
            comp.reference_required = False
        md5 = hashlib.md5(ref_bases).digest() if ref_bases else b"\x00" * 16
        sh = SliceHeader(ref_id=rid, start=start + 1, span=end - start,
                         n_records=len(idx), counter=self._counter,
                         n_blocks=len(blocks), content_ids=content_ids,
                         embedded_ref_id=embedded_id, md5=md5)
        self._counter += len(idx)
        comp_block = write_block(Block(GZIP, CT_COMPRESSION_HEADER, 0,
                                       serialise_compression_header(comp)))
        slice_header_block = write_block(Block(RAW, CT_SLICE_HEADER, 0,
                                               serialise_slice_header(sh)))
        slice_body = b"".join(write_block(b) for b in blocks)
        landmark = len(comp_block)
        data = comp_block + slice_header_block + slice_body
        h = ContainerHeader(len(data), rid, start + 1, end - start, len(idx),
                            self._counter, n_bases, 1 + 1 + len(blocks),
                            [landmark])
        container_offset = self._fh.tell()
        self._fh.write(write_container_header(h))
        self._fh.write(data)
        self._crai.append((rid, start + 1, end - start, container_offset,
                           landmark, len(slice_header_block) + len(slice_body)))

    def close(self) -> None:
        self._fh.write(EOF_CONTAINER)
        self._fh.close()
        with gzip.open(self.path + ".crai", "wt") as fh:
            for row in self._crai:
                fh.write("\t".join(str(x) for x in row) + "\n")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


__all__ = ["CramWriter"]
