"""BAM reading: header, BAI index, vectorised record decoding to ReadBatch.

Capability-equivalent to the reference's HtslibSamFacade
(src/io/read/htslib_sam_facade.{hpp,cpp}) without htslib: BGZF blocks are
inflated and records decoded in one pass each by the host extension
(csrc/octopus_native.cpp: inflate_bgzf, decode_bam_records), and the BAI
index drives region queries.

Sample extraction follows the reference: one sample per @RG SM tag
(reads with no RG fall back to a file-level default sample).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field

import numpy as np

from ..basics.reads import ReadBatch
from .bgzf import BgzfReader

# native one-pass record decode (csrc/octopus_native.cpp), built at first use
from .._build import NATIVE as _native

# 4-bit encoded bases: =ACMGRSVTWYHKDBN -> our codes (A0 C1 G2 T3 N4)
_SEQ4_TO_CODE = np.full(16, 4, dtype=np.uint8)
_SEQ4_TO_CODE[1] = 0   # A
_SEQ4_TO_CODE[2] = 1   # C
_SEQ4_TO_CODE[4] = 2   # G
_SEQ4_TO_CODE[8] = 3   # T

_BAM_CIGAR_OPS = "MIDNSHP=X"


@dataclass
class BamHeader:
    text: str
    ref_names: list[str]
    ref_lengths: list[int]
    samples: list[str]
    read_group_sample: dict[str, str]

    @property
    def n_refs(self) -> int:
        return len(self.ref_names)


def _parse_header_samples(text: str, default_sample: str) -> tuple[list[str], dict[str, str]]:
    rg_sample: dict[str, str] = {}
    for line in text.splitlines():
        if line.startswith("@RG"):
            rg_id = sm = None
            for fld in line.split("\t")[1:]:
                if fld.startswith("ID:"):
                    rg_id = fld[3:]
                elif fld.startswith("SM:"):
                    sm = fld[3:]
            if rg_id is not None:
                rg_sample[rg_id] = sm if sm is not None else default_sample
    samples = sorted(set(rg_sample.values())) if rg_sample else [default_sample]
    return samples, rg_sample


# ---------------------------------------------------------------------------
# BAI index
# ---------------------------------------------------------------------------

class BaiIndex:
    def __init__(self, path: str):
        with open(path, "rb") as fh:
            data = fh.read()
        if data[:4] != b"BAI\x01":
            raise ValueError(f"{path}: not a BAI index")
        off = 4
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        self.bins: list[dict[int, list[tuple[int, int]]]] = []
        self.linear: list[np.ndarray] = []
        self.mapped: list[int | None] = []    # per-ref mapped count (bin 37450)
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            bins: dict[int, list[tuple[int, int]]] = {}
            mapped = None
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    beg, end = struct.unpack_from("<QQ", data, off)
                    off += 16
                    chunks.append((beg, end))
                if bin_id == 37450:           # samtools metadata pseudo-bin
                    if len(chunks) == 2:
                        mapped = int(chunks[1][0])
                else:
                    bins[bin_id] = chunks
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4
            ioff = np.frombuffer(data, dtype="<u8", count=n_intv, offset=off).copy()
            off += 8 * n_intv
            self.bins.append(bins)
            self.linear.append(ioff)
            self.mapped.append(mapped)

    @staticmethod
    def region_bins(begin: int, end: int) -> list[int]:
        """UCSC binning scheme bins overlapping [begin, end)."""
        end = max(end - 1, begin)
        out = [0]
        for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
            out.extend(range(base + (begin >> shift), base + (end >> shift) + 1))
        return out

    def chunks_for(self, ref_id: int, begin: int, end: int) -> list[tuple[int, int]]:
        if ref_id >= len(self.bins):
            return []
        bins = self.bins[ref_id]
        linear = self.linear[ref_id]
        min_off = 0
        win = begin >> 14
        if len(linear):
            min_off = int(linear[min(win, len(linear) - 1)])
        chunks = []
        for b in self.region_bins(begin, end):
            for beg, cend in bins.get(b, ()):
                if cend > min_off:
                    chunks.append((max(beg, min_off), cend))
        chunks.sort()
        merged: list[tuple[int, int]] = []
        for beg, cend in chunks:
            if merged and beg <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], cend))
            else:
                merged.append((beg, cend))
        return merged


# ---------------------------------------------------------------------------
# BAM file
# ---------------------------------------------------------------------------

class BamFile:
    def __init__(self, path: str):
        from ..errors import MalformedFileError, MissingFileError
        self.path = str(path)
        if not os.path.exists(self.path):
            raise MissingFileError(self.path, "read", where="BamFile")
        try:
            self._bgzf = BgzfReader(self.path)
            self._parse_header()
        except (ValueError, struct.error, EOFError) as e:
            raise MalformedFileError(self.path, "BAM", detail=str(e),
                                     where="BamFile") from None
        bai = self.path + ".bai"
        if not os.path.exists(bai):
            alt = os.path.splitext(self.path)[0] + ".bai"
            bai = alt if os.path.exists(alt) else None
        self.index = BaiIndex(bai) if bai else None

    def _parse_header(self) -> None:
        # header is at the start; read generously and extend if needed
        raw = self._bgzf.read_from(0, 1 << 16)
        if raw[:4] != b"BAM\x01":
            raise ValueError(f"{self.path}: not a BAM file")
        (l_text,) = struct.unpack_from("<i", raw, 4)
        need = 12 + l_text
        if len(raw) < need + 8:
            raw = self._bgzf.read_from(0, need + (1 << 20))
        text = raw[8:8 + l_text].split(b"\x00")[0].decode("latin-1")
        off = 8 + l_text
        (n_ref,) = struct.unpack_from("<i", raw, off)
        off += 4
        names, lengths = [], []
        for _ in range(n_ref):
            if off + 4 > len(raw):
                raw += self._bgzf.read_from(0, len(raw) + (1 << 20))[len(raw):]
            (l_name,) = struct.unpack_from("<i", raw, off)
            off += 4
            names.append(raw[off:off + l_name - 1].decode("latin-1"))
            off += l_name
            (l_ref,) = struct.unpack_from("<i", raw, off)
            off += 4
            lengths.append(l_ref)
        default_sample = os.path.basename(self.path)
        samples, rg_sample = _parse_header_samples(text, default_sample)
        self.header = BamHeader(text, names, lengths, samples, rg_sample)
        self._default_sample = rg_sample and sorted(set(rg_sample.values()))[0] or default_sample
        self._records_start_uncompressed = off  # only valid pre-index reads

    def samples(self) -> list[str]:
        return self.header.samples

    def fetch(self, contig: str, begin: int, end: int,
              keep_names: bool = False, keep_aux: bool = False) -> dict[str, ReadBatch]:
        """Reads overlapping the region, decoded per sample."""
        if self.index is None:
            from ..errors import MissingIndexError
            raise MissingIndexError(self.path, "BAM", where="BamFile.fetch",
                                    index_hint=self.path + ".bai")
        try:
            ref_id = self.header.ref_names.index(contig)
        except ValueError:
            return {}
        chunks = self.index.chunks_for(ref_id, begin, end)
        if not chunks:
            return {}
        buf = b"".join(self._bgzf.read_range(beg, cend) for beg, cend in chunks)
        return self._decode_records(buf, ref_id, begin, end, keep_names, keep_aux)

    # -- record decode ------------------------------------------------------

    def _decode_records(self, buf: bytes, ref_id: int, begin: int, end: int,
                        keep_names: bool,
                        keep_aux: bool = False) -> dict[str, ReadBatch]:
        """One native pass decodes, filters and unpacks every record
        (csrc/octopus_native.cpp:decode_bam_records)."""
        (pos_b, ends_b, mapq_b, flags_b, nref_b, npos_b, tlen_b, hash_b,
         nameblob, nameoff_b, seq_b, qual_b, soff_b, cig_b, coff_b,
         auxs_b, auxe_b) = _native.decode_bam_records(
            buf, ref_id, int(begin), int(end), _SEQ4_TO_CODE.tobytes())
        rec_pos = np.frombuffer(pos_b, np.int64)
        n = len(rec_pos)
        contig = self.header.ref_names[ref_id]
        if n == 0:
            return {}
        ends = np.frombuffer(ends_b, np.int64)
        mapq = np.frombuffer(mapq_b, np.uint8)
        flags = np.frombuffer(flags_b, np.uint16)
        next_ref = np.frombuffer(nref_b, np.int32)
        next_pos = np.frombuffer(npos_b, np.int64)
        tlen = np.frombuffer(tlen_b, np.int32)
        name_hashes = np.frombuffer(hash_b, np.uint64)
        name_offsets = np.frombuffer(nameoff_b, np.int64)
        seq = np.frombuffer(seq_b, np.uint8)
        quals = np.frombuffer(qual_b, np.uint8)
        seq_offsets = np.frombuffer(soff_b, np.int64)
        cigar_ops = np.frombuffer(cig_b, np.int32).reshape(-1, 2)
        cigar_offsets = np.frombuffer(coff_b, np.int64)
        aux_start = np.frombuffer(auxs_b, np.int64)
        aux_end = np.frombuffer(auxe_b, np.int64)
        names = None
        if keep_names:
            names = [nameblob[int(name_offsets[i]):int(name_offsets[i + 1])]
                     .decode("latin-1") for i in range(n)]
        samples = self.header.samples
        if len(samples) == 1:
            sample_of = None
        else:
            sample_of = np.zeros(n, np.int64)
            for k in range(n):
                rg = _find_rg(buf, int(aux_start[k]), int(aux_end[k]))
                if rg is not None:
                    sm = self.header.read_group_sample.get(rg, samples[0])
                    sample_of[k] = samples.index(sm) if sm in samples else 0
        arr = np.frombuffer(buf, np.uint8)
        aux_lens = aux_end - aux_start

        def build(sel: np.ndarray | None) -> ReadBatch:
            if sel is None:            # single sample: flat arrays as-is
                batch = ReadBatch(
                    contig=contig, begins=rec_pos.copy(), ends=ends.copy(),
                    mapq=mapq.copy(), flags=flags.copy(),
                    seq=seq.copy(), quals=quals.copy(),
                    seq_offsets=seq_offsets.copy(),
                    cigar_ops=cigar_ops.copy(),
                    cigar_offsets=cigar_offsets.copy(),
                    mate_begins=next_pos.copy(),
                    mate_same_contig=(next_ref == ref_id),
                    template_lengths=tlen.copy(),
                    names=names, name_hashes=name_hashes.copy())
                if keep_aux:
                    batch.aux, batch.aux_offsets = _ragged_slice(
                        arr, aux_start, aux_lens)
                return batch
            lens_sel = np.diff(seq_offsets)[sel]
            new_soff = np.zeros(len(sel) + 1, np.int64)
            np.cumsum(lens_sel, out=new_soff[1:])
            gidx = (np.repeat(seq_offsets[sel], lens_sel)
                    + np.arange(int(new_soff[-1]))
                    - np.repeat(new_soff[:-1], lens_sel))
            ops_sel = np.diff(cigar_offsets)[sel]
            new_coff = np.zeros(len(sel) + 1, np.int64)
            np.cumsum(ops_sel, out=new_coff[1:])
            cgidx = (np.repeat(cigar_offsets[sel], ops_sel)
                     + np.arange(int(new_coff[-1]))
                     - np.repeat(new_coff[:-1], ops_sel))
            batch = ReadBatch(
                contig=contig, begins=rec_pos[sel], ends=ends[sel],
                mapq=mapq[sel], flags=flags[sel],
                seq=seq[gidx], quals=quals[gidx], seq_offsets=new_soff,
                cigar_ops=cigar_ops[cgidx], cigar_offsets=new_coff,
                mate_begins=next_pos[sel],
                mate_same_contig=(next_ref[sel] == ref_id),
                template_lengths=tlen[sel],
                names=None if names is None else [names[int(k)] for k in sel],
                name_hashes=name_hashes[sel])
            if keep_aux:
                batch.aux, batch.aux_offsets = _ragged_slice(
                    arr, aux_start[sel], aux_lens[sel])
            return batch

        out: dict[str, ReadBatch] = {}
        for si, sample in enumerate(samples):
            if sample_of is None:
                out[sample] = build(None).sorted_by_begin()
            else:
                sel = np.flatnonzero(sample_of == si)
                out[sample] = (ReadBatch.empty(contig) if len(sel) == 0
                               else build(sel).sorted_by_begin())
        return out


def _ragged_slice(arr: np.ndarray, starts: np.ndarray,
                  lens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Concatenate arr[starts[i]:starts[i]+lens[i]] -> (flat, offsets)."""
    offs = np.zeros(len(starts) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    total = int(offs[-1])
    if total == 0:
        return np.zeros(0, np.uint8), offs
    gidx = (np.repeat(starts, lens) + np.arange(total)
            - np.repeat(offs[:-1], lens))
    return arr[gidx], offs


_TAG_SIZES = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4, "A": 1}


def _find_rg(buf: bytes, off: int, end: int) -> str | None:
    while off + 3 <= end:
        tag = buf[off:off + 2]
        typ = chr(buf[off + 2])
        off += 3
        if typ in _TAG_SIZES:
            if tag == b"RG":
                return None
            off += _TAG_SIZES[typ]
        elif typ in ("Z", "H"):
            zend = buf.index(b"\x00", off, end) if b"\x00" in buf[off:end] else end
            if tag == b"RG":
                return buf[off:zend].decode("latin-1")
            off = zend + 1
        elif typ == "B":
            sub = chr(buf[off])
            cnt = int.from_bytes(buf[off + 1:off + 5], "little")
            off += 5 + _TAG_SIZES.get(sub, 1) * cnt
        else:
            break
    return None


__all__ = ["BamFile", "BamHeader", "BaiIndex"]
