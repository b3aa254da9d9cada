"""The port's CRAM 3.0 input against the reference package's.

The thirteen cases of tests/test_cram.py on the port's modules (varints,
codecs, rANS, writer and reader round trips, .crai region queries,
ReadManager, calling from a CRAM), each also held against the reference:
the port's CramWriter writes the reference writer's bytes (but for the
file id, an MD5 of the path) and its .crai's text,
the reference's reader decodes what the port wrote and the other way
round, and rANS streams are byte-identical. Last, the port's CLI on a CRAM
that its cram_writer made from a simulated BAM writes the BAM run's lines.
"""

import gzip
import os
import time
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

from octopus_tpu.io import cram as ref_cram
from octopus_tpu.io import cram_writer as ref_cram_writer
from octopus_tpu.io import fasta as ref_fasta
from octopus_tpu.io import rans as ref_rans
from octopus_tpu_torch import cli
from octopus_tpu_torch.basics.reads import (FLAG_PAIRED, FLAG_REVERSE,
                                            make_read_batch)
from octopus_tpu_torch.config.options import build_parser
from octopus_tpu_torch.io import rans
from octopus_tpu_torch.io.bam import BamFile
from octopus_tpu_torch.io.bam_writer import BamWriter, build_bai
from octopus_tpu_torch.io.cram import (BitReader, BitWriter, CramFile,
                                       Encoding, parse_encoding, read_itf8,
                                       read_ltf8, write_itf8, write_ltf8)
from octopus_tpu_torch.io.cram_writer import CramWriter
from octopus_tpu_torch.io.fasta import (IndexedFasta, InMemoryReference,
                                        ReferenceGenome)
from octopus_tpu_torch.io.read_manager import ReadManager
from octopus_tpu_torch.io.vcf import VcfReader
from octopus_tpu_torch.run import run_calling
from octopus_tpu_torch.utils.synthetic import simulate_diploid

PINNED = ("OCTOPUS_TPU_HOST_HMM_MAX", "OCTOPUS_TPU_HOST_LATENTS")


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def test_itf8_roundtrip():
    for v in [0, 1, 127, 128, 255, 16383, 16384, (1 << 21) - 1, 1 << 21,
              (1 << 28) - 1, 1 << 28, (1 << 31) - 1, -1, -2]:
        data = write_itf8(v)
        assert data == ref_cram.write_itf8(v)
        assert read_itf8(data, 0) == (v, len(data))


def test_ltf8_roundtrip():
    for v in [0, 1, 127, 128, (1 << 14) - 1, 1 << 14, (1 << 28), (1 << 35),
              (1 << 49), (1 << 56) - 1, 1 << 56, (1 << 62), -1]:
        data = write_ltf8(v)
        assert data == ref_cram.write_ltf8(v)
        assert read_ltf8(data, 0) == (v, len(data))


def test_rans_roundtrip_orders():
    rng = np.random.default_rng(3)
    for d in [b"", b"Q" * 1000,
              bytes(rng.choice([30, 35, 37, 40], 3000).astype(np.uint8)),
              bytes(rng.integers(0, 256, 777, dtype=np.uint8))]:
        for order in (0, 1):
            stream = rans.compress(d, order)
            assert stream == ref_rans.compress(d, order)
            assert rans.uncompress(stream) == d
            assert ref_rans.uncompress(stream) == d
    assert callable(rans._native.rans_uncompress), \
        "the host extension decodes rANS"


def test_core_codecs_decode():
    # beta: value 5 with offset 2 in 4 bits -> stores 7
    w = BitWriter()
    w.write(7, 4)
    assert Encoding(6, offset=2, nbits=4).decode_int(BitReader(w.getvalue()), {}) == 5
    # gamma: value 5, offset 0 -> two leading zeros and '101'
    w = BitWriter()
    w.write(0, 2)
    w.write(5, 3)
    assert Encoding(9, offset=0).decode_int(BitReader(w.getvalue()), {}) == 5
    # subexp: k=2, u=0 -> a 2-bit value
    w = BitWriter()
    w.write(0, 1)
    w.write(3, 2)
    assert Encoding(7, offset=0, k=2).decode_int(BitReader(w.getvalue()), {}) == 3
    # canonical huffman, two symbols of length 1
    enc = Encoding(3, values=[10, 20], lengths=[1, 1])
    w = BitWriter()
    w.write(0, 1)
    w.write(1, 1)
    r = BitReader(w.getvalue())
    assert enc.decode_int(r, {}) == 10
    assert enc.decode_int(r, {}) == 20
    # a zero-bit constant huffman consumes nothing
    assert Encoding(3, values=[42], lengths=[0]).decode_int(BitReader(b""), {}) == 42


def test_encoding_serialise_parse_roundtrip():
    for enc in [Encoding(1, content_id=7),
                Encoding(3, values=[1, 2, 3], lengths=[1, 2, 2]),
                Encoding(5, content_id=9, stop=0),
                Encoding(6, offset=1, nbits=8),
                Encoding(4, len_enc=Encoding(1, content_id=3),
                         val_enc=Encoding(1, content_id=4))]:
        data = enc.serialise()
        got, off = parse_encoding(data, 0)
        want, ref_off = ref_cram.parse_encoding(data, 0)
        assert off == ref_off == len(data)
        assert got.codec == enc.codec == want.codec
        assert got.content_id == enc.content_id == want.content_id
        assert got.values == enc.values == want.values
        assert got.lengths == enc.lengths == want.lengths


# ---------------------------------------------------------------------------
# round trips
# ---------------------------------------------------------------------------

@pytest.fixture
def genome():
    rng = np.random.default_rng(17)
    seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 5000))
    contigs = {"chr1": seq, "chr2": seq[:2000]}
    return (ReferenceGenome(InMemoryReference(contigs)),
            ref_fasta.ReferenceGenome(ref_fasta.InMemoryReference(contigs)),
            seq)


def make_reads(seq, n=40, read_len=80, seed=2):
    """tests/test_cram.py's reads: SNVs, deletions, insertions, soft clips."""
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(n):
        b = int(rng.integers(0, len(seq) - read_len - 20))
        if i % 5 == 0:
            s = list(seq[b:b + read_len])
            s[33] = "T" if s[33] != "T" else "A"
            reads.append((b, f"{read_len}M", "".join(s), [35] * read_len, 58,
                          FLAG_PAIRED | (FLAG_REVERSE if i % 2 else 0)))
        elif i % 5 == 1:
            s = seq[b:b + 40] + seq[b + 43:b + 43 + (read_len - 40)]
            reads.append((b, f"40M3D{read_len - 40}M", s, [30] * read_len, 60, 0))
        elif i % 5 == 2:
            s = seq[b:b + 30] + "ACGT" + seq[b + 30:b + 30 + (read_len - 34)]
            reads.append((b, f"30M4I{read_len - 34}M", s,
                          list(range(20, 20 + read_len)), 60, 0))
        elif i % 5 == 3:
            s = "TTTT" + seq[b:b + read_len - 8] + "GGGG"
            reads.append((b, f"4S{read_len - 8}M4S", s, [37] * read_len, 41, 0))
        else:
            reads.append((b, f"{read_len}M", seq[b:b + read_len],
                          [25] * read_len, 60, 0))
    return make_read_batch("chr1", reads).sorted_by_begin()


def assert_batches_equal(a, b):
    assert len(a) == len(b)
    for field in ("begins", "ends", "mapq", "flags", "seq", "quals",
                  "seq_offsets", "cigar_ops"):
        assert np.array_equal(getattr(a, field), getattr(b, field)), field


def write_both(tmp_path, name, genome, batches, contigs=(("chr1", 5000),
                                                          ("chr2", 2000)),
               **kwargs):
    """The same reads through the port's and the reference's CramWriter;
    both files must be byte-identical. Returns the port's path."""
    ref, ref_ref, _ = genome
    names, lengths = [c for c, _ in contigs], [n for _, n in contigs]
    paths = []
    # both writers gzip the header block with the current second as its
    # mtime: one clock for both, or a second boundary between them differs
    with mock.patch.object(time, "time", return_value=time.time()):
        for writer, reference, who in ((CramWriter, ref, "port"),
                                       (ref_cram_writer.CramWriter, ref_ref,
                                        "ref")):
            path = str(tmp_path / f"{name}_{who}.cram")
            with writer(path, names, lengths, samples=list(batches),
                        reference=reference, **kwargs) as w:
                for sample, batch in batches.items():
                    w.write_batch(batch, sample=sample)
            paths.append(path)
    # equal bytes but for the 20-byte file id, an MD5 of the path
    port, ref_bytes = (Path(p).read_bytes() for p in paths)
    assert port[:6] == ref_bytes[:6] and port[26:] == ref_bytes[26:]
    if os.path.exists(paths[0] + ".crai"):
        # gzip text, whose header carries a time: the text must be equal
        assert gzip.open(paths[0] + ".crai").read() == \
            gzip.open(paths[1] + ".crai").read()
    return paths[0]


def test_cram_roundtrip_with_reference(tmp_path, genome):
    ref, ref_ref, seq = genome
    batch = make_reads(seq)
    path = write_both(tmp_path, "t", genome, {"S1": batch})
    cf = CramFile(path, reference=ref)
    assert cf.samples() == ["S1"]
    assert cf.header.ref_names == ["chr1", "chr2"]
    got = cf.fetch("chr1", 0, 5000)["S1"]
    assert_batches_equal(batch, got)
    cf.close()
    assert_batches_equal(got, ref_cram.CramFile(path, reference=ref_ref)
                         .fetch("chr1", 0, 5000)["S1"])


def test_cram_roundtrip_embedded_reference(tmp_path, genome):
    _, _, seq = genome
    batch = make_reads(seq, n=25, seed=5)
    path = write_both(tmp_path, "e", genome, {"S1": batch},
                      embed_reference=True)
    # no reference for the reader: the embedded one is used
    got = CramFile(path).fetch("chr1", 0, 5000)["S1"]
    assert_batches_equal(batch, got)
    assert_batches_equal(got, ref_cram.CramFile(path).fetch("chr1", 0, 5000)["S1"])


def test_cram_requires_reference_when_not_embedded(tmp_path, genome):
    _, _, seq = genome
    path = write_both(tmp_path, "r", genome, {"S1": make_reads(seq, n=5)},
                      contigs=(("chr1", 5000),))
    with pytest.raises(ValueError, match="reference"):
        CramFile(path).fetch("chr1", 0, 5000)


def test_cram_crai_region_query(tmp_path, genome):
    ref, _, seq = genome
    batch = make_reads(seq, n=60, seed=9)
    path = write_both(tmp_path, "q", genome, {"S1": batch},
                      records_per_slice=20)
    assert os.path.exists(path + ".crai")
    cf = CramFile(path, reference=ref)
    assert cf._crai is not None and len(cf._crai) == 3
    lo, hi = 1000, 1400
    want = batch.overlapping(lo, hi)
    assert_batches_equal(want, cf.fetch("chr1", lo, hi)["S1"])
    # the full scan (no index) agrees
    os.remove(path + ".crai")
    assert_batches_equal(want, CramFile(path, reference=ref)
                         .fetch("chr1", lo, hi)["S1"])


def test_cram_multi_sample_routing(tmp_path, genome):
    ref, _, seq = genome
    b1 = make_reads(seq, n=10, seed=1)
    b2 = make_reads(seq, n=8, seed=2)
    path = write_both(tmp_path, "m", genome, {"SA": b1, "SB": b2})
    got = CramFile(path, reference=ref).fetch("chr1", 0, 5000)
    assert len(got["SA"]) == 10 and len(got["SB"]) == 8
    assert_batches_equal(b1, got["SA"])
    assert_batches_equal(b2, got["SB"])


def test_read_manager_cram(tmp_path, genome):
    ref, _, seq = genome
    batch = make_reads(seq, n=12, seed=4)
    path = write_both(tmp_path, "rm", genome, {"S1": batch})
    mgr = ReadManager([path], reference=ref)
    assert mgr.samples() == ["S1"]
    assert_batches_equal(batch, mgr.fetch("chr1", 0, 5000)["S1"])
    # budgeting degrades gracefully without a BAI
    assert mgr.find_covered_subregion("chr1", 0, 5000, 10) == (0, 5000)
    mgr.close()


def test_cram_names_and_quals_roundtrip(tmp_path, genome):
    ref, ref_ref, seq = genome
    batch = make_reads(seq, n=6, seed=8)
    batch.names = [f"r{i:03d}/1" for i in range(len(batch))]
    path = write_both(tmp_path, "n", genome, {"S1": batch},
                      contigs=(("chr1", 5000),))
    got = CramFile(path, reference=ref).fetch("chr1", 0, 5000,
                                              keep_names=True)["S1"]
    assert got.names == batch.names
    assert ref_cram.CramFile(path, reference=ref_ref).fetch(
        "chr1", 0, 5000, keep_names=True)["S1"].names == batch.names


def test_cram_end_to_end_calling_matches_bam(tmp_path, monkeypatch):
    """Calling from a .cram writes the records of calling from the .bam
    (tests/test_cram.py's input: two hets and a hom SNV on 3 kb)."""
    for k in PINNED:
        monkeypatch.delenv(k, raising=False)
    rng = np.random.default_rng(11)
    seq = "".join("ACGT"[c] for c in rng.integers(0, 4, 3000))
    fa = tmp_path / "ref.fa"
    with open(fa, "w") as fh:
        fh.write(">chr1\n")
        for i in range(0, len(seq), 70):
            fh.write(seq[i:i + 70] + "\n")
    het, hom = [500, 1500], [1000]
    hap_a, hap_b = list(seq), list(seq)
    for p in het:
        hap_a[p] = "T" if seq[p] != "T" else "A"
    for p in hom:
        alt = "G" if seq[p] != "G" else "C"
        hap_a[p] = hap_b[p] = alt
    haps = ["".join(hap_a), "".join(hap_b)]
    reads = []
    for i in range(400):
        hap = haps[i % 2]
        b = int(rng.integers(0, len(hap) - 100))
        reads.append((b, "100M", hap[b:b + 100], [37] * 100, 60,
                      FLAG_REVERSE if i % 3 == 0 else 0))
    batch = make_read_batch("chr1", reads).sorted_by_begin()
    bam = tmp_path / "s.bam"
    with BamWriter(str(bam), ["chr1"], [len(seq)], samples=["NA1"]) as w:
        w.write_batch(batch, sample="NA1")
    build_bai(str(bam))
    cram = tmp_path / "s.cram"
    with CramWriter(str(cram), ["chr1"], [len(seq)], samples=["NA1"],
                    reference=ReferenceGenome(IndexedFasta(str(fa)))) as w:
        w.write_batch(batch, sample="NA1")
    outs = []
    for src, name in [(bam, "b.vcf"), (cram, "c.vcf")]:
        out = tmp_path / name
        args = build_parser().parse_args(["-R", str(fa), "-I", str(src),
                                          "-o", str(out), "-T", "chr1",
                                          "--device", "cpu"])
        assert run_calling(args) == 0
        outs.append([(r.chrom, r.pos, r.ref, tuple(r.alts), round(r.qual, 2),
                      r.sample_values[0]["GT"]) for r in VcfReader(str(out))])
    assert outs[0] == outs[1]
    assert {r[1] - 1 for r in outs[0]} == set(het) | set(hom)


def test_cli_on_a_cram_writes_the_bam_runs_lines(tmp_path, monkeypatch):
    """A simulated 5 kb diploid at 30x, rewritten as a CRAM by the port's
    cram_writer: the port CLI writes the BAM run's lines from it."""
    for k in PINNED:
        monkeypatch.delenv(k, raising=False)
    fa, bam, _, n = simulate_diploid(str(tmp_path), kb=5, depth=30, seed=5,
                                     spacing=(150, 450))
    reference = ReferenceGenome(IndexedFasta(fa))
    batch = BamFile(bam).fetch("chr1", 0, n, keep_names=True)["SIM"]
    cram = str(tmp_path / "SIM.cram")
    with CramWriter(cram, ["chr1"], [n], samples=["SIM"],
                    reference=reference) as w:
        w.write_batch(batch, sample="SIM")
    lines = []
    for src in (bam, cram):
        out = str(tmp_path / (Path(src).suffix[1:] + ".vcf"))
        assert cli.main(["-R", fa, "-I", src, "-o", out, "--device", "cpu"]) == 0
        lines.append([line for line in Path(out).read_text().splitlines()
                      if not line.startswith("##")])
    assert lines[0] == lines[1]
    assert len(lines[0]) > 5
