"""The port's evidence BAM (--bamout) against the reference's.

The host extension's banded traceback against the reference's numpy one;
realign_region, realign_evidence and run_bamout (MINI and FULL) on the
scenes of the reference package's evidence-BAM tests, and
the CLI's --bamout on a simulated 5 kb diploid at 30x, on the CPU: the
port must write the reference's BAM and BAI byte for byte. The CLI's BAM
must not depend on where read assignment scored its job sets (the host DP,
the plain twin of kernel #1 or of kernel #3): all equal the reference CLI's,
whose small runs take the host DP, made under octopus's rule for tied
reads (`reference_tie_rule`), which the port follows and the JAX package
does not. A .cram bamout path is refused as in the reference.
"""

import filecmp
import os

import numpy as np
import pytest

import reference_tie_rule as tie_rule
from octopus_tpu import cli as ref_cli
from octopus_tpu.basics import reads as ref_reads
from octopus_tpu.core.tools import bam_realigner as ref_realigner
from octopus_tpu.core.types.haplotypes import Haplotype as RefHaplotype
from octopus_tpu.core.types.variants import Variant as RefVariant
from octopus_tpu.io.bam import BamFile as RefBamFile
from octopus_tpu.io.fasta import InMemoryReference as RefInMemoryReference
from octopus_tpu.io.fasta import ReferenceGenome as RefReferenceGenome
from octopus_tpu_torch import cli
from octopus_tpu_torch.basics.reads import make_read_batch
from octopus_tpu_torch.basics.sequence import decode_sequence
from octopus_tpu_torch.core.likelihood import likelihood_array as la
from octopus_tpu_torch.core.likelihood.likelihood_array import LikelihoodConfig
from octopus_tpu_torch.core.tools import bam_realigner
from octopus_tpu_torch.core.types.haplotypes import Haplotype
from octopus_tpu_torch.core.types.variants import Variant
from octopus_tpu_torch.io.bam import BamFile
from octopus_tpu_torch.io.bam_writer import BamWriter, build_bai
from octopus_tpu_torch.io.fasta import InMemoryReference, ReferenceGenome
from octopus_tpu_torch.io.vcf import VcfHeader, VcfRecord, VcfWriter
from octopus_tpu_torch.utils.synthetic import simulate_diploid

PINNED = ("OCTOPUS_TPU_HOST_HMM_MAX", "OCTOPUS_TPU_HOST_LATENTS")
CPU = LikelihoodConfig(device="cpu")


def same_files(a, b):
    return all(filecmp.cmp(a + ext, b + ext, shallow=False)
               for ext in ("", ".bai"))


def deletion_scene():
    """tests/test_bam_realigner.py's: 12 reads, half from a haplotype with
    a 3 bp deletion but aligned without it."""
    rng = np.random.default_rng(8)
    ref = rng.integers(0, 4, 400).astype(np.uint8)
    reads = []
    alt = Haplotype.build(0, 400, [Variant.make(200, ref[200:203],
                                                np.zeros(0, np.uint8))],
                          lambda b, e: ref[b:e])
    for i in range(12):
        begin = 160 + 2 * i
        src = alt.sequence if i % 2 == 0 else ref
        reads.append((begin, "60M", decode_sequence(src[begin:begin + 60]),
                      [35] * 60, 60, 0))
    return ref, reads


def haplotypes(mod_haplotype, mod_variant, ref):
    fetch = lambda b, e: ref[b:e]  # noqa: E731
    v = mod_variant.make(200, ref[200:203], np.zeros(0, np.uint8))
    return [mod_haplotype.build(0, 400, [], fetch),
            mod_haplotype.build(0, 400, [v], fetch)]


@pytest.mark.parametrize("pad", [4, 8, 16])
def test_native_banded_traceback_equals_the_reference(pad):
    """The realigner's banded traceback, run by the host extension, gives
    the reference's numpy banded_align: score, start and op string, on
    seeded reads with mismatches, Ns and tied gap penalties."""
    from octopus_tpu.core.likelihood import pairhmm_ref as ref_ph
    from octopus_tpu_torch.core.likelihood import pairhmm_ref as ph
    assert callable(ph._native.banded_traceback), \
        "the host extension runs the traceback"
    rng = np.random.default_rng(pad)
    for trial in range(30):
        R = int(rng.integers(1, 160))
        W = R + 2 * pad - 1
        truth = rng.integers(0, 5 if trial % 3 == 0 else 4, W).astype(np.uint8)
        start = int(rng.integers(0, 2 * pad))
        target = truth[start:start + R].copy()
        if len(target) < R or trial % 4 == 0:
            target = rng.integers(0, 4, R).astype(np.uint8)
        flip = rng.random(R) < 0.05
        target[flip] = rng.integers(0, 4, int(flip.sum()))
        quals = rng.integers(2, 41, R).astype(np.uint8)
        opn = rng.integers(5, 50, W).astype(np.int16)
        ext = rng.integers(1, 10, W).astype(np.int16)
        if trial % 5 == 0:
            opn[:], ext[:] = 10, 3
        args = (truth, target, quals, opn, ext)
        want = ref_ph.banded_align(*args, nuc_prior=2, pad=pad)
        assert ph.banded_align(*args, nuc_prior=2, pad=pad) == want
        cm = ph.match_costs(target, quals, truth, None, None)
        assert ph._banded_align_py(cm, opn.astype(np.int32),
                                   ext.astype(np.int32), R, 2, pad) == want


def test_realign_region_equals_the_reference():
    ref, reads = deletion_scene()
    got = bam_realigner.realign_region(
        make_read_batch("chr1", reads), haplotypes(Haplotype, Variant, ref),
        [0, 1], 0, CPU)
    want = ref_realigner.realign_region(
        ref_reads.make_read_batch("chr1", reads),
        haplotypes(RefHaplotype, RefVariant, ref), [0, 1], 0)
    for field in ("begins", "ends", "cigar_ops", "cigar_offsets"):
        assert np.array_equal(getattr(got[0], field), getattr(want[0], field))
    assert got[1] == want[1] and got[2] == want[2]
    assert got[2][0] > 0 and got[2][1] > 0


def test_realign_evidence_writes_the_reference_bam(tmp_path):
    ref, reads = deletion_scene()
    got, want = str(tmp_path / "port.bam"), str(tmp_path / "ref.bam")
    support = bam_realigner.realign_evidence(
        make_read_batch("chr1", reads), haplotypes(Haplotype, Variant, ref),
        [0, 1], 0, got, ["chr1"], [400], sample="S", scoring=CPU)
    assert support == ref_realigner.realign_evidence(
        ref_reads.make_read_batch("chr1", reads),
        haplotypes(RefHaplotype, RefVariant, ref), [0, 1], 0, want,
        ["chr1"], [400], sample="S")
    assert same_files(got, want)
    from octopus_tpu_torch.basics.cigar import cigar_to_string
    batch = BamFile(got).fetch("chr1", 0, 400)["S"]
    assert any("3D" in cigar_to_string(batch.cigar(i))
               for i in range(len(batch)))


@pytest.fixture
def scene(tmp_path):
    """The reference's whole-run bamout scene: one het SNV at 2000 of 4 kb,
    ten reads, and a read far from the call that only FULL passes through."""
    rng = np.random.default_rng(3)
    ref_codes = rng.integers(0, 4, 4000).astype(np.uint8)
    fetch = lambda b, e: ref_codes[b:e]  # noqa: E731
    v = Variant.make(2000, ref_codes[2000:2001],
                     np.asarray([(ref_codes[2000] + 1) % 4], np.uint8))
    h_ref = Haplotype.build(1920, 2120, [], fetch)
    h_alt = Haplotype.build(1920, 2120, [v], fetch)
    reads = [(10, "30M", "A" * 30, [30] * 30, 60, 0)]
    for i in range(10):
        begin = 1950 + 3 * i
        src = h_alt if i % 2 else h_ref
        seq = decode_sequence(src.sequence[begin - 1920:begin - 1920 + 60])
        reads.append((begin, "60M", seq, [35] * 60, 60, 0))
    bam_path = str(tmp_path / "in.bam")
    with BamWriter(bam_path, ["chr1"], [4000], samples=["S"]) as w:
        w.write_batch(make_read_batch("chr1", reads), sample="S")
    build_bai(bam_path)
    header = VcfHeader()
    header.contigs.append(("chr1", 4000))
    header.samples = ["S"]
    vcf = str(tmp_path / "calls.vcf")
    with VcfWriter(vcf, header) as w:
        w.write(VcfRecord("chr1", 2001, ".", "ACGT"[ref_codes[2000]],
                          ["ACGT"[(ref_codes[2000] + 1) % 4]], 100.0,
                          ["PASS"], {}, ["GT"], [{"GT": "0|1"}]))
    return tmp_path, ref_codes, bam_path, vcf


@pytest.mark.parametrize("bamout_type", ["MINI", "FULL"])
def test_run_bamout_writes_the_reference_bam(scene, bamout_type):
    tmp_path, ref_codes, bam_path, vcf = scene
    got, want = (str(tmp_path / f"{who}_{bamout_type}.bam")
                 for who in ("port", "ref"))
    stats = bam_realigner.run_bamout(
        vcf, ReferenceGenome(InMemoryReference({"chr1": ref_codes})),
        [BamFile(bam_path)], ["S"], got, bamout_type=bamout_type,
        scoring=CPU)
    assert stats == ref_realigner.run_bamout(
        vcf, RefReferenceGenome(RefInMemoryReference({"chr1": ref_codes})),
        [RefBamFile(bam_path)], ["S"], want, bamout_type=bamout_type)
    assert stats == {"realigned": 10,
                     "passthrough": 1 if bamout_type == "FULL" else 0}
    assert same_files(got, want)
    batch = BamFile(got).fetch("chr1", 0, 4000, keep_aux=True)["S"]
    assert len({batch.tag(i, "HP") for i in range(len(batch))}) > 1


@pytest.fixture(scope="module")
def diploid(tmp_path_factory):
    """A 5 kb diploid, and the reference CLI's calls and evidence BAM."""
    d = tmp_path_factory.mktemp("bamout")
    fa, bam, _, _ = simulate_diploid(str(d), kb=5, depth=30, seed=5,
                                     spacing=(150, 450))
    saved = {k: os.environ.get(k) for k in PINNED}
    try:
        with tie_rule.applied():
            assert ref_cli.main(["-R", fa, "-I", bam, "-o", str(d / "ref.vcf"),
                                 "--bamout", str(d / "ref.bam")]) == 0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return d, fa, bam


ROUTINGS = {
    "default": {},
    "host_dp": {"OCTOPUS_TPU_HOST_HMM_MAX": "1000000000"},
    "kernel1_plain": {"OCTOPUS_TPU_HOST_HMM_MAX": "0"},
    "kernel3_plain": {"OCTOPUS_TPU_HOST_HMM_MAX": "0",
                      "OCTOPUS_TPU_UNROLLED_HMM": "1"},
}


@pytest.mark.parametrize("routing", sorted(ROUTINGS))
def test_cli_bamout_writes_the_reference_bam(diploid, monkeypatch, routing):
    d, fa, bam = diploid
    for k in PINNED:
        monkeypatch.delenv(k, raising=False)
    for k, v in ROUTINGS[routing].items():
        monkeypatch.setenv(k, v)
    out, bamout = str(d / f"port_{routing}.vcf"), str(d / f"port_{routing}.bam")
    la.ROUTING.reset()
    assert cli.main(["-R", fa, "-I", bam, "-o", out, "--device", "cpu",
                     "--bamout", bamout]) == 0
    assert same_files(bamout, str(d / "ref.bam"))
    with open(out) as a, open(d / "ref.vcf") as b:
        assert [x for x in a if not x.startswith("##")] == \
            [x for x in b if not x.startswith("##")]
    if routing.endswith("_plain"):
        scorer = ("pairhmm_lanes_plain" if routing == "kernel3_plain"
                  else "pairhmm_plain")
        assert set(la.ROUTING.job_sets) == {("populate", scorer),
                                            ("assignment", scorer)}
    batch = BamFile(bamout).fetch("chr1", 0, 5000, keep_aux=True)["SIM"]
    assert len(batch) > 100 and batch.tag(0, "LK") is not None


def test_cram_bamout_path_is_refused(diploid, capsys):
    d, fa, bam = diploid
    argv = ["-R", fa, "-I", bam, "-o", str(d / "never.vcf"),
            "--bamout", str(d / "evidence.cram")]
    assert ref_cli.main(argv) == 2
    want = " ".join(capsys.readouterr().err.split())
    assert cli.main([*argv, "--device", "cpu"]) == 2
    got = " ".join(capsys.readouterr().err.split())
    assert "--bamout CRAM output is not supported" in got
    assert got == want
    assert not os.path.exists(d / "never.vcf")
    assert not os.path.exists(d / "evidence.cram")
