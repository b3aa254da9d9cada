"""The port's read I/O and read pipe against the reference package's.

One simulated BAM, written by the port's own writer, is read through both
packages' BamFile; the port's BamWriter and BAI builder must write the
reference's bytes; both packages' ReadPipe must give the same reads and
report on the same batch; both tabix indexers the same index.
"""

import dataclasses
import filecmp
import os

import numpy as np
import pytest

from octopus_tpu.io import bam as ref_bam
from octopus_tpu.io import bam_writer as ref_bam_writer
from octopus_tpu.io import tabix as ref_tabix
from octopus_tpu.readpipe import pipe as ref_pipe
from octopus_tpu.utils import synthetic as ref_synthetic
from octopus_tpu_torch.io import bam, bam_writer, cram_writer, tabix
from octopus_tpu_torch.io.fasta import IndexedFasta, ReferenceGenome
from octopus_tpu_torch.io.read_manager import ReadManager
from octopus_tpu_torch.io.vcf import VcfHeader, VcfRecord, VcfWriter
from octopus_tpu_torch.readpipe import pipe
from octopus_tpu_torch.utils import synthetic

KB, SEED = 4, 21


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    d = tmp_path_factory.mktemp("bam")
    return synthetic.simulate_diploid(str(d), kb=KB, seed=SEED,
                                      spacing=(300, 900))


def assert_batches_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def test_simulated_bam_equals_the_reference_writers_bytes(sample, tmp_path):
    fa, bam_path, truth, n = sample
    ref_fa, ref_bam_path, ref_truth, ref_n = ref_synthetic.simulate_diploid(
        str(tmp_path), kb=KB, seed=SEED, spacing=(300, 900))
    assert (truth, n) == (ref_truth, ref_n)
    for got, want in ((fa, ref_fa), (bam_path, ref_bam_path),
                      (bam_path + ".bai", ref_bam_path + ".bai")):
        assert filecmp.cmp(got, want, shallow=False), os.path.basename(got)


def test_bam_writer_bytes_equal_the_reference(sample, tmp_path):
    _, bam_path, _, n = sample
    batch = bam.BamFile(bam_path).fetch("chr1", 0, n)["SIM"]
    paths = []
    for mod, name in ((bam_writer, "port"), (ref_bam_writer, "ref")):
        path = str(tmp_path / f"{name}.bam")
        with mod.BamWriter(path, ["chr1"], [n], samples=["SIM"]) as w:
            w.write_batch(batch, sample="SIM")
        mod.build_bai(path)
        paths.append(path)
    assert filecmp.cmp(*paths, shallow=False)
    assert filecmp.cmp(paths[0] + ".bai", paths[1] + ".bai", shallow=False)


@pytest.mark.parametrize("region", [(0, KB * 1000), (1200, 1500), (3990, 4000)])
def test_bam_fetch_equals_the_reference(sample, region):
    _, bam_path, _, _ = sample
    got = bam.BamFile(bam_path).fetch("chr1", *region)
    want = ref_bam.BamFile(bam_path).fetch("chr1", *region)
    assert sorted(got) == sorted(want) == ["SIM"]
    assert len(want["SIM"]) > 0
    assert_batches_equal(got["SIM"], want["SIM"])


def test_read_manager_fetches_and_refuses_cram(sample, tmp_path):
    """ReadManager reads the BAM, and since CRAM input is ported no longer
    refuses a .cram: the same reads rewritten as a CRAM by the port's
    writer fetch as the BAM's."""
    fa, bam_path, _, n = sample
    manager = ReadManager([bam_path])
    assert manager.samples() == ["SIM"]
    want = ref_bam.BamFile(bam_path).fetch("chr1", 0, n)["SIM"]
    assert_batches_equal(manager.fetch("chr1", 0, n)["SIM"],
                         want.sorted_by_begin())
    reference = ReferenceGenome(IndexedFasta(fa))
    cram = str(tmp_path / "reads.cram")
    with cram_writer.CramWriter(cram, ["chr1"], [n], samples=["SIM"],
                                reference=reference) as w:
        w.write_batch(want, sample="SIM")
    got = ReadManager([cram], reference=reference).fetch("chr1", 0, n)["SIM"]
    assert len(got) == len(want)
    for field in ("begins", "ends", "mapq", "flags", "seq", "quals",
                  "seq_offsets", "cigar_ops"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want.sorted_by_begin(), field),
                                      err_msg=field)


PIPE_CONFIGS = {
    "default": {},
    "masking_downsampling": dict(mask_tails=3, mask_low_quality_tails=10,
                                 max_base_quality=30, downsample_above=12,
                                 downsample_target=8, min_mapping_quality=20),
}


@pytest.mark.parametrize("config", sorted(PIPE_CONFIGS))
def test_read_pipe_equals_the_reference(sample, config):
    _, bam_path, _, n = sample
    raw = ref_bam.BamFile(bam_path).fetch("chr1", 0, n)["SIM"].sorted_by_begin()
    port_raw = bam.BamFile(bam_path).fetch("chr1", 0, n)["SIM"].sorted_by_begin()
    kwargs = PIPE_CONFIGS[config]
    want, want_report = ref_pipe.ReadPipe(
        ref_pipe.ReadPipeConfig(**kwargs)).process(raw)
    got, got_report = pipe.ReadPipe(pipe.ReadPipeConfig(**kwargs)).process(
        port_raw)
    assert dataclasses.asdict(got_report) == dataclasses.asdict(want_report)
    assert want_report.n_raw > want_report.n_downsampled or not kwargs
    assert_batches_equal(got, want)


def test_tabix_index_equals_the_reference(tmp_path):
    header = VcfHeader(contigs=[("chr1", 5000)], samples=["SIM"])
    path = str(tmp_path / "calls.vcf.gz")
    with VcfWriter(path, header) as w:
        for pos in range(100, 4900, 37):
            w.write(VcfRecord(chrom="chr1", pos=pos, id="", ref="A",
                              alts=["C"], qual=30.0, filters=["PASS"],
                              info={}, format_keys=["GT"],
                              sample_values=[{"GT": "0/1"}]))
    got = tabix.index_vcf(path, str(tmp_path / "port.tbi"))
    want = ref_tabix.index_vcf(path, str(tmp_path / "ref.tbi"))
    assert filecmp.cmp(got, want, shallow=False)
