"""The port's sharding over a device list against the reference's mesh.

The reference shards over a 1-D JAX mesh (the conftest's 8-device virtual
CPU mesh here); the port shards over a list of torch devices, on the CPU
[cpu] * 4. The same numpy-seeded inputs go through both:

* the batch-sharded pair-HMM: int32 scores bit-equal to the reference's
  `_pairhmm_scores_sharded(4, ..., use_pallas=False)` and to the port's
  unsharded plain twin, at bands 8 and 16 and at batches that do not fill
  a kernel block (and, for the port alone, that do not divide by 4);
* the read-sharded genotype reduction: within float32 tolerance of the
  reference's `_genotype_lls_sharded_fn(4, P)` and of the exact host path;
* one window's calls, identical with and without sharding.
"""

import jax
import numpy as np
import pytest
import torch

from octopus_tpu.core.likelihood import pairhmm_batch as ref_pb
from octopus_tpu.core.models import genotype_likelihoods as ref_gl
from octopus_tpu.core.types.genotypes import (generate_all_genotypes,
                                              genotype_counts_matrix)
from octopus_tpu_torch.core.likelihood import pairhmm_batch as pb
from octopus_tpu_torch.core.models import genotype_likelihoods as gl
from octopus_tpu_torch.parallel import (make_mesh, sharded_genotype_step,
                                        sharded_pairhmm_scores)

CPUS = [torch.device("cpu")] * 4
# as tests/test_multichip.py holds the reference's sharded reduction to the
# exact host path; against the reference's own sharded float32 reduction
# the port holds tighter (a few float32 ulps)
RTOL, ATOL = 2e-4, 2e-3
RTOL_SHARDED = 1e-6


def tracks(seed, B, R, pad):
    rng = np.random.default_rng(seed)
    W = R + 2 * pad - 1
    win = rng.integers(0, 4, (B, W))
    lens = rng.integers(R // 2, R + 1, B)
    tgt = np.take_along_axis(win, pad + np.arange(R)[None, :].repeat(B, 0),
                             axis=1)
    tgt = np.where(rng.random((B, R)) < 0.03, rng.integers(0, 4, (B, R)), tgt)
    valid = np.arange(R)[None, :] < lens[:, None]
    tgt = np.where(valid, tgt, pb.PAD_CODE)
    qual = np.where(valid, rng.integers(5, 41, (B, R)), 0)
    return [np.ascontiguousarray(a, np.int32) for a in (
        tgt, qual, win, rng.integers(10, 45, (B, W)),
        rng.integers(1, 8, (B, W)), rng.integers(0, 6, (B, W)),
        rng.integers(3, 50, (B, W)))]


@pytest.mark.parametrize("pad,B", [(8, 64), (8, 148), (16, 36)])
def test_sharded_pairhmm_equals_reference_sharded_and_unsharded(pad, B):
    args = tracks(pad * 1000 + B, B, 40, pad)
    got = sharded_pairhmm_scores(CPUS, *args, pad=pad)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    want = np.asarray(ref_pb._pairhmm_scores_sharded(
        4, *args, pad=pad, nuc_prior=ref_pb.DEFAULT_NUC_PRIOR,
        use_pallas=False))
    assert np.array_equal(got.numpy(), want)
    plain = pb.pairhmm_scores_plain(*map(torch.from_numpy, args), pad=pad)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("B", [1, 3, 149])
def test_sharded_pairhmm_ragged_batch_equals_unsharded(B):
    """Shards are near-equal parts: a batch of fewer pairs than devices, or
    one that does not divide by them, scores as the unsharded twin."""
    args = tracks(B, B, 40, 8)
    got = sharded_pairhmm_scores(CPUS, *args, pad=8)
    plain = pb.pairhmm_scores_plain(*map(torch.from_numpy, args), pad=8)
    assert torch.equal(got, plain)


def test_sharded_pairhmm_counts_one_launch_per_shard(monkeypatch):
    """Each shard calls the scorer `scorer_name` picks for its device once."""
    seen = []
    real = pb._scorer

    def scorer(dev):
        fn = real(dev)

        def counted(*a, **k):
            seen.append((dev.type, a[0].shape[0]))
            return fn(*a, **k)
        return counted

    monkeypatch.setattr(pb, "_scorer", scorer)
    sharded_pairhmm_scores(CPUS, *tracks(0, 10, 30, 8), pad=8)
    assert seen == [("cpu", 3), ("cpu", 3), ("cpu", 2), ("cpu", 2)]


@pytest.mark.parametrize("ploidy,H,R", [(2, 12, 512), (2, 20, 96), (3, 6, 64)])
def test_sharded_genotype_step_matches_reference(ploidy, H, R):
    rng = np.random.default_rng(ploidy * 100 + H)
    lnL = -rng.exponential(3.0, (H, R))
    gts = generate_all_genotypes(H, ploidy)
    counts = genotype_counts_matrix(gts, H).astype(np.float32)
    got = sharded_genotype_step(CPUS, lnL, counts, ploidy)
    assert got.dtype == torch.float32 and got.shape == (len(gts),)
    want = np.asarray(ref_gl._genotype_lls_sharded_fn(4, ploidy)(
        jax.numpy.asarray(lnL, jax.numpy.float32),
        jax.numpy.asarray(counts)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_SHARDED, atol=0)
    np.testing.assert_allclose(got.numpy(),
                               ref_gl.genotype_log_likelihoods_np(lnL, gts),
                               rtol=RTOL, atol=ATOL)


def test_sharded_genotype_step_on_ragged_reads_matches_unsharded():
    rng = np.random.default_rng(7)
    lnL = -rng.exponential(3.0, (8, 101))
    gts = generate_all_genotypes(8, 2)
    counts = genotype_counts_matrix(gts, 8).astype(np.float32)
    got = sharded_genotype_step(CPUS, lnL, counts, 2)
    whole = gl.genotype_log_likelihoods_torch(
        torch.as_tensor(lnL, dtype=torch.float32), torch.from_numpy(counts), 2)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6, atol=1e-4)


def test_shard_selection_rules(monkeypatch):
    """From its floor on, a batch shards over the most local cards that
    divide it and a reduction over all cards, at most one a read, each from
    the caller's card on; below the floor, with no floor (None), on the
    CPU, on one card and under OCTOPUS_TPU_NO_SHARD=1 nothing shards.
    Without CUDA, make_mesh raises."""
    cuda, cuda2 = torch.device("cuda", 0), torch.device("cuda", 2)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(pb, "SHARD_MIN_PAIRS", 6)
    monkeypatch.setattr(gl, "SHARD_MIN_ELEMENTS", 100)
    assert [len(pb._shardable_devices(B, cuda)) for B in (8, 6, 7, 4, 1)] == \
        [4, 3, 1, 1, 1]
    assert pb._shardable_devices(8, cuda) == [torch.device("cuda", i)
                                              for i in range(4)]
    assert pb._shardable_devices(8, cuda2) == [torch.device("cuda", i)
                                               for i in (2, 3, 0, 1)]
    assert [len(gl._reduction_devices(100, R, cuda)) for R in (101, 3, 1)] == \
        [4, 3, 1]
    assert gl._reduction_devices(99, 101, cuda) == [cuda]
    assert gl._reduction_devices(100, 2, cuda2) == [cuda2,
                                                    torch.device("cuda", 3)]
    assert pb._shardable_devices(8, torch.device("cpu")) == [torch.device("cpu")]
    monkeypatch.setattr(pb, "SHARD_MIN_PAIRS", None)
    monkeypatch.setattr(gl, "SHARD_MIN_ELEMENTS", None)
    assert pb._shardable_devices(1 << 20, cuda) == [cuda]
    assert gl._reduction_devices(1 << 30, 101, cuda) == [cuda]
    monkeypatch.setattr(pb, "SHARD_MIN_PAIRS", 0)
    monkeypatch.setattr(gl, "SHARD_MIN_ELEMENTS", 0)
    monkeypatch.setenv("OCTOPUS_TPU_NO_SHARD", "1")
    assert pb._shardable_devices(8, cuda) == [cuda]
    assert gl._reduction_devices(100, 101, cuda) == [cuda]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()


def test_real_window_calls_identical_with_and_without_sharding(monkeypatch):
    """As tests/test_multichip.py does for the reference: one simulated
    window called through IndividualCaller, every pair-HMM job set and
    genotype reduction on the device path, sharded over [cpu] * 4 and not."""
    from octopus_tpu_torch.basics.reads import make_read_batch
    from octopus_tpu_torch.core.callers.individual import (CallerConfig,
                                                           IndividualCaller)
    from octopus_tpu_torch.io.fasta import InMemoryReference, ReferenceGenome
    from octopus_tpu_torch.utils.synthetic import simulate_diploid_reads

    seq, reads, truth, n = simulate_diploid_reads(kb=4, depth=14, seed=3)
    reference = ReferenceGenome(InMemoryReference({"chr1": seq}))
    batch = make_read_batch("chr1", reads).sorted_by_begin()
    monkeypatch.setattr(gl, "HOST_GATE", 0)
    shards = []

    def call_all():
        config = CallerConfig(device="cpu")
        config.likelihood.host_hmm_max = 0
        return [(c.begin, tuple(sorted(c.genotypes[0])), round(c.quality, 3))
                for c in IndividualCaller(reference, "chr1", config).call(
                    0, n, [batch])]

    single = call_all()
    monkeypatch.setattr(pb, "_shardable_devices",
                        lambda B, dev: shards.append(B) or CPUS)
    monkeypatch.setattr(gl, "_reduction_devices",
                        lambda elements, R, dev: shards.append(R) or CPUS)
    sharded = call_all()
    assert shards and single
    assert sharded == single
