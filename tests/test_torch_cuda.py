"""Tests of the port that need a CUDA card; each skips without one.

This file imports neither JAX nor the reference package's device code, so
the machine with the card runs it alone:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(--noconftest: tests/conftest.py sets up JAX, which that machine lacks.)
"""

import os

import numpy as np
import pytest
import torch

from octopus_tpu_torch.core.likelihood import pairhmm_batch as pb
from test_pairhmm_golden import (
    HARNESS,
    make_cases,
    make_long_indel_cases,
    run_reference,
)


def pack_cases(cases, pad):
    """Golden cases packed into one ragged batch (neutral window fill)."""
    L = max(len(c[1]) for c in cases)
    W = L + 2 * pad - 1
    n = len(cases)
    tgt = np.full((n, L), pb.PAD_CODE, np.int32)
    qual = np.zeros((n, L), np.int32)
    win = np.full((n, W), 4, np.int32)
    opn = np.full((n, W), 64, np.int32)
    ext = np.full((n, W), 64, np.int32)
    msk = np.full((n, W), pb.PAD_CODE, np.int32)
    pri = np.zeros((n, W), np.int32)
    for i, (tw, t, q, o, e, m, p) in enumerate(cases):
        r, w = len(t), len(tw)
        tgt[i, :r], qual[i, :r] = t, q
        win[i, :w], opn[i, :w], ext[i, :w] = tw, o, e
        if m is not None:
            msk[i, :w], pri[i, :w] = m, p
    return tgt, qual, win, opn, ext, msk, pri


GOLDEN_CASES = {
    "plain": lambda: (make_cases(seed=7, n=60, with_snv=False), 8),
    "snv_masked": lambda: (make_cases(seed=42, n=60, with_snv=True), 8),
    "heavy_indel": lambda: (make_cases(seed=1234, n=60, with_snv=True,
                                       max_muts=12), 8),
    "wide_16": lambda: (make_cases(seed=106, n=30, with_snv=True, pad=16)
                        + make_long_indel_cases(seed=107, n=30, pad=16,
                                                indel_len_range=(9, 24)), 16),
    "wide_32": lambda: (make_cases(seed=122, n=30, with_snv=True, pad=32)
                        + make_long_indel_cases(seed=123, n=30, pad=32,
                                                indel_len_range=(9, 48)), 32),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def random_batch(seed, B, R, pad):
    """Ragged reads near their windows, window Ns, SNV masks."""
    rng = np.random.default_rng(seed)
    W = R + 2 * pad - 1
    win = rng.integers(0, 5, (B, W))
    lens = rng.integers(max(R // 2, 1), R + 1, B)
    col = np.arange(R)
    tgt = np.where(rng.random((B, R)) < 0.9, win[:, pad:pad + R] % 4,
                   rng.integers(0, 4, (B, R)))
    valid = col[None, :] < lens[:, None]
    tgt = np.where(valid, tgt, pb.PAD_CODE)
    qual = np.where(valid, rng.integers(5, 60, (B, R)), 0)
    tracks = (tgt, qual, win, rng.integers(3, 55, (B, W)),
              rng.integers(1, 10, (B, W)), rng.integers(0, 6, (B, W)),
              rng.integers(3, 50, (B, W)))
    return [np.ascontiguousarray(a, np.int32) for a in tracks]


SHAPES = [(1000, 60, 8), (333, 60, 16), (257, 60, 32), (200, 1500, 8)]

# kernel -> (CUDA wrapper, plain twin, launch counter)
KERNELS = {
    "pairhmm": (pb.pairhmm_scores_cuda, pb.pairhmm_scores_plain, pb.COUNTS),
    "pairhmm_lanes": (pb.pairhmm_scores_lanes_cuda,
                      pb.pairhmm_scores_lanes_plain, pb.COUNTS_LANES),
    "pairhmm_cost": (pb.pairhmm_scores_cost_cuda,
                     pb.pairhmm_scores_cost_plain, pb.COUNTS_COST),
}


@pytest.mark.parametrize("B,R,pad", SHAPES)
def test_kernel_matches_plain(cuda, B, R, pad):
    args = [torch.from_numpy(a).to(cuda) for a in random_batch(B + R, B, R, pad)]
    before = pb.COUNTS.launches
    got = pb.pairhmm_scores_cuda(*args, pad=pad)
    assert pb.COUNTS.launches == before + 1
    want = pb.pairhmm_scores_plain(*args, pad=pad)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("B,R,pad", SHAPES + [(1, 33, 8), (17, 160, 16)])
@pytest.mark.parametrize("kernel", ["pairhmm_lanes", "pairhmm_cost"])
def test_new_kernels_match_their_plain_twins(cuda, kernel, B, R, pad):
    wrapper, twin, counts = KERNELS[kernel]
    args = [torch.from_numpy(a).to(cuda) for a in random_batch(B + R, B, R, pad)]
    before = counts.launches
    got = wrapper(*args, pad=pad)
    assert counts.launches == before + 1
    want = twin(*args, pad=pad)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, pb.pairhmm_scores_plain(*args, pad=pad))


# every B, R and band of the redesigned kernels' checks, each at least once;
# R = 2000 makes the staging rings wrap many times
VARIANT_SHAPES = [(1, 33, 8), (17, 160, 16), (129, 2000, 32), (300, 150, 8),
                  (65536, 150, 8), (1, 2000, 16), (17, 150, 32),
                  (129, 33, 16), (300, 2000, 8), (65536, 160, 16),
                  (300, 160, 32), (65536, 33, 32)]


def variants(pad):
    """(launcher, keyword arguments) of every variant the two main-path
    kernels are built with at `pad`: csrc/pairhmm.cu's split chain at every
    T and wavefront where K >= 2, csrc/pairhmm_lanes.cu at both lane
    widths."""
    for T in pb.THREADS:
        if T <= 2 * pad:
            yield pb.launch_kernel, {"threads": T, "wave": False}
        if pb.wave_ok(T, pad):
            yield pb.launch_kernel, {"threads": T, "wave": True}
    for LW in pb.lanes_widths(pad):
        yield pb.launch_lanes, {"lanes": LW}


@pytest.mark.parametrize("B,R,pad", VARIANT_SHAPES)
def test_every_variant_matches_plain(cuda, B, R, pad):
    args = [torch.from_numpy(a).to(cuda) for a in random_batch(B * 7 + R, B,
                                                               R, pad)]
    want = pb.pairhmm_scores_plain(*args, pad=pad)
    assert torch.equal(pb.pairhmm_scores_lanes_plain(*args, pad=pad), want)
    for launch, kw in variants(pad):
        got = launch(args, pad=pad, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (launch.__name__, kw)


@pytest.mark.parametrize("kind", sorted(GOLDEN_CASES))
def test_every_variant_matches_golden_binary(cuda, kind):
    if not os.path.exists(HARNESS):
        pytest.skip("golden harness not built")
    cases, pad = GOLDEN_CASES[kind]()
    want = run_reference(cases, pad=pad)
    args = [torch.from_numpy(a).to(cuda) for a in pack_cases(cases, pad)]
    for launch, kw in variants(pad):
        assert launch(args, pad=pad, **kw).cpu().tolist() == want, (
            launch.__name__, kw)


# csrc/pairhmm_cost.cu: the main path's ragged launch sizes at R = 160 and
# every band, R = 2000 (the cm ring and window rings wrap many times), and
# batches whose B is a multiple of 4 (16-byte copies) beside ragged ones
# (4-byte copies)
COST_SHAPES = ([(B, 160, pad) for pad in (8, 16, 32) for B in (1, 9, 37, 519)]
               + [(4096, 2000, 8), (129, 2000, 32), (300, 2000, 16),
                  (1024, 160, 16), (65536, 150, 8)])


@pytest.mark.parametrize("B,R,pad", COST_SHAPES)
def test_every_cost_variant_matches_plain(cuda, B, R, pad):
    host = random_batch(B * 3 + R + pad, B, R, pad)
    args = [torch.from_numpy(a).to(cuda) for a in host]
    cm = pb.match_cost_tensor(*(args[i] for i in (0, 1, 2, 5, 6)), pad=pad)
    opnT, extT = (a.t().contiguous() for a in args[3:5])
    want = pb.pairhmm_scores_cost_plain(*args, pad=pad)
    built = [T for T in pb.THREADS if pb.cost_threads_ok(T, pad)]
    before = pb.COUNTS_COST.launches
    for T in built:
        got = pb.launch_cost(cm, opnT, extT, pad=pad, threads=T)
        torch.cuda.synchronize()
        assert torch.equal(got, want), T
    assert pb.launch_cost(cm, opnT, extT, pad=pad).equal(want)
    assert pb.COUNTS_COST.launches == before + len(built) + 1


@pytest.mark.parametrize("kind", sorted(GOLDEN_CASES))
def test_kernel_matches_golden_binary(cuda, kind):
    if not os.path.exists(HARNESS):
        pytest.skip("golden harness not built")
    cases, pad = GOLDEN_CASES[kind]()
    want = run_reference(cases, pad=pad)
    got = pb.pairhmm_scores(*pack_cases(cases, pad), pad=pad, device=cuda)
    assert got.cpu().tolist() == want


@pytest.mark.parametrize("kind", sorted(GOLDEN_CASES))
@pytest.mark.parametrize("kernel", ["pairhmm_lanes", "pairhmm_cost"])
def test_new_kernels_match_golden_binary(cuda, kernel, kind):
    if not os.path.exists(HARNESS):
        pytest.skip("golden harness not built")
    cases, pad = GOLDEN_CASES[kind]()
    want = run_reference(cases, pad=pad)
    args = [torch.from_numpy(a).to(cuda) for a in pack_cases(cases, pad)]
    got = KERNELS[kernel][0](*args, pad=pad)
    assert got.cpu().tolist() == want


def test_dispatch_launches_lanes_kernel_when_unrolled(cuda, monkeypatch):
    monkeypatch.setenv("OCTOPUS_TPU_UNROLLED_HMM", "1")
    host = random_batch(2, 64, 40, 8)
    before = (pb.COUNTS.launches, pb.COUNTS_LANES.launches)
    got = pb.pairhmm_scores(*host, pad=8, device=cuda)
    assert (pb.COUNTS.launches, pb.COUNTS_LANES.launches) == (
        before[0], before[1] + 1)
    want = pb.pairhmm_scores_plain(*(torch.from_numpy(a) for a in host), pad=8)
    assert torch.equal(got.cpu(), want)


def test_dispatch_launches_on_cuda(cuda):
    host = random_batch(1, 64, 40, 8)
    before = pb.COUNTS.launches
    got = pb.pairhmm_scores(*host, pad=8, device=cuda)
    assert got.device.type == "cuda" and pb.COUNTS.launches == before + 1


def test_genotype_reduction_on_cuda(cuda):
    from octopus_tpu_torch.core.models import genotype_likelihoods as gl
    from octopus_tpu_torch.core.types.genotypes import generate_all_genotypes
    rng = np.random.default_rng(0)
    lnL = -rng.gamma(2.0, 3.0, (30, 2100))
    g = generate_all_genotypes(30, 2)
    got = gl.genotype_log_likelihoods(lnL, g, device=cuda)
    np.testing.assert_allclose(got, gl.genotype_log_likelihoods_np(lnL, g),
                               rtol=1e-5)


def test_caller_on_cuda_writes_the_cpu_records(cuda):
    import dataclasses
    from octopus_tpu_torch.basics.reads import make_read_batch
    from octopus_tpu_torch.core.callers.base import BaseCallerConfig
    from octopus_tpu_torch.core.callers.individual import IndividualCaller
    from octopus_tpu_torch.core.tools.vcf_record_factory import (
        site_call_to_record)
    from octopus_tpu_torch.io.fasta import InMemoryReference, ReferenceGenome
    from octopus_tpu_torch.utils.synthetic import simulate_diploid_reads
    seq, reads, _, n = simulate_diploid_reads(kb=5, seed=5, spacing=(150, 450))
    ref = ReferenceGenome(InMemoryReference({"chr1": seq}))
    batch = make_read_batch("chr1", reads).sorted_by_begin()
    lines = {}
    for device in ("cpu", "cuda"):
        config = BaseCallerConfig(device=device, max_haplotypes=8)
        config.likelihood = dataclasses.replace(config.likelihood,
                                                host_hmm_max=0)
        before = pb.COUNTS.launches
        calls = IndividualCaller(ref, "chr1", config).call(0, n, batch)
        lines[device] = [site_call_to_record(c, "chr1", ref).to_line()
                         for c in calls]
        if device == "cuda":
            assert pb.COUNTS.launches > before
    assert lines["cuda"] == lines["cpu"] and lines["cpu"]


@pytest.mark.parametrize("unrolled", [False, True])
def test_cli_on_cuda_writes_the_cpu_records(cuda, tmp_path, monkeypatch,
                                            unrolled):
    from octopus_tpu_torch.cli import main
    from octopus_tpu_torch.core.likelihood import likelihood_array as la
    from octopus_tpu_torch.utils.synthetic import simulate_diploid
    fa, bam, _, _ = simulate_diploid(str(tmp_path), kb=5, seed=5,
                                     spacing=(150, 450))
    monkeypatch.setenv("OCTOPUS_TPU_HOST_HMM_MAX", "0")
    if unrolled:
        monkeypatch.setenv("OCTOPUS_TPU_UNROLLED_HMM", "1")
    kernel = "pairhmm_lanes" if unrolled else "pairhmm"
    lines = {}
    for device in ("cpu", "cuda"):
        out = tmp_path / f"{device}.vcf"
        la.ROUTING.reset()
        assert main(["-R", fa, "-I", bam, "-o", str(out),
                     "--device", device]) == 0
        lines[device] = [line for line in out.read_text().splitlines()
                         if not line.startswith("##")]
    assert la.ROUTING.job_sets[("populate", kernel)] > 0
    assert la.ROUTING.job_sets[("assignment", kernel)] > 0
    assert lines["cuda"] == lines["cpu"] and len(lines["cpu"]) > 3


@pytest.mark.parametrize("fn", ["fexp", "flog", "flog1p", "flgamma",
                                "fdigamma", "fsoftmax", "fsum", "fsum_xla",
                                "fdot"])
def test_vb_math_on_cuda_gives_the_cpu_bits(cuda, fn):
    from octopus_tpu_torch.core.models import vb_math
    rng = np.random.default_rng(3)
    x = rng.standard_normal((64, 3, 517)).astype(np.float32)
    if fn in ("flog", "flgamma", "fdigamma"):
        x = np.exp(3 * x).astype(np.float32)     # 1e-5 to 1e5, below 0.5 too
    elif fn == "flog1p":
        x = (np.exp(x) - 0.8).astype(np.float32)
    elif fn == "fexp":
        x = -np.abs(20 * x)
    other = x[::-1].copy()

    def run(device):
        args = {"fsoftmax": (1,), "fsum": (-1,), "fsum_xla": (2,),
                "fdot": (torch.from_numpy(other).to(device),)}.get(fn, ())
        return getattr(vb_math, fn)(torch.from_numpy(x).to(device), *args)

    assert torch.equal(run(cuda).cpu(), run("cpu"))


@pytest.mark.parametrize("engine", ["subclone", "mixture_mixture"])
def test_vb_on_cuda_gives_the_cpu_bits(cuda, monkeypatch, engine):
    from octopus_tpu_torch.core.models import mixture_mixture_vb as mm
    from octopus_tpu_torch.core.models import subclone_vb as vb
    monkeypatch.setenv("OCTOPUS_TPU_VB_DEVICE_MIN", "0")
    rng = np.random.default_rng(4)
    lnL = -rng.exponential(2.0, (6, 300))
    lnL[rng.integers(0, 6, 300), np.arange(300)] = -0.05
    tuples = np.stack([rng.choice(6, 3, replace=False) for _ in range(40)])
    out = {}
    for device in ("cpu", "cuda"):
        vb.COUNTS.reset()
        if engine == "subclone":
            inf = vb.SubcloneModel(n_seeds=3, n_iter=50, device=device
                                   ).evaluate(tuples, lnL)
            out[device] = (inf.genotype_log_evidences, inf.map_alphas)
        else:
            cells = [-np.random.default_rng(n).exponential(2.0, (5, 20 + 7 * n))
                     for n in range(6)]
            inf = mm.VariationalBayesMixtureMixtureModel(device=device
                                                         ).evaluate(
                cells, [[0, 1], [0, 1, 2], [0, 1, 3]])
            out[device] = (np.asarray([inf.log_evidence]),
                           inf.cell_responsibilities, inf.alphas)
        assert (vb.COUNTS.device, vb.COUNTS.host) == (
            (1, 0) if device == "cuda" else (0, 1))
    for got, want in zip(out["cuda"], out["cpu"]):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("n_iter", [1, 2, 3])
def test_vb_subclone_graph_rounds_give_the_cpu_bits(cuda, n_iter):
    """On a card the rounds after the second replay one captured round
    (test_vb_on_cuda_gives_the_cpu_bits runs 50); with none, and with the
    first replayed, the result is the CPU's, bit for bit."""
    from octopus_tpu_torch.core.models import subclone_vb as vb
    rng = np.random.default_rng(n_iter)
    lnl = -rng.exponential(2.0, (50, 3, 70)).astype(np.float32)
    alpha0 = np.asarray([1.5, 1.5, 0.05], np.float32)
    seeds = vb.subclone_seeds(3, 70, 2)
    out = {}
    for device in ("cpu", cuda):
        out[device] = [t.cpu() for t in vb.vb_subclone(
            torch.from_numpy(lnl).to(device),
            torch.from_numpy(alpha0).to(device),
            torch.from_numpy(seeds.copy()).to(device), n_iter=n_iter)]
    for got, want in zip(out[cuda], out["cpu"]):
        assert torch.equal(got, want)


def test_cancer_cli_on_cuda_writes_the_cpu_records(cuda, tmp_path,
                                                   monkeypatch):
    from octopus_tpu_torch.cli import main
    from octopus_tpu_torch.core.likelihood import likelihood_array as la
    from octopus_tpu_torch.core.models import subclone_vb as vb
    from octopus_tpu_torch.utils.synthetic import simulate_tumour_normal
    fa, bam_n, bam_t, _, somatic, _ = simulate_tumour_normal(
        str(tmp_path), kb=8, depth=60, seed=7)
    monkeypatch.setenv("OCTOPUS_TPU_HOST_HMM_MAX", "0")
    monkeypatch.setenv("OCTOPUS_TPU_VB_DEVICE_MIN", "0")
    lines = {}
    for device in ("cpu", "cuda"):
        out = tmp_path / f"{device}.vcf"
        la.ROUTING.reset()
        vb.COUNTS.reset()
        assert main(["-R", fa, "-I", bam_n, bam_t, "-o", str(out),
                     "--device", device, "--caller", "cancer",
                     "--normal-sample", "NORMAL"]) == 0
        lines[device] = [line for line in out.read_text().splitlines()
                         if not line.startswith("##")]
    assert la.ROUTING.job_sets[("populate", "pairhmm")] > 0
    assert vb.COUNTS.device > 0 and vb.COUNTS.host == 0
    assert lines["cuda"] == lines["cpu"]
    assert sum("SOMATIC" in line for line in lines["cpu"]) >= len(somatic) - 1


CSR_TOOLS = {
    "filter_vcf": ["--filter-vcf", "{calls}"],
    "filter_vcf_forest": ["--filter-vcf", "{calls}", "--forest-model",
                          "resources/forests/germline.npz"],
    "bamout": ["--bamout", "{bamout}"],
}


@pytest.mark.parametrize("unrolled", [False, True])
@pytest.mark.parametrize("tool", sorted(CSR_TOOLS))
def test_csr_tools_on_cuda_write_the_cpu_outputs(cuda, tmp_path, monkeypatch,
                                                 tool, unrolled):
    """--filter-vcf and --bamout at gate 0 through kernel #1 (or #3) on the
    card write the CPU run's records and evidence BAM byte for byte."""
    from octopus_tpu_torch.cli import main
    from octopus_tpu_torch.core.likelihood import likelihood_array as la
    from octopus_tpu_torch.utils.synthetic import simulate_diploid
    fa, bam, _, _ = simulate_diploid(str(tmp_path), kb=5, seed=5,
                                     spacing=(150, 450))
    calls = str(tmp_path / "calls.vcf")
    assert main(["-R", fa, "-I", bam, "-o", calls, "--device", "cpu",
                 "--disable-call-filtering"]) == 0
    monkeypatch.setenv("OCTOPUS_TPU_HOST_HMM_MAX", "0")
    if unrolled:
        monkeypatch.setenv("OCTOPUS_TPU_UNROLLED_HMM", "1")
    kernel = "pairhmm_lanes" if unrolled else "pairhmm"
    outputs = {}
    for device in ("cpu", "cuda"):
        out, bamout = tmp_path / f"{device}.vcf", tmp_path / f"{device}.bam"
        la.ROUTING.reset()
        assert main(["-R", fa, "-I", bam, "-o", str(out), "--device", device,
                     *(a.format(calls=calls, bamout=bamout)
                       for a in CSR_TOOLS[tool])]) == 0
        outputs[device] = ([line for line in out.read_text().splitlines()
                            if not line.startswith("##")],
                           bamout.read_bytes() if tool == "bamout" else b"")
    assert la.ROUTING.job_sets[("assignment", kernel)] > 0
    assert outputs["cuda"] == outputs["cpu"]
    assert len(outputs["cpu"][0]) > 3


def _experiment_cases():
    """(experiment, variant, one launch of its kernel on kernel-layout CUDA
    tracks t, its plain version on t) for every variant built."""
    from octopus_tpu_torch.kernel_experiments import (
        _common as xc, dual_chain, v10_kernel, v11_kernel, v13_unroll2)
    cases = [("dual_chain", f"K{K}",
              lambda t, K=K: dual_chain.scores_dual_cuda(*t, K=K))
             for K in dual_chain.KERNEL_K]
    cases += [("v11", v,
               lambda t, v=v: v11_kernel.shfl_call(t, variant=v)
               if v.startswith("shfl") else
               v11_kernel.launch_v11(t, pad=8, nuc_prior=2, variant=v))
              for v in v11_kernel.VARIANTS]
    cases += [("v13", v,
               lambda t, v=v: v13_unroll2.launch_v13(t, pad=8, nuc_prior=2,
                                                     variant=v))
              for v in v13_unroll2.VARIANTS]

    def v9(t):
        return xc.plain_v9(t, 8, 2)

    cases = [(e, v, fn, v9) for e, v, fn in cases]
    # the default through its entry point (K sets only the batch rule)
    v10 = [(v, lambda t, v=v: v10_kernel.tracks10_call(t, variant=v)
            if v.startswith("tracks10") else
            v10_kernel.scores_v10_cuda(*t)
            if v == v10_kernel.DEFAULT_VARIANT else
            v10_kernel.launch_v10(t, pad=8, nuc_prior=2, variant=v))
           for v in v10_kernel.VARIANTS]
    cases += [("v10", v, fn,
               lambda t: v10_kernel.v10_rows_plain(v10_kernel.v10_tracks(*t),
                                                   pad=8))
              for v, fn in v10]
    return cases


EXPERIMENT_VARIANTS = ["dual_chain-K1", "dual_chain-K2", "dual_chain-K4",
                       "v11-regs_ring_p4", "v11-regs_ring_p16",
                       "v11-shfl_blk1", "v11-shfl_blk2", "v13-shared_K1",
                       "v13-shared_K2", "v13-K4x2", "v13-K4x1", "v13-K6x2",
                       "v13-K6x1", "v10-regs_p16", "v10-rings",
                       "v10-tracks10_K1", "v10-tracks10_K2",
                       "v10-tracks10_K4", "v10-tracks10_K8"]


@pytest.mark.parametrize("rows", [150, 33, 7])
@pytest.mark.parametrize("variant", EXPERIMENT_VARIANTS)
def test_kernel_experiments_match_their_plain_versions(cuda, variant, rows):
    """Each experiment kernel (csrc/exp_*.cu) on 3,072 pairs (a multiple of
    every variant's 128 K) equals its plain version, also at odd and
    sub-chunk read lengths; the scorers also equal kernel #1."""
    from octopus_tpu_torch.kernel_experiments import _common as xc
    cases = {f"{e}-{v}": (fn, plain) for e, v, fn, plain in _experiment_cases()}
    assert sorted(cases) == sorted(EXPERIMENT_VARIANTS)
    fn, plain = cases[variant]
    t = xc.as_tracks(xc.parity_inputs(3072, 5, seed=rows, rows=rows), cuda)
    got = fn(t)
    torch.cuda.synchronize()
    assert torch.equal(got, plain(t))
    assert torch.equal(got, pb.pairhmm_scores_cuda(*(a.t() for a in t), pad=8))


EDGE_VARIANTS = [v for v in EXPERIMENT_VARIANTS
                 if v.startswith(("v10-", "v11-", "v13-"))]


@pytest.mark.parametrize("edge", range(6))
@pytest.mark.parametrize("variant", EDGE_VARIANTS)
def test_v11_v13_variants_match_at_edge_shapes(cuda, variant, edge):
    """Every v10, v11 and v13 variant, the Hopper designs and the first
    ports, equals the plain version and kernel
    #1 on the edge inputs (odd and even R from 2, R off the 16-row period
    and the 8-row chunk, half the window bases N, opn and ext just below
    2^22), on 3,072 pairs (a multiple of every variant's 128 K)."""
    from octopus_tpu_torch.kernel_experiments import _common as xc
    rows, kind = xc.EDGE_CASES[edge]
    fn, plain = {f"{e}-{v}": (fn, plain)
                 for e, v, fn, plain in _experiment_cases()}[variant]
    t = xc.as_tracks(xc.edge_inputs(3072, rows, kind, seed=edge), cuda)
    got = fn(t)
    torch.cuda.synchronize()
    assert torch.equal(got, plain(t))
    assert torch.equal(got, pb.pairhmm_scores_cuda(*(a.t() for a in t), pad=8))


@pytest.mark.parametrize("name,ints", [
    ("v11", (100, 0)), ("v11", (100, 1)), ("v13", (96, 6, 1)),
    ("v13", (96, 2, 3)), ("v13", (256, 3, 3)), ("v10", (100, 0)),
    ("v10", (96, 5)), ("v10", (256, 6))],
    ids=["v11-regs_ring_p4", "v11-regs_ring_p16", "v13-K6x2", "v13-shared_K2",
         "v13-no_such_K", "v10-regs_p16", "v10-tracks10_K8",
         "v10-no_such_variant"])
def test_refused_experiment_launches_raise(cuda, name, ints):
    """A launch the C entry point refuses (B not a multiple of the block's
    pairs, or no such instantiation) raises and is not counted."""
    from octopus_tpu_torch.kernel_experiments import _common as xc
    B = ints[0]
    t = xc.as_tracks(xc.parity_inputs(B, 5, rows=9), cuda)
    out = torch.empty(B, dtype=torch.int32, device=cuda)
    before = xc.COUNTS[name].launches
    ptrs = t + [None] * {"v11": 1, "v10": 3}.get(name, 0)
    with pytest.raises(RuntimeError, match="launch failed"):
        xc.launch(name, ptrs, out, (B, 9, 24, 8, 2) + ints[1:])
    assert xc.COUNTS[name].launches == before


@pytest.mark.parametrize("B", [128, 4098])
@pytest.mark.parametrize("pack", [2, 1])
@pytest.mark.parametrize("values", ["small", "wrapping"])
def test_i16_kernel_matches_its_plain_version(cuda, B, pack, values):
    """csrc/exp_i16.cu equals the probe's int16 function, sums wrapping."""
    from octopus_tpu_torch.kernel_experiments import i16_probe
    gen = torch.Generator(device=cuda).manual_seed(B)
    lo, hi = (0, 1000) if values == "small" else (-32768, 32767)
    a, b = (torch.randint(lo, hi, (16, B), generator=gen, device=cuda,
                          dtype=torch.int16) for _ in range(2))
    b[:, ::3] = a[:, ::3]
    got = i16_probe.run_cuda(a, b, pack=pack)
    torch.cuda.synchronize()
    assert torch.equal(got, i16_probe.kern_plain(a, b))
    assert int(i16_probe.run(torch.ones((16, 128), dtype=torch.int16),
                             torch.full((16, 128), 2, dtype=torch.int16),
                             pack=pack)[0, 0]) == 51
