"""The port's VB engines against the reference's, on the CPU.

Subclone VB: the batched `vb_subclone` over (genotype, seed) against the
reference's `_vb_single` run per pair at the reference's own padded read
count, and `SubcloneModel.evaluate` against the reference's. The seeds
must be the reference's exactly; ELBO and alphas agree within 1e-5
relative (or 1e-5 absolute below 1), responsibilities within 1e-5
absolute. Mixture-mixture VB: `evaluate` and the per-seed engine against
the reference's, at the same tolerances, with ragged reads per cell and
ragged members per clone.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from octopus_tpu.core.models import mixture_mixture_vb as ref_mm
from octopus_tpu.core.models import subclone_vb as ref_vb
from octopus_tpu_torch.core.models import mixture_mixture_vb as mm
from octopus_tpu_torch.core.models import subclone_vb as vb

TOL = 1e-5

# Dirichlet concentrations the callers use: cancer tumour (germline 1.5,
# somatic 1.0), cancer normal (50, somatic 0.05), CNV normal and tumour,
# polyclone's clone concentration
CONCENTRATIONS = {
    "cancer_tumour": lambda K: [1.5] * (K - 1) + [1.0],
    "cancer_normal": lambda K: [50.0] * (K - 1) + [0.05],
    "cnv_normal": lambda K: [50.0] * K,
    "cnv_tumour": lambda K: [0.5] * K,
    "polyclone": lambda K: [1.0] * K,
}

# (K, N, G, seeds, concentration, n_iter); N off the 32 * 4^k ladder
ENGINE_CASES = [
    (2, 5, 1, 2, "cnv_tumour", 40),
    (2, 33, 3, 2, "cnv_normal", 40),
    (3, 200, 4, 2, "cancer_tumour", 40),
    (3, 200, 2, 2, "cancer_normal", 40),
    (3, 600, 3, 3, "polyclone", 50),
    (4, 33, 5, 3, "polyclone", 50),
    (4, 600, 2, 3, "cancer_tumour", 40),
    (2, 129, 6, 3, "cancer_normal", 50),
]


def close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.all(np.abs(got - want) <= tol * np.maximum(np.abs(want), 1.0))


def reference_seeds(K, N, n_seeds):
    """The seeds as the reference's _evaluate_inner draws them (:170-176)."""
    Np = 32
    while Np < N:
        Np *= 4
    rng = np.random.default_rng(0)
    seeds = [np.full((K, Np), 1.0 / K, np.float32)]
    for _ in range(n_seeds - 1):
        seeds.append(rng.dirichlet(np.ones(K), size=Np).astype(np.float32).T)
    return np.stack(seeds), Np


def component_lnl(rng, K, N):
    """Reads drawn from a few components with read-level noise."""
    lnl = -rng.exponential(2.0, (K, N))
    src = rng.integers(0, K, N)
    lnl[src, np.arange(N)] = -rng.exponential(0.1, N)
    return lnl.astype(np.float32)


@pytest.mark.parametrize("K,N,G,S,conc,n_iter", ENGINE_CASES)
def test_subclone_engine_matches_reference_runs(K, N, G, S, conc, n_iter):
    rng = np.random.default_rng(K * 1000 + N + G)
    lnl = np.stack([component_lnl(rng, K, N) for _ in range(G)])   # (G, K, N)
    a0 = np.asarray(CONCENTRATIONS[conc](K), np.float32)
    ref_seeds, Np = reference_seeds(K, N, S)
    seeds = vb.subclone_seeds(K, N, S)
    assert np.array_equal(seeds, ref_seeds[:, :, :N])
    elbo, alpha, resp = vb.vb_subclone(
        torch.from_numpy(lnl), torch.from_numpy(a0),
        torch.from_numpy(np.ascontiguousarray(seeds)), n_iter=n_iter)
    assert elbo.shape == (G, S) and alpha.shape == (G, S, K)
    assert resp.shape == (G, S, K, N)
    mask = np.zeros(Np, np.float32)
    mask[:N] = 1.0
    for g in range(G):
        lnl_pad = np.zeros((K, Np), np.float32)
        lnl_pad[:, :N] = lnl[g]
        for s in range(S):
            e, al, r = ref_vb._vb_single(
                jnp.asarray(lnl_pad), jnp.asarray(a0),
                jnp.asarray(ref_seeds[s]), n_iter=n_iter,
                mask_n=jnp.asarray(mask))
            r = np.asarray(r)
            assert np.all(r[:, N:] == 0.0)      # padded reads add nothing
            assert close(elbo[g, s], float(e)), (g, s, float(elbo[g, s]), float(e))
            assert close(alpha[g, s], np.asarray(al))
            assert np.abs(resp[g, s].numpy() - r[:, :N]).max() <= TOL


EVALUATE_CASES = [
    # (H, K, N, G, seeds, concentration, with priors)
    (4, 2, 5, 6, 2, "cnv_normal", False),
    (5, 3, 33, 10, 2, "cancer_tumour", True),
    (5, 3, 200, 10, 2, "cancer_normal", False),
    (6, 3, 600, 20, 3, "polyclone", True),
    (6, 4, 150, 15, 3, "polyclone", True),
    (3, 2, 0, 3, 2, "cnv_tumour", False),
]


@pytest.mark.parametrize("H,K,N,G,S,conc,priors", EVALUATE_CASES)
def test_subclone_model_evaluate_matches_reference(H, K, N, G, S, conc,
                                                   priors):
    rng = np.random.default_rng(H * 100 + K * 10 + N)
    lnL = -rng.exponential(2.5, (H, N))
    if N:
        lnL[rng.integers(0, H, N), np.arange(N)] = -0.05
    tuples = np.stack([rng.choice(H, K, replace=False) for _ in range(G)])
    a0 = np.asarray(CONCENTRATIONS[conc](K), np.float32)
    log_priors = -rng.exponential(3.0, G) if priors else None
    n_iter = 40 if S == 2 else 50
    want = ref_vb.SubcloneModel(n_seeds=S, n_iter=n_iter).evaluate(
        tuples, lnL, alpha0_vec=a0, log_priors=log_priors)
    got = vb.SubcloneModel(n_seeds=S, n_iter=n_iter, device="cpu").evaluate(
        tuples, lnL, alpha0_vec=a0, log_priors=log_priors)
    assert close(got.genotype_log_evidences, want.genotype_log_evidences)
    assert close(got.map_alphas, want.map_alphas)
    assert close(got.log_evidence, want.log_evidence)
    # a log posterior is a difference of two evidences, each within TOL
    # of its magnitude
    scale = max(np.abs(want.genotype_log_evidences).max(), 1.0)
    assert np.abs(np.log(got.genotype_posteriors)
                  - np.log(want.genotype_posteriors)).max() <= 2 * TOL * scale
    assert got.genotype_posteriors.sum() == pytest.approx(1.0, abs=1e-9)


def test_genotype_chunks_do_not_change_results(monkeypatch):
    rng = np.random.default_rng(5)
    lnL = -rng.exponential(2.0, (5, 90))
    tuples = np.stack([rng.choice(5, 3, replace=False) for _ in range(9)])
    model = vb.SubcloneModel(n_seeds=2, n_iter=40, device="cpu")
    whole = model.evaluate(tuples, lnL)
    monkeypatch.setenv("OCTOPUS_TPU_VB_BUDGET_ELEMS", str(2 * 3 * 90 * 2))
    chunked = model.evaluate(tuples, lnL)
    # rows are independent, and vb_math reduces each in a fixed order
    assert np.array_equal(chunked.genotype_log_evidences,
                          whole.genotype_log_evidences)
    assert np.array_equal(chunked.map_alphas, whole.map_alphas)


def test_vb_gate_counts_and_never_falls_back(monkeypatch):
    vb.COUNTS.reset()
    assert vb.vb_route("cpu", 10).type == "cpu"
    assert (vb.COUNTS.host, vb.COUNTS.host_elements) == (1, 10)
    monkeypatch.setenv("OCTOPUS_TPU_VB_DEVICE_MIN", "0")
    assert vb.vb_device_min() == 0
    monkeypatch.delenv("OCTOPUS_TPU_VB_DEVICE_MIN")
    assert vb.vb_device_min() == vb.VB_DEVICE_MIN
    if not torch.cuda.is_available():
        # a small evaluation asked for on a missing card raises; it does
        # not run on the host instead
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            vb.vb_route("cuda", 1)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            vb.SubcloneModel().evaluate(np.array([[0, 1]]),
                                        np.zeros((2, 4)))
    assert vb.COUNTS.device == 0


def cells_and_clones(rng, n_cells, reads, members, H=5):
    lnL = []
    for n in range(n_cells):
        R = reads[n % len(reads)]
        l = -rng.exponential(2.0, (H, R))
        if R:
            l[rng.integers(0, H, R), np.arange(R)] = -0.1
        lnL.append(l)
    return lnL, members


MM_CASES = [
    # (cells, reads per cell (cycled), clone members, seeds, n_iter)
    (3, [40, 17, 60], [[0, 1]], 3, 60),
    (4, [25, 0, 33, 12], [[0, 1], [0, 1, 2]], 3, 60),
    (6, [15, 30], [[0, 1], [0, 1, 3], [0, 1, 3, 4]], 3, 60),
    (5, [130, 8, 44], [[0, 2], [0, 2, 4]], 4, 60),
    (2, [50, 70], [[1, 2], [1, 2, 3]], 2, 30),
]


@pytest.mark.parametrize("n_cells,reads,members,S,n_iter", MM_CASES)
def test_mixture_mixture_evaluate_matches_reference(n_cells, reads, members,
                                                    S, n_iter):
    rng = np.random.default_rng(n_cells * 7 + len(members))
    lnL, members = cells_and_clones(rng, n_cells, reads, members)
    want = ref_mm.VariationalBayesMixtureMixtureModel(
        n_seeds=S, n_iter=n_iter).evaluate(lnL, members)
    got = mm.VariationalBayesMixtureMixtureModel(
        n_seeds=S, n_iter=n_iter, device="cpu").evaluate(lnL, members)
    assert close(got.log_evidence, want.log_evidence)
    assert np.abs(got.cell_responsibilities
                  - want.cell_responsibilities).max() <= TOL
    assert close(got.alphas, want.alphas)
    assert np.array_equal(got.map_assignments, want.map_assignments)


@pytest.mark.parametrize("n_cells,reads,members,S,n_iter", MM_CASES[:3])
def test_mixture_mixture_engine_matches_reference_seeds(n_cells, reads,
                                                        members, S, n_iter):
    """Every seed's run, against _mmvb_single at the reference's own read
    padding (the 32 * 4^k ladder); the port pads to the most reads of any
    cell, and padded members and reads add nothing to either."""
    rng = np.random.default_rng(n_cells * 7 + len(members))
    lnL, members = cells_and_clones(rng, n_cells, reads, members)
    C, M = len(members), max(len(m) for m in members)
    R = max(l.shape[1] for l in lnL)

    def tensors(Rp):
        lnl = np.zeros((n_cells, C, M, Rp), np.float32)
        read_mask = np.zeros((n_cells, Rp), np.float32)
        member_mask = np.zeros((C, M), np.float32)
        for c, ms in enumerate(members):
            member_mask[c, :len(ms)] = 1.0
        for n, l in enumerate(lnL):
            read_mask[n, :l.shape[1]] = 1.0
            for c, ms in enumerate(members):
                for m, h in enumerate(ms):
                    lnl[n, c, m, :l.shape[1]] = l[h]
        return lnl, member_mask, read_mask

    seeds_rng = np.random.default_rng(0)
    taus = [np.full((n_cells, C), 1.0 / C, np.float32)]
    for _ in range(S - 1):
        taus.append(seeds_rng.dirichlet(np.ones(C), size=n_cells)
                    .astype(np.float32))
    beta0 = np.full(C, 20.0 / C, np.float32)
    elbo, tau, alpha, beta = mm.vb_mixture_mixture(
        *(torch.from_numpy(a) for a in tensors(R)), 5.0,
        torch.from_numpy(beta0), torch.from_numpy(np.stack(taus)),
        n_iter=n_iter)
    Rp = 32
    while Rp < R:
        Rp *= 4
    ref_in = [jnp.asarray(a) for a in tensors(Rp)]
    for s in range(S):
        e, t, al, be = ref_mm._mmvb_single(
            *ref_in, jnp.float32(5.0), jnp.asarray(beta0),
            jnp.asarray(taus[s]), n_iter=n_iter)
        assert close(elbo[s], float(e))
        assert np.abs(tau[s].numpy() - np.asarray(t)).max() <= TOL
        assert close(alpha[s], np.asarray(al))
        assert close(beta[s], np.asarray(be))


def ulps(got, want):
    want32 = np.asarray(want, np.float32)
    return (np.abs(np.asarray(got, np.float64) - want)
            / np.spacing(np.abs(want32)).astype(np.float64))


@pytest.mark.parametrize("fn", ["fexp", "flog", "flgamma", "fdigamma"])
def test_vb_math_matches_float64(fn):
    """vb_math's functions against float64 on the domain the engines use:
    exp and log within 3 float32 ulps; lgamma and digamma within the error
    of the reference's own float32 Lanczos forms (XLA's), 1e-5 relative
    (1e-5 absolute below 1) and 2e-5 absolute near digamma's pole."""
    import scipy.special as sp
    from octopus_tpu_torch.core.models import vb_math
    rng = np.random.default_rng(11)
    if fn == "fexp":
        x = -np.concatenate([rng.exponential(8.0, 20000),
                             rng.uniform(0, 1e-3, 2000)])
        want = np.exp
    elif fn == "flog":
        x = np.exp(rng.uniform(-69, 69, 20000))
        want = np.log
    else:
        x = np.exp(rng.uniform(np.log(0.02), np.log(5000), 20000))
        want = sp.gammaln if fn == "flgamma" else sp.digamma
    x = x.astype(np.float32)
    got = getattr(vb_math, fn)(torch.from_numpy(x)).numpy()
    ref = want(x.astype(np.float64))
    if fn in ("fexp", "flog"):
        keep = ref != 0
        assert ulps(got[keep], ref[keep]).max() <= 3
    else:
        tol = np.where(x < 0.5, 2e-5, 1e-5) * np.maximum(np.abs(ref), 1.0)
        assert np.all(np.abs(got - ref) <= tol)
    if fn == "fexp":
        assert vb_math.fexp(torch.tensor([-90.0, -1e30])).tolist() == [0, 0]


@pytest.mark.parametrize("n", [1, 3, 8, 9, 200, 1024])
def test_fsum_is_a_fixed_order_sum(n):
    from octopus_tpu_torch.core.models.vb_math import fsum
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (4, n, 3)).astype(np.float32))
    got = fsum(x, 1)
    assert got.shape == (4, 3)
    assert torch.allclose(got.double(), x.double().sum(1), atol=1e-5)
    # a row's sum does not depend on the rows beside it
    assert torch.equal(fsum(x[1:2], 1), got[1:2])
    assert fsum(x, 1, keepdim=True).shape == (4, 1, 3)
