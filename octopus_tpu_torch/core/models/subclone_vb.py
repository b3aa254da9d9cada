"""Variational-Bayes Dirichlet mixture engine + subclone model.

Capability-equivalent to the reference's VB machinery
(src/core/models/genotype/variational_bayes_mixture_model.hpp:95-650) and
SubcloneModel (subclone_model.hpp:29-104): a genotype is a K-tuple of
haplotypes with unknown per-sample mixture weights; coordinate-ascent VB
infers read responsibilities (N x K) and Dirichlet weight posteriors, with
multi-seed restarts combined by evidence.

Design: one batched coordinate ascent over (genotype, seed, component,
read) tensors, G x S x K x N, on the caller's device. On a card the loop
over iterations runs in Python (vb_subclone_ops): n_iter rounds of
elementwise ops, a softmax over K and a sum over N, a CUDA graph of one
round replayed. On the CPU one call of csrc/vb_host.cpp's vb_subclone_host
runs the whole evaluation, rounds and ELBO, the same operations in the same
order (vb_subclone_ops is its fallback where g++ is missing; COUNTS counts
the native calls). Its arithmetic is vb_math's, which
gives the same bits on the CPU and on a card. Reads are not padded: the
seeds are drawn at the padded read count the reference package uses (the
ladder 32 * 4^k) and cut to the real reads, so every seed, and every
result, is the one that padding with masked reads would give.

Small evaluations run on the CPU, with the same result: `vb_device_min`
counts real elements G*S*K*N (or S*N*C*M*R for the mixture-mixture model)
and sends those below it to the host. Its default comes from
chip_smoke.py's vb_gate_sweep on an H100; OCTOPUS_TPU_VB_DEVICE_MIN
overrides it when set, and 0 sends every evaluation to the device. COUNTS
holds evaluations and elements on each side, the graphs captured and the
host's native calls.
An evaluation is timed as the vb_host or vb_card phase; on a card its
graph capture (vb_capture) and the copies back (vb_card_wait) nest in it.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from ...device import resolve_device
from ...utils import timers
from .individual import logsumexp
from .vb_math import (_host_library, fdigamma, fdot, flgamma, flog, fsoftmax,
                      fsum, fsum_xla)

# real elements (G*S*K*N) below which an evaluation asked for on a CUDA
# device runs on the CPU instead: chip_smoke.py's vb_gate_sweep on an H100
# (K = 3, 2 seeds, 40 iterations, 128 reads) found the card faster from
# 49,152 elements up (its crossover moves with the host's speed; the gate
# only routes, the bits are the same on both sides)
VB_DEVICE_MIN = 49_152
# elements of one (G-chunk, S, K, N) intermediate; --target-working-memory
# sets OCTOPUS_TPU_VB_BUDGET_ELEMS
VB_BUDGET_ELEMS = 64_000_000


@dataclass
class VbCounts:
    """VB evaluations and their elements, on the host and on the device,
    the CUDA graphs the device's evaluations captured, and the vb_subclone
    calls the host library ran (host_native)."""

    host: int = 0
    device: int = 0
    host_elements: int = 0
    device_elements: int = 0
    captures: int = 0
    host_native: int = 0

    def reset(self) -> None:
        self.host = self.device = self.captures = self.host_native = 0
        self.host_elements = self.device_elements = 0


COUNTS = VbCounts()


def vb_device_min() -> int:
    value = os.environ.get("OCTOPUS_TPU_VB_DEVICE_MIN")
    return VB_DEVICE_MIN if value is None else int(value)


def vb_route(device: str | torch.device, elements: int) -> torch.device:
    """The device an evaluation of `elements` real elements runs on, counted.
    `device` is resolved first, so a CUDA device without a card raises
    even when the evaluation is small enough for the host."""
    dev = resolve_device(device)
    if dev.type == "cuda" and elements < vb_device_min():
        dev = torch.device("cpu")
    if dev.type == "cuda":
        COUNTS.device += 1
        COUNTS.device_elements += elements
    else:
        COUNTS.host += 1
        COUNTS.host_elements += elements
    return dev


def evaluation_phase(dev: torch.device) -> str:
    """The timers phase of an evaluation routed to `dev`."""
    return "vb_card" if dev.type == "cuda" else "vb_host"


def host_arrays(dev: torch.device, *tensors) -> list:
    """`tensors` as NumPy arrays. On a card the first copy waits for the
    evaluation to finish, timed as the vb_card_wait phase."""
    if dev.type != "cuda":
        return [t.cpu().numpy() for t in tensors]
    with timers.phase("vb_card_wait"):
        return [t.cpu().numpy() for t in tensors]


def e_ln_weights(conc: torch.Tensor) -> torch.Tensor:
    """E[ln w] of Dirichlet(conc) weights over the last axis: digamma of
    each concentration less digamma of their sum."""
    d = fdigamma(torch.cat([conc, fsum(conc, -1, keepdim=True)], -1))
    return d[..., :-1] - d[..., -1:]


def vb_subclone(lnl: torch.Tensor, alpha0: torch.Tensor,
                resp_init: torch.Tensor, n_iter: int = 50):
    """Every (genotype, seed) VB run at once.

    lnl (G, K, N) component log-likelihoods of each genotype's reads;
    alpha0 (K,) prior concentrations; resp_init (S, K, N) seed
    responsibilities. Returns (elbo (G, S), alpha (G, S, K),
    responsibilities (G, S, K, N)), each run as the reference's _vb_single
    (subclone_vb.py:29-67) computes it, in vb_math's arithmetic.

    On the CPU, float32 and with the host library built, one call of
    csrc/vb_host.cpp's vb_subclone_host runs the whole evaluation
    (COUNTS.host_native); otherwise vb_subclone_ops, to the same bits."""
    out = _vb_subclone_host(lnl, alpha0, resp_init, n_iter)
    if out is None:
        return vb_subclone_ops(lnl, alpha0, resp_init, n_iter)
    return out


def _vb_subclone_host(lnl: torch.Tensor, alpha0: torch.Tensor,
                      resp_init: torch.Tensor, n_iter: int):
    """vb_subclone in one call of the host library, or None where the
    tensors are not float32 CPU tensors of vb_subclone's shapes or the
    library is not built."""
    tensors = (lnl, alpha0, resp_init)
    if any(t.device.type != "cpu" or t.dtype != torch.float32
           for t in tensors) or lnl.dim() != 3:
        return None
    G, K, N = lnl.shape
    S = resp_init.shape[0]
    if K < 1 or alpha0.shape != (K,) or resp_init.shape != (S, K, N):
        return None
    lib = _host_library()
    if lib is None:
        return None
    lnl, alpha0, resp_init = (t.contiguous() for t in tensors)
    elbo = torch.empty(G, S)
    alpha = torch.empty(G, S, K)
    resp = torch.empty(G, S, K, N)
    lib.vb_subclone_host(lnl.data_ptr(), alpha0.data_ptr(),
                         resp_init.data_ptr(), elbo.data_ptr(),
                         alpha.data_ptr(), resp.data_ptr(), G, S, K, N,
                         int(n_iter), torch.get_num_threads())
    COUNTS.host_native += 1
    return elbo, alpha, resp


def vb_subclone_ops(lnl: torch.Tensor, alpha0: torch.Tensor,
                    resp_init: torch.Tensor, n_iter: int = 50):
    """vb_subclone in torch operations, the form a card runs."""
    lnl4 = lnl[:, None]                                   # (G, 1, K, N)

    def step(alpha):
        resp = fsoftmax(e_ln_weights(alpha)[..., None] + lnl4, dim=-2)
        return alpha0 + fsum_xla(resp), resp               # (G, S, K)

    resp = resp_init
    alpha = alpha0 + fsum_xla(resp_init)                  # (S, K)
    # on a card a round is a few hundred small launches: after two eager
    # rounds (the first broadcasts (S, K) to (G, S, K)) the rest replay one
    # captured round, the same kernels on the same shapes, so the same bits
    eager = min(n_iter, 2) if lnl.is_cuda else n_iter
    for _ in range(eager):
        alpha, resp = step(alpha)
    if eager < n_iter:
        # captured on a side stream without torch.cuda.graph's synchronize,
        # gc.collect and empty_cache, which would cost more than the launches
        alpha = alpha.clone()
        with timers.phase("vb_capture"):
            graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream(lnl.device)
            side.wait_stream(torch.cuda.current_stream(lnl.device))
            with torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode="thread_local")
                new_alpha, resp = step(alpha)
                alpha.copy_(new_alpha)
                graph.capture_end()
        COUNTS.captures += 1
        torch.cuda.current_stream(lnl.device).wait_stream(side)
        for _ in range(n_iter - eager):
            graph.replay()
    G, S = lnl.shape[0], resp_init.shape[0]
    resp = resp.expand(G, S, *resp.shape[-2:])
    alpha = alpha.expand(G, S, alpha.shape[-1])
    e_ln_w = e_ln_weights(alpha)

    def total(a, b):                      # sum over (K, N) of a * b
        # XLA:CPU reduces the reference's 32 padded reads with the product
        # fused into the loop (a multiply-add a step), more in windows of
        # the product
        if 0 < a.shape[-1] <= 32:
            return fdot(a.flatten(-2), b.flatten(-2))
        return fsum_xla(a * b, 2)

    ll_term = total(resp, lnl4.expand_as(resp))
    z_prior = total(resp, e_ln_w[..., None].expand_as(resp))
    z_entropy = -total(resp, flog(torch.clamp(resp, min=1e-30)))
    w_prior = (flgamma(fsum(alpha0, -1)) - fsum(flgamma(alpha0), -1)
               + fdot((alpha0 - 1).expand_as(e_ln_w), e_ln_w))
    w_entropy = -(flgamma(fsum(alpha, -1)) - fsum(flgamma(alpha), -1)
                  + fdot(alpha - 1, e_ln_w))
    elbo = ll_term + z_prior + z_entropy + w_prior + w_entropy
    return elbo, alpha, resp


def reference_read_rung(n: int) -> int:
    """The padded read count the seeds are drawn at: 32 * 4^k >= n."""
    rung = 32
    while rung < n:
        rung *= 4
    return rung


@functools.lru_cache(maxsize=64)
def _seed_table(K: int, rung: int, n_seeds: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    seeds = [np.full((K, rung), 1.0 / K, np.float32)]
    for _ in range(n_seeds - 1):
        seeds.append(rng.dirichlet(np.ones(K), size=rung).astype(np.float32).T)
    table = np.stack(seeds)
    table.setflags(write=False)          # shared by every caller
    return table


def subclone_seeds(K: int, N: int, n_seeds: int) -> np.ndarray:
    """(S, K, N) seed responsibilities: uniform, then one Dirichlet draw per
    extra seed, drawn at the padded read count and cut to the N real reads
    (the draws beyond the first depend on the padded count)."""
    return _seed_table(K, reference_read_rung(N), n_seeds)[:, :, :N]


@dataclass
class SubcloneInference:
    genotype_log_evidences: np.ndarray   # (G,) approximate ln evidence
    genotype_posteriors: np.ndarray      # (G,)
    map_alphas: np.ndarray               # (G, K) weight posteriors
    log_evidence: float                  # ln sum over genotypes + priors


class SubcloneModel:
    """Dirichlet-mixture-of-haplotypes model over candidate K-tuples."""

    def __init__(self, prior_model=None, alpha0: float = 1.0, n_seeds: int = 3,
                 n_iter: int = 50, device: str | torch.device = "cuda"):
        self.prior_model = prior_model
        self.alpha0 = alpha0
        self.n_seeds = n_seeds
        self.n_iter = n_iter
        self.device = device

    def evaluate(self, tuples: np.ndarray, lnL: np.ndarray,
                 alpha0_vec: np.ndarray | None = None,
                 log_priors: np.ndarray | None = None) -> SubcloneInference:
        """tuples: (G, K) haplotype index tuples; lnL: (H, N)."""
        G, K = tuples.shape
        N = lnL.shape[1]
        S = self.n_seeds
        if alpha0_vec is None:
            alpha0_vec = np.full(K, self.alpha0, np.float32)
        dev = vb_route(self.device, G * S * K * N)
        with timers.phase(evaluation_phase(dev)):
            budget = int(os.environ.get("OCTOPUS_TPU_VB_BUDGET_ELEMS",
                                        VB_BUDGET_ELEMS))
            # genotype rows are independent: chunk them so the (Gc, S, K, N)
            # intermediates stay within the budget
            gchunk = max(1, budget // max(S * K * N, 1))
            lnl32 = np.asarray(lnL, np.float32)
            seeds = torch.tensor(subclone_seeds(K, N, S), device=dev)
            a0 = torch.as_tensor(np.asarray(alpha0_vec, np.float32), device=dev)
            elbo_parts, alpha_parts = [], []
            for lo in range(0, G, gchunk):
                # gather on the host: one (Gc, K, N) copy to the device
                lnl_gkn = torch.as_tensor(lnl32[tuples[lo:lo + gchunk]],
                                          device=dev)
                e, al, _ = vb_subclone(lnl_gkn, a0, seeds, n_iter=self.n_iter)
                e, al = host_arrays(dev, e.double(), al)
                elbo_parts.append(e)
                alpha_parts.append(al)
            elbos = np.concatenate(elbo_parts)
            alphas = np.concatenate(alpha_parts)
            best_seed = np.argmax(elbos, axis=1)
            gle = elbos[np.arange(G), best_seed]
            map_alphas = alphas[np.arange(G), best_seed]
            if log_priors is None and self.prior_model is not None:
                log_priors = self.prior_model.evaluate_many(tuples)
            if log_priors is None:
                log_priors = np.zeros(G)
            joint = gle + log_priors
            log_evidence = logsumexp(joint)
            post = np.exp(joint - log_evidence)
        return SubcloneInference(
            genotype_log_evidences=gle,
            genotype_posteriors=post,
            map_alphas=map_alphas,
            log_evidence=log_evidence,
        )


__all__ = ["SubcloneModel", "SubcloneInference", "vb_subclone",
           "vb_subclone_ops",
           "subclone_seeds", "vb_route", "evaluation_phase", "host_arrays",
           "COUNTS", "VB_DEVICE_MIN"]
