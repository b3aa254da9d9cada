"""Genotype log-likelihood reductions over the read x haplotype matrix.

Capability-equivalent to ConstantMixtureGenotypeLikelihoodModel
(src/core/models/genotype/constant_mixture_genotype_likelihood_model.cpp):

    ln p(reads | g) = sum_r [ ln sum_{h in g} exp(lnL[h, r]) - ln ploidy ]

On the device the inner logsumexp becomes a matrix product: with per-read
maxima m_r = max_h lnL[h, r] and E = exp(lnL - m) (H, R), the per-genotype
mixture is C @ E where C is the (G, H) multiplicity matrix; then

    L[g] = sum_r (log (C @ E)[g, r] + m_r) - R * ln ploidy.

A float64 numpy path gives exact reference-parity values and takes every
reduction under ~1 MFLOP, where a device round trip costs more than the
work.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ...device import resolve_device
from ...utils import timers
from ..likelihood.likelihood_array import ROUTING
from ..types.genotypes import genotype_counts_matrix

# G * P * R below this runs on the host in float64
HOST_GATE = 1_000_000


@dataclass
class ReductionCounts:
    """Genotype reductions run on the host and on the device."""

    host: int = 0
    device: int = 0

    def reset(self) -> None:
        self.host = self.device = 0


COUNTS = ReductionCounts()


def genotype_log_likelihoods_np(lnL: np.ndarray, genotypes: np.ndarray,
                                chunk: int = 2048) -> np.ndarray:
    """Exact float64 host computation. lnL (H, R); genotypes (G, P).

    Chunked over genotypes: the (G, P, R) intermediate on a dense deep
    window (G ~ 20k, R ~ 20k) would otherwise be gigabytes."""
    G, P = genotypes.shape
    if P == 0:
        return np.zeros(G)
    out = np.empty(G)
    for lo in range(0, G, chunk):
        g = genotypes[lo:lo + chunk]
        sub = lnL[g]                          # (g, P, R)
        m = sub.max(axis=1)                   # (g, R)
        m_safe = np.where(np.isfinite(m), m, 0.0)
        s = np.exp(sub - m_safe[:, None, :]).sum(axis=1)
        per_read = m_safe + np.log(s) - np.log(P)
        per_read = np.where(np.isfinite(m), per_read, -np.inf)
        out[lo:lo + chunk] = per_read.sum(axis=1)
    return out


def genotype_log_likelihoods_torch(lnL: torch.Tensor, counts: torch.Tensor,
                                   ploidy: int) -> torch.Tensor:
    """float32 reduction on the tensors' device. lnL (H, R); counts (G, H).

    On the CPU, float32 exp and log are vb_math's (csrc/vb_host.cpp: the
    same bits whatever the threads). torch's own CPU exp gave a 128 x 319
    lnL other bits in some processes than in others, so the records of a
    --device cpu run were not reproducible. vb_math's exp flushes results
    below FLT_MIN to 0, so S is 0 or normal, and log(0) stays -inf."""
    m = torch.amax(lnL, dim=0)                               # (R,)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    if lnL.device.type == "cpu" and lnL.dtype == torch.float32:
        from .vb_math import fexp, flog
        E = fexp(lnL - m[None, :])                           # (H, R)
        S = torch.matmul(counts, E)                          # (G, R)
        log_S = torch.where(S > 0, flog(S), float("-inf"))
    else:
        E = torch.exp(lnL - m[None, :])
        S = torch.matmul(counts, E)
        log_S = torch.log(S)
    per_read = log_S + m[None, :] - float(np.log(ploidy))
    return torch.sum(per_read, dim=1)                        # (G,)


# The fewest elements (G * P * R, HOST_GATE's measure) a reduction holds
# before it shards over several cards; None shards none. Set from
# scripts/torch_shard_floor.py (PERF.md, Findings). A sharded reduction
# sums in other float32 order, so its bits depend on the card count.
SHARD_MIN_ELEMENTS: int | None = None


def _reduction_devices(elements: int, R: int,
                       device: torch.device) -> list[torch.device]:
    """The local cards a reduction of `elements` over R reads shards over;
    [device] alone means unsharded. A CUDA reduction of at least
    SHARD_MIN_ELEMENTS shards over all local cards (at most one a read),
    from `device` on, in near-equal parts of the reads: the reference pads
    the reads to a multiple of its device count and so always shards, and
    the port, which does not pad, splits unevenly instead.
    OCTOPUS_TPU_NO_SHARD=1 turns sharding off."""
    if (device.type != "cuda" or SHARD_MIN_ELEMENTS is None
            or elements < SHARD_MIN_ELEMENTS
            or os.environ.get("OCTOPUS_TPU_NO_SHARD") == "1"):
        return [device]
    n = min(torch.cuda.device_count(), R)
    if n <= 1:
        return [device]
    from ...parallel.sharding import make_mesh
    first = device.index if device.index is not None \
        else torch.cuda.current_device()
    return make_mesh(n, first)


def _genotype_lls_sharded(devices, lnL, counts, ploidy: int) -> torch.Tensor:
    """Reads split across `devices` in near-equal contiguous parts: each
    device computes the reference's per-shard partial (the maximum over
    haplotypes, exp, counts @ E, log plus the maximum, minus log P, summed
    over its reads), and the host sums the partials in device order, the
    port's psum. lnL (H, R), counts (G, H); (G,) float32 on the CPU."""
    lnL = torch.as_tensor(lnL, dtype=torch.float32)
    counts = torch.as_tensor(counts, dtype=torch.float32)
    partials = [genotype_log_likelihoods_torch(part.to(dev), counts.to(dev),
                                               ploidy)
                for part, dev in zip(torch.tensor_split(lnL, len(devices),
                                                        dim=1), devices)]
    total = partials[0].cpu()
    for partial in partials[1:]:
        total = total + partial.cpu()
    return total


def runs_on_device(lnL: np.ndarray, genotypes: np.ndarray,
                   use_device: bool = True) -> bool:
    """Whether genotype_log_likelihoods reduces these on its device (in
    float32) rather than exactly on the host."""
    G, P = genotypes.shape
    return (use_device and P > 0 and lnL.shape[1] > 0
            and G * P * lnL.shape[1] >= HOST_GATE)


def genotype_log_likelihoods(lnL: np.ndarray, genotypes: np.ndarray,
                             use_device: bool = True,
                             device: str | torch.device = "cuda") -> np.ndarray:
    """Genotype log-likelihoods: float32 on `device` (sharded over the
    reads on a host with several cards, from SHARD_MIN_ELEMENTS), or exact
    float64 on the host for small reductions and when use_device is
    False. The device branch is the genotype_card phase, from the counts
    matrix to the copy back; its shapes go to ROUTING.card_reductions.
    The host branch opens no phase."""
    G, P = genotypes.shape
    if P == 0 or lnL.shape[1] == 0:
        return np.zeros(G)
    if not runs_on_device(lnL, genotypes, use_device):
        COUNTS.host += 1
        return genotype_log_likelihoods_np(lnL, genotypes)
    dev = resolve_device(device)
    H, R = lnL.shape
    with timers.phase("genotype_card"):
        counts = genotype_counts_matrix(genotypes, H)
        devices = _reduction_devices(G * P * R, R, dev)
        if len(devices) > 1:
            out = _genotype_lls_sharded(devices, lnL, counts, int(P))
        else:
            out = genotype_log_likelihoods_torch(
                torch.as_tensor(lnL, dtype=torch.float32, device=dev),
                torch.as_tensor(counts, dtype=torch.float32, device=dev), int(P))
        out = out.double().cpu().numpy()
    COUNTS.device += 1
    ROUTING.record_card_reduction(G, H, R)
    return out


__all__ = ["genotype_log_likelihoods", "genotype_log_likelihoods_np",
           "genotype_log_likelihoods_torch", "runs_on_device", "COUNTS",
           "HOST_GATE"]
