"""Two-level Dirichlet mixture VB: clones x haplotypes.

Capability-equivalent to the reference's VariationalBayesMixtureMixtureModel
(src/core/models/genotype/variational_bayes_mixture_mixture_model.{hpp,cpp}),
the engine behind SingleCellModel: each cell belongs to one of C clones
(mixture weights pi ~ Dirichlet(beta0), the phylogeny concentration), and a
clone's reads mix over the haplotypes of its genotype
(w_c ~ Dirichlet(alpha0), the dropout concentration).

Coordinate ascent (CAVI):
  read responsibilities    rho[n,c,m,r] ∝ exp(E ln w_cm) exp(lnL_n[m,r])
  cell responsibilities    tau[n,c]     ∝ exp(E ln pi_c + sum_r E-step score)
  Dirichlet updates        alpha_cm = alpha0 + sum_n tau_nc sum_r rho_ncmr
                           beta_c   = beta0 + sum_n tau_nc

Design: every seed at once, over (seed, cell, clone, member, read) tensors
padded to the largest clone (member mask) and the most reads of any cell
(read mask), on the caller's device; the iterations loop in Python. Padded
members and reads contribute exactly nothing. Small evaluations run on the
CPU by the gate of subclone_vb (vb_route), counted in its COUNTS.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...utils import timers
from .subclone_vb import e_ln_weights, evaluation_phase, host_arrays, vb_route
from .vb_math import flgamma, flog, fsoftmax, fsum

_NEG = -1e30


def vb_mixture_mixture(lnl: torch.Tensor, member_mask: torch.Tensor,
                       read_mask: torch.Tensor, alpha0: float,
                       beta0: torch.Tensor, tau_init: torch.Tensor,
                       n_iter: int = 60):
    """Every seed's CAVI run at once, each as the reference's _mmvb_single
    (mixture_mixture_vb.py:36-98) computes it, in vb_math's arithmetic.

    lnl: (N, C, M, R) member log-likelihoods per cell/clone (padded);
    member_mask: (C, M) 1 for real members; read_mask: (N, R);
    alpha0: scalar; beta0: (C,); tau_init: (S, N, C).
    Returns (elbo (S,), tau (S, N, C), alpha (S, C, M), beta (S, C))."""
    mm = member_mask[None, :, :, None] > 0                   # (1, C, M, 1)
    rm = read_mask[:, None, None, :]                         # (N, 1, 1, R)
    rmask = read_mask[None, :, None, :]                      # (1, N, 1, R)
    real = member_mask > 0                                   # (C, M)
    lnl_m = torch.where(mm, lnl, _NEG)[None]                 # (1, N, C, M, R)
    a0 = torch.tensor(alpha0, dtype=lnl.dtype, device=lnl.device)

    def read_responsibilities(e_ln_w_b):                     # (S, N, C, M, R)
        return fsoftmax(e_ln_w_b[:, None, :, :, None] + lnl_m, dim=3) * rm

    def entropy(p, dim):
        return -fsum(p * flog(torch.clamp(p, min=1e-30)), dim)

    S = tau_init.shape[0]
    tau = tau_init
    alpha = (a0 * member_mask + (1 - member_mask)).expand(S, -1, -1)
    beta = beta0 + fsum(tau_init, 1)                         # (S, C)
    for _ in range(n_iter):
        e_ln_w = torch.where(real, e_ln_weights(alpha), _NEG)
        rho = read_responsibilities(e_ln_w)
        read_score = fsum(rho * (lnl_m + e_ln_w[:, None, :, :, None]), 3)
        read_ent = entropy(rho, 3) * rmask
        cell_score = fsum((read_score + read_ent) * rmask, -1)   # (S, N, C)
        tau = fsoftmax(e_ln_weights(beta)[:, None, :] + cell_score, dim=2)
        # einsum("nc,ncmr->cm"): over reads, then over cells
        counts = fsum(fsum(tau[..., None, None] * rho, -1), 1)
        alpha = a0 + counts * member_mask
        beta = beta0 + fsum(tau, 1)

    # ELBO at the fixed point
    e_ln_w = torch.where(real, e_ln_weights(alpha), 0.0)
    rho = read_responsibilities(torch.where(real, e_ln_w, _NEG))
    read_ll = fsum(rho * torch.where(mm, lnl, 0.0)[None], 3)
    read_prior = fsum(rho * torch.where(mm, e_ln_w[:, None, :, :, None], 0.0), 3)
    read_ent = entropy(rho, 3)
    cell_score = fsum((read_ll + read_prior + read_ent) * rmask, -1)  # (S, N, C)
    e_ln_pi = e_ln_weights(beta)

    def total(x):                                            # over (N, C)
        return fsum(fsum(x, -1), -1)

    ll_term = total(tau * cell_score)
    z_prior = total(tau * e_ln_pi[:, None, :])
    z_ent = -total(tau * flog(torch.clamp(tau, min=1e-30)))
    nm = fsum(member_mask, -1)
    w_prior = fsum(flgamma(a0 * nm) - nm * flgamma(a0)
                   + fsum((a0 - 1) * e_ln_w * member_mask, -1), -1)
    w_ent = -fsum(flgamma(fsum(alpha * member_mask, -1))
                  - fsum(flgamma(torch.where(real, alpha, 1.0)) * member_mask,
                         -1)
                  + fsum((alpha - 1) * e_ln_w * member_mask, -1), -1)
    pi_prior = (flgamma(fsum(beta0, -1)) - fsum(flgamma(beta0), -1)
                + fsum((beta0 - 1) * e_ln_pi, -1))
    pi_ent = -(flgamma(fsum(beta, -1)) - fsum(flgamma(beta), -1)
               + fsum((beta - 1) * e_ln_pi, -1))
    elbo = ll_term + z_prior + z_ent + w_prior + w_ent + pi_prior + pi_ent
    return elbo, tau, alpha, beta


@dataclass
class MixtureMixtureInference:
    log_evidence: float
    cell_responsibilities: np.ndarray    # (N, C)
    map_assignments: np.ndarray          # (N,)
    alphas: np.ndarray                   # (C, M)


class VariationalBayesMixtureMixtureModel:
    """Clone-mixture-of-haplotype-mixtures over per-cell likelihoods."""

    def __init__(self, alpha0: float = 5.0, beta0: float = 20.0,
                 n_seeds: int = 3, n_iter: int = 60,
                 device: str | torch.device = "cuda"):
        self.alpha0 = alpha0     # dropout concentration
        self.beta0 = beta0       # phylogeny concentration
        self.n_seeds = n_seeds
        self.n_iter = n_iter
        self.device = device

    def evaluate(self, lnL_by_cell: list[np.ndarray],
                 clone_members: list[list[int]]) -> MixtureMixtureInference:
        """lnL_by_cell: per cell (H, R_n); clone_members: per clone the
        haplotype indices of its genotype."""
        N = len(lnL_by_cell)
        C = len(clone_members)
        M = max(len(m) for m in clone_members)
        R = max((l.shape[1] for l in lnL_by_cell), default=1) or 1
        lnl = np.zeros((N, C, M, R), np.float32)
        read_mask = np.zeros((N, R), np.float32)
        member_mask = np.zeros((C, M), np.float32)
        for c, members in enumerate(clone_members):
            member_mask[c, :len(members)] = 1.0
        for n, l in enumerate(lnL_by_cell):
            r = l.shape[1]
            read_mask[n, :r] = 1.0
            for c, members in enumerate(clone_members):
                for m, h in enumerate(members):
                    lnl[n, c, m, :r] = l[h]
        # seeds are per cell, so the read padding does not touch them
        rng = np.random.default_rng(0)
        taus = [np.full((N, C), 1.0 / C, np.float32)]
        for _ in range(self.n_seeds - 1):
            taus.append(rng.dirichlet(np.ones(C), size=N).astype(np.float32))
        beta0 = np.full(C, self.beta0 / C, np.float32)
        dev = vb_route(self.device, self.n_seeds * N * C * M * R)
        with timers.phase(evaluation_phase(dev)):
            elbos, tau_all, alpha_all, _ = vb_mixture_mixture(
                torch.as_tensor(lnl, device=dev),
                torch.as_tensor(member_mask, device=dev),
                torch.as_tensor(read_mask, device=dev), float(self.alpha0),
                torch.as_tensor(beta0, device=dev),
                torch.as_tensor(np.stack(taus), device=dev), n_iter=self.n_iter)
            elbos, tau_all, alpha_all = host_arrays(dev, elbos.double(),
                                                    tau_all, alpha_all)
        best = int(np.argmax(elbos))
        tau = tau_all[best]
        return MixtureMixtureInference(
            log_evidence=float(elbos[best]),
            cell_responsibilities=tau,
            map_assignments=np.argmax(tau, axis=1),
            alphas=alpha_all[best],
        )


__all__ = ["VariationalBayesMixtureMixtureModel", "MixtureMixtureInference",
           "vb_mixture_mixture"]
