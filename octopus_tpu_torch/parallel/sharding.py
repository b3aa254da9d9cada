"""Sharding of the compute core over the local devices — public API.

The reference shards over a 1-D JAX mesh; the port's counterpart of a mesh
is a list of local torch devices, and the same two product paths run over
it:

* the pair-HMM batch, data-parallel: pairs are independent, so the batch
  splits into contiguous shards, one per device, each scored by the kernel
  `scorer_name` picks on that device; the host gathers the scores in shard
  order (core/likelihood/pairhmm_batch.py:_pairhmm_scores_sharded);
* the genotype-likelihood reduction with READS across devices: each device
  computes the per-genotype partial over its reads, and the partials are
  summed in device order, the port's psum
  (core/models/genotype_likelihoods.py:_genotype_lls_sharded).

This module only names the device list and delegates to those two
functions, so tests and chip_smoke.py exercise the code the product runs.
Multi-host runs shard genome windows across hosts (parallel/work_queue.py)
and use this within each host's cards.
"""

from __future__ import annotations

import torch


def make_mesh(n_devices: int | None = None,
              first: int = 0) -> list[torch.device]:
    """`n_devices` local CUDA cards (all by default) from card `first` on,
    wrapping round, so a caller's own card takes the first shard. Never
    falls back to the CPU: without CUDA this raises; a CPU caller passes its
    own list, e.g. [torch.device("cpu")] * 4."""
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("make_mesh needs CUDA cards and found none; pass "
                           "an explicit device list to run on the CPU")
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"{n} cards asked for, {count} visible")
    return [torch.device("cuda", (first + i) % count) for i in range(n)]


def sharded_pairhmm_scores(devices, tgt, qual, win, opn, ext, mask, prior, *,
                           pad=8, nuc_prior=None) -> torch.Tensor:
    """Batch-sharded pair-HMM scores over `devices` (product path): (B,)
    int32 on the host. B need not divide by the device count: the shards
    are near-equal contiguous parts."""
    from ..core.likelihood.pairhmm_batch import (DEFAULT_NUC_PRIOR,
                                                 _pairhmm_scores_sharded)
    return _pairhmm_scores_sharded(
        list(devices), tgt, qual, win, opn, ext, mask, prior, pad=pad,
        nuc_prior=DEFAULT_NUC_PRIOR if nuc_prior is None else nuc_prior)


def sharded_genotype_step(devices, lnL, counts, ploidy: int) -> torch.Tensor:
    """Genotype log-likelihoods (G,) float32 on the host, with the reads of
    lnL (H, R) split across `devices` and counts (G, H) on each (product
    path)."""
    from ..core.models.genotype_likelihoods import _genotype_lls_sharded
    return _genotype_lls_sharded(list(devices), lnL, counts, int(ploidy))


__all__ = ["make_mesh", "sharded_pairhmm_scores", "sharded_genotype_step"]
