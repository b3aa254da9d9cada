"""Genotype reductions a called Mb that the individual model ran on the
card in float32 (core/models/genotype_likelihoods.py, at or above its
HOST_GATE; genotype_likelihoods.COUNTS.device, reset before the window).
None on a program without the counter."""


def read(r):
    from octopus_tpu_torch.core.models import genotype_likelihoods
    value = getattr(getattr(genotype_likelihoods, "COUNTS", None), "device", None)
    return value / r.called_mb if value is not None and r.called_mb else None
