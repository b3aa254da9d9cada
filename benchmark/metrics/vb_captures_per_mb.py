"""CUDA graphs a called Mb that the card's VB evaluations captured
(subclone_vb.COUNTS.captures, reset before the window): one a genotype
chunk of each card evaluation. None on a program without the counter."""


def read(r):
    from octopus_tpu_torch.core.models import subclone_vb
    value = getattr(getattr(subclone_vb, "COUNTS", None), "captures", None)
    return value / r.called_mb if value is not None and r.called_mb else None
