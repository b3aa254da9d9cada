"""VB evaluations a called Mb that the host library ran in one native call
(subclone_vb.COUNTS.host_native, reset before the window): one a genotype
chunk of each host evaluation. None on a program without the counter."""


def read(r):
    from octopus_tpu_torch.core.models import subclone_vb
    value = getattr(getattr(subclone_vb, "COUNTS", None), "host_native", None)
    return value / r.called_mb if value is not None and r.called_mb else None
