"""VB evaluations a called Mb that vb_route sent to the host
(subclone_vb.COUNTS.host, reset before the window). None on a program
without the counter."""


def read(r):
    from octopus_tpu_torch.core.models import subclone_vb
    value = getattr(getattr(subclone_vb, "COUNTS", None), "host", None)
    return value / r.called_mb if value is not None and r.called_mb else None
