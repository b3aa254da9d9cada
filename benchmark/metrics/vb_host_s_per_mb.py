"""Self seconds a called Mb of the VB evaluations routed to the host
(core/models/subclone_vb.py, mixture_mixture_vb.py): the vb_host phase,
from just after vb_route to the evaluation's end."""


def read(r):
    return r.self_s.get("vb_host", 0.0) / r.called_mb if r.called_mb else None
