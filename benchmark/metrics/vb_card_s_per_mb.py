"""Self seconds a called Mb of the VB evaluations routed to the card
(core/models/subclone_vb.py, mixture_mixture_vb.py): the vb_card phase
less its graph capture and its copies back; 0 where none ran there."""


def read(r):
    return r.self_s.get("vb_card", 0.0) / r.called_mb if r.called_mb else None
