"""Self seconds a called Mb of the active regions' own work in the caller
loop (core/callers/base.py): the active_region phase less the layers it
calls (haplotypes, likelihoods, models)."""


def read(r):
    return r.self_s.get("active_region", 0.0) / r.called_mb if r.called_mb else None
