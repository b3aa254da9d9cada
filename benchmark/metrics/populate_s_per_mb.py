"""Self seconds a called Mb of the likelihood populate
(core/likelihood/likelihood_array.py): likelihood_populate less the
pair-HMM phases inside it."""


def read(r):
    return r.self_s.get("likelihood_populate", 0.0) / r.called_mb if r.called_mb else None
