"""Self seconds a called Mb of candidate generation (core/vargen/): the
vargen phase."""


def read(r):
    return r.self_s.get("vargen", 0.0) / r.called_mb if r.called_mb else None
