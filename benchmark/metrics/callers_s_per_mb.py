"""Self seconds a called Mb of the caller loop (core/callers/): the calling
phase less the layers it calls."""


def read(r):
    return r.self_s.get("calling", 0.0) / r.called_mb if r.called_mb else None
