"""Self seconds a called Mb of the likelihood layer's job gathering
(core/likelihood/likelihood_array.py): penalties, k-mer indices, cache
keys and lookups, read hashes and anchor mapping; the populate_jobs phase."""


def read(r):
    return r.self_s.get("populate_jobs", 0.0) / r.called_mb if r.called_mb else None
