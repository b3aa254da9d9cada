"""Self seconds a called Mb of call set refinement and read assignment
(core/csr/, core/tools/read_assigner.py): csr_facets, csr_measures and
read_assignment."""


def read(r):
    if not r.called_mb:
        return None
    return sum(r.self_s.get(k, 0.0) for k in
               ("csr_facets", "csr_measures", "read_assignment")) / r.called_mb
