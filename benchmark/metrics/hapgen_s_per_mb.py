"""Self seconds a called Mb of the haplotype beam (core/hapgen/): the
hapgen_beam phase, 0 where no region outgrows --max-haplotypes."""


def read(r):
    return r.self_s.get("hapgen_beam", 0.0) / r.called_mb if r.called_mb else None
