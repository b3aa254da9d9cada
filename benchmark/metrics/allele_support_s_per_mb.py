"""Self seconds a called Mb of CSR's allele support: the counting of the
reads that support each allele, tied reads of read assignment included,
once the assignment has run (the phase allele_support in
core/csr/facets.py, inside csr_measures). None on a program without the
phase."""


def read(r):
    value = r.self_s.get("allele_support")
    return value / r.called_mb if value is not None and r.called_mb else None
