"""Self seconds a called Mb of candidate generation's host-extension call
(core/vargen/generator.py, generate_candidates: the CIGAR scan, its
grouping, depths and inclusion, and the reassembler); the vargen_native
phase, inside vargen. None on a program without the phase."""


def read(r):
    value = r.self_s.get("vargen_native")
    return value / r.called_mb if value is not None and r.called_mb else None
