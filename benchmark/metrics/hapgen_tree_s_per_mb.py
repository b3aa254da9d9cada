"""Self seconds a called Mb of the stateful haplotype generator
(core/hapgen/haplotype_generator.py): the hapgen_tree phase around each
`generate()` of core/callers/base.py's `_call_with_generator` (the walker,
holdout, path extension, lagging, Haplotype.build and the pruning rounds'
populate outside its own phases); 0 where no region outgrew the direct
enumeration. None on a program without the phase, which has no
ROUTING.hapgen_packets either."""


def read(r):
    from octopus_tpu_torch.core.likelihood import likelihood_array
    if getattr(getattr(likelihood_array, "ROUTING", None), "hapgen_packets",
               None) is None or not r.called_mb:
        return None
    return r.self_s.get("hapgen_tree", 0.0) / r.called_mb
