"""Pruning rounds a called Mb that scored haplotype paths
(core/hapgen/beam.py `_prune_paths`, from the beam and the stateful
generator alike; likelihood_array.ROUTING.prune_rounds, reset before the
window). None on a program without the counter."""


def read(r):
    from octopus_tpu_torch.core.likelihood import likelihood_array
    value = getattr(getattr(likelihood_array, "ROUTING", None), "prune_rounds", None)
    return value / r.called_mb if value is not None and r.called_mb else None
