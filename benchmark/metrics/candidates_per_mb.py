"""Candidate variants a called Mb that candidate generation (core/vargen/)
returned to the caller, over the window's windows
(likelihood_array.ROUTING.candidates, reset before the window): equal
counts on two programs show the same candidate lists' work. None on a
program without the counter."""


def read(r):
    from octopus_tpu_torch.core.likelihood import likelihood_array
    value = getattr(getattr(likelihood_array, "ROUTING", None), "candidates", None)
    return value / r.called_mb if value is not None and r.called_mb else None
