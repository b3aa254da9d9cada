"""Jobs (read, haplotype, anchor) a called Mb that the likelihood layer's
naive shortcuts resolved without a scorer
(likelihood_array.ROUTING.shortcut_pairs, reset before the window). None
on a program without the counter."""


def read(r):
    from octopus_tpu_torch.core.likelihood import likelihood_array
    value = getattr(getattr(likelihood_array, "ROUTING", None), "shortcut_pairs", None)
    return value / r.called_mb if value is not None and r.called_mb else None
