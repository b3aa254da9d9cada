"""Tied reads a called Mb that CSR's allele depth credited to an allele,
every haplotype the read ties on carrying it
(likelihood_array.ROUTING.tied_reads_credited, reset before the window).
None on a program without the counter."""


def read(r):
    from octopus_tpu_torch.core.likelihood import likelihood_array
    value = getattr(getattr(likelihood_array, "ROUTING", None),
                    "tied_reads_credited", None)
    return value / r.called_mb if value is not None and r.called_mb else None
