"""Read-haplotype pairs a called Mb that the likelihood layer scored in the
host DP (likelihood_array.ROUTING)."""


def read(r):
    return r.routing["host_pairs"] / r.called_mb if r.called_mb else None
