"""Read-haplotype pairs a called Mb that the likelihood layer sent to the
card (likelihood_array.ROUTING)."""


def read(r):
    return r.routing["card_pairs"] / r.called_mb if r.called_mb else None
