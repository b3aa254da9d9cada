"""Self seconds a called Mb of the individual model's genotype reductions
on the card (core/models/genotype_likelihoods.py): the genotype_card
phase, inside infer_latents, from the counts matrix to the copy back; 0
where every reduction stayed under the host gate. None on a program
without the phase, which has no ROUTING.card_reductions either."""


def read(r):
    from octopus_tpu_torch.core.likelihood import likelihood_array
    if getattr(getattr(likelihood_array, "ROUTING", None), "card_reductions",
               None) is None or not r.called_mb:
        return None
    return r.self_s.get("genotype_card", 0.0) / r.called_mb
