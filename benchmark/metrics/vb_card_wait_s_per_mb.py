"""Self seconds a called Mb of the host waiting for the card's VB
evaluations: the vb_card_wait phase, around the copies of the ELBOs,
alphas and taus back to the host (the first copy blocks on the card)."""


def read(r):
    return r.self_s.get("vb_card_wait", 0.0) / r.called_mb if r.called_mb else None
