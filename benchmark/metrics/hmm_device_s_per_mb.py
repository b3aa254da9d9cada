"""Self seconds a called Mb of the pair-HMM on the card
(core/likelihood/pairhmm_batch.py): the hmm_device phase, staging, launch and
the copy back; 0 where no job set reached the card."""


def read(r):
    return r.self_s.get("hmm_device", 0.0) / r.called_mb if r.called_mb else None
