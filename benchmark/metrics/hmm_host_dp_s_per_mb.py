"""Self seconds a called Mb of the pair-HMM's host DP
(the host extension's flank_banded_scores): the hmm_host_dp phase."""


def read(r):
    return r.self_s.get("hmm_host_dp", 0.0) / r.called_mb if r.called_mb else None
