"""Self seconds a called Mb of the seven pair-HMM tracks staged on the host
for a job set (_device_scores, before the host-DP or card branch): the
populate_stage phase."""


def read(r):
    return r.self_s.get("populate_stage", 0.0) / r.called_mb if r.called_mb else None
