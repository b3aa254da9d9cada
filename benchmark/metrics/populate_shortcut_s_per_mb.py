"""Self seconds a called Mb of the likelihood layer's padded read matrices
and naive 0- and 1-mismatch shortcuts (_eval_jobs_fixed_len): the
populate_shortcut phase."""


def read(r):
    return r.self_s.get("populate_shortcut", 0.0) / r.called_mb if r.called_mb else None
