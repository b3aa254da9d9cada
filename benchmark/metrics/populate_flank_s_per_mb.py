"""Self seconds a called Mb of the flank discount of the card's job sets
(_device_scores, the host extension's traceback for reads over a flank):
the populate_flank phase; 0 where no job set reached the card."""


def read(r):
    return r.self_s.get("populate_flank", 0.0) / r.called_mb if r.called_mb else None
