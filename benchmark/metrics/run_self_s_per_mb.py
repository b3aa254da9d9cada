"""Self seconds a called Mb of the run layer (run.py, cli.py, config/): the
harness's clock around each run_calling, less the program phases inside it."""


def read(r):
    return r.self_s.get("run_calling", 0.0) / r.called_mb if r.called_mb else None
