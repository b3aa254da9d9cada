"""Self seconds a called Mb of the models (core/models/,
core/tools/phaser.py): the infer_latents phase, VB inside."""


def read(r):
    return r.self_s.get("infer_latents", 0.0) / r.called_mb if r.called_mb else None
