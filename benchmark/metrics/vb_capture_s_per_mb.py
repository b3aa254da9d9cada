"""Self seconds a called Mb of the CUDA graph captures of the card's VB
evaluations (subclone_vb.vb_subclone, CUDAGraph() to capture_end()): the
vb_capture phase; 0 where no evaluation ran on the card."""


def read(r):
    return r.self_s.get("vb_capture", 0.0) / r.called_mb if r.called_mb else None
