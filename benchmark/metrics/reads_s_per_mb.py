"""Self seconds a called Mb of the reads layer (io/, readpipe/): the bam_fetch
and read_pipe phases."""


def read(r):
    if not r.called_mb:
        return None
    return (r.self_s.get("bam_fetch", 0.0) + r.self_s.get("read_pipe", 0.0)) / r.called_mb
