"""ms per frame in all six stages of ``StreamingExecutor.timer`` (ring put,
ring to pinned, sink by the host clock; h2d, compute, d2h by CUDA
events), over the frames the sink received."""

STAGES = ("ring put", "ring to pinned", "h2d", "compute", "d2h", "sink")


def read(r):
    if not r.frames or not all(s in r.spans for s in STAGES):
        return None
    return 1e3 * sum(r.spans[s] for s in STAGES) / r.frames
