"""ms per frame of the species programs: CUDA events that the benchmark
records around each ``visualize_batch_device`` call of the window."""


def read(r):
    if not r.frames or not r.call_ms:
        return None
    return sum(r.call_ms) / r.frames
