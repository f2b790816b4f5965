"""Process start to the first timed call: imports, the weights, the
inputs, the kernels' build or load, and the warm-up of the cell's own
shape and species."""


def read(r):
    return r.setup_s
