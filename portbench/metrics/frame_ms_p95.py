"""The 95th percentile (nearest rank), over every frame offered in the
window, of the sink's time minus the frame's due time; a frame that never
reached the sink counts as infinitely late, and a percentile that lands on
one reads 1e9 ms."""

import math

from portbench.compare import nearest_rank


def read(r):
    if not r.latencies_ms:
        return None
    v = nearest_rank(r.latencies_ms, 95.0)
    return 1e9 if math.isinf(v) else v
