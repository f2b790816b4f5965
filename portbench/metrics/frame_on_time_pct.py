"""The share, in %, of every frame offered in the window that reached the
sink within one period of its stream (the time between due frames) of its
due time: a frame later than that is shown after the next one was due. A
frame that never reached the sink is late."""


def read(r):
    if not r.latencies_ms or not r.period_ms:
        return None
    return 100.0 * sum(v <= r.period_ms for v in r.latencies_ms) / len(r.latencies_ms)
