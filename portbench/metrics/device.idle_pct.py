"""The card's idle share of the traced window: 1 - the union of its
kernel, memcpy and memset intervals over the window's length."""


def read(r):
    if not r.trace or not r.trace["window_s"]:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"])
