"""The species programs' share of their roofline: the least time of the
window's calls (``work/``: bytes at 3.35 TB/s, products at 495 TFLOP/s,
other operations at 67 TFLOP/s) over the time the card's kernels were
busy in the traced window."""


def read(r):
    least = r.work.get("least_s")
    if not least or not r.trace or not r.trace["kernel_busy_s"]:
        return None
    return 100.0 * least / r.trace["kernel_busy_s"]
