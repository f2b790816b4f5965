"""MST++'s share of the card's peak over the window: the product FLOPs of
the frames completed (``work/``), over the window's seconds, over one
dense TF32 pass (495 TFLOP/s)."""

from portbench import peaks


def read(r):
    flops = r.work.get("mstpp_flops")
    if not flops or not r.window_s:
        return None
    return 100.0 * flops / r.window_s / peaks.TF32_FLOPS
