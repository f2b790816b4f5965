"""MST-L's share of the card's peak over the window: the product FLOPs of
the frames completed (``work/``: ``mstl_flops``), over the window's
seconds, over one dense TF32 pass (495 TFLOP/s)."""

from portbench import readers


def read(r):
    return readers.mfu_pct(r, "mstl_flops")
