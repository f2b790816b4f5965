"""Seconds of set-up work that the port counts in
``animal_vision_tpu_torch/utils/profiling.SETUP`` over the whole run, traced
or not: libraries loaded or built, the encode table, per-shape programs,
MST++'s weight layouts, the executor's ring and buffers. None where the
program keeps no such count."""

from animal_vision_tpu_torch.utils import profiling


def read(r):
    setup = getattr(profiling, "SETUP", None)
    if setup is None or not setup.totals:
        return None
    return sum(setup.totals.values())
