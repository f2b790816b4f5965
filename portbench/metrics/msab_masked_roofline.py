"""The masked pos kernel's share of its roofline over a fixed set of its
instances, ``msab_pos_masked_kernel<31>`` and ``<62>`` (22 of a forward's
27 launches): their least time in the window (``work/``:
``msab_masked_least_s.<C>``, bytes at 3.35 TB/s, three TF32 passes at
495 TFLOP/s, depthwise taps at 67 TFLOP/s) over their device time among
the traced window's ``device_ops``. The trace keeps only the operations
that took most device time, so the set is fixed to read the same instances
in every run: None unless both are found there."""

import re

KERNEL = re.compile(r"msab_pos_masked_kernel<(\d+)>")
READ = ("31", "62")


def read(r):
    if not r.trace:
        return None
    busy = {}
    for name, seconds in r.trace["device_ops"]:
        m = KERNEL.search(name)
        if m and m.group(1) in READ:
            busy[m.group(1)] = busy.get(m.group(1), 0.0) + seconds
    if set(busy) != set(READ):
        return None
    least = sum(r.work.get(f"msab_masked_least_s.{c}", 0.0) for c in READ)
    return 100.0 * least / sum(busy.values()) if least else None
