"""Host ms per frame inside the species programs: the time of the traced
window's outermost ``species.program`` spans of the port (program lookup
and call, no sync: ``animal_vision_tpu_torch/utils/profiling.py``) over
the frames they carried. None where the program keeps no such spans."""

from animal_vision_tpu_torch.utils import profiling

NAME = "species.program"


def read(r):
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    recs = spans()
    by_id = {s.id: s for s in recs}
    ns = frames = 0
    for s in recs:
        if s.name != NAME:
            continue
        p = by_id.get(s.parent)
        while p is not None and p.name != NAME:
            p = by_id.get(p.parent)
        if p is None:
            ns += s.t1_ns - s.t0_ns
            frames += s.attrs.get("frames", 1)
    return ns / 1e6 / frames if frames else None
