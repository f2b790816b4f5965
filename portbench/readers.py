"""Arithmetic that several metric readers (``metrics/*.py``) share."""

from portbench import peaks


def outermost_ms_per_frame(name: str):
    """Host ms per frame inside the traced window's outermost spans called
    ``name`` of the port (``animal_vision_tpu_torch/utils/profiling.py``):
    their summed length over the frames they carried. None where the program
    keeps no such spans."""
    from animal_vision_tpu_torch.utils import profiling

    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    recs = spans()
    by_id = {s.id: s for s in recs}
    ns = frames = 0
    for s in recs:
        if s.name != name:
            continue
        p = by_id.get(s.parent)
        while p is not None and p.name != name:
            p = by_id.get(p.parent)
        if p is None:
            ns += s.t1_ns - s.t0_ns
            frames += s.attrs.get("frames", 1)
    return ns / 1e6 / frames if frames else None


def mfu_pct(r, key: str):
    """A model's share of the card's peak over the window: the product FLOPs
    of the frames completed (``work/``'s ``key``), over the window's
    seconds, over one dense TF32 pass (495 TFLOP/s)."""
    flops = r.work.get(key)
    if not flops or not r.window_s:
        return None
    return 100.0 * flops / r.window_s / peaks.TF32_FLOPS
