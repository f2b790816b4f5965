"""The executor's emit hold: the 95th percentile (nearest rank), over the
frames of the traced window, of each batch's ``executor.held`` record of
the port (from the end of the batch's dispatch to the start of its emit:
``animal_vision_tpu_torch/pipeline/executor.py``), every frame taking its
batch's hold. None where the program keeps no such records."""

from animal_vision_tpu_torch.utils import profiling
from portbench.compare import nearest_rank


def read(r):
    spans = getattr(profiling, "spans", None)
    if spans is None:
        return None
    held = [(s.t1_ns - s.t0_ns) / 1e6 for s in spans() if s.name == "executor.held"
            for _ in range(s.attrs.get("frames", 1))]
    return nearest_rank(held, 95.0) if held else None
