"""Host ms per frame inside the spectral model's forwards: the time of the
traced window's outermost ``model.forward`` spans of the port (one module
forward, no sync: ``animal_vision_tpu_torch/models/providers.py``) over
the frames they carried. None where the program keeps no such spans."""

from portbench import readers


def read(r):
    return readers.outermost_ms_per_frame("model.forward")
