"""Native (C++) runtime pieces, built with g++ at first use and loaded with
ctypes: the SPSC frame ring of the streaming executor."""

from animal_vision_tpu_torch.native.ring import FrameRing  # noqa: F401
