"""Frame I/O: image, video and webcam renderers, split composition and
gallery grids. OpenCV (cv2) works at this boundary only, and is imported
inside the functions that need it: importing this package needs no cv2."""

from animal_vision_tpu_torch.io.renderer import Renderer  # noqa: F401
from animal_vision_tpu_torch.io.image import ImageRenderer  # noqa: F401
from animal_vision_tpu_torch.io.video import VideoRenderer  # noqa: F401
from animal_vision_tpu_torch.io.webcam import WebcamRenderer  # noqa: F401
