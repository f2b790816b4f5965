"""Webcam renderer: VideoCapture(index) with best-effort width, height, fps,
autofocus and auto-exposure; a mirrored preview; the video renderer's
writer and split machinery. Counterpart of ``animal_vision_tpu/io/webcam.py``."""

from __future__ import annotations

import numpy as np

from animal_vision_tpu_torch.io.renderer import require_cv2
from animal_vision_tpu_torch.io.video import VideoRenderer


class WebcamRenderer(VideoRenderer):
    def __init__(
        self,
        index: int = 0,
        width: int = 1280,
        height: int = 720,
        fps: float = 30.0,
        mirror_preview: bool = True,
        **kwargs,
    ):
        super().__init__(filename=None, fps=fps, **kwargs)
        self.index = index
        self.width = width
        self.height = height
        self.mirror_preview = mirror_preview

    def open(self) -> None:
        cv2 = require_cv2()
        self._cap = cv2.VideoCapture(self.index)
        if not self._cap.isOpened():
            raise RuntimeError(f"cannot open webcam {self.index}")
        self._cap.set(cv2.CAP_PROP_FRAME_WIDTH, self.width)
        self._cap.set(cv2.CAP_PROP_FRAME_HEIGHT, self.height)
        self._cap.set(cv2.CAP_PROP_FPS, self.fps or 30.0)
        # autofocus and auto-exposure are best effort: not every backend has them
        for prop, val in ((cv2.CAP_PROP_AUTOFOCUS, 1), (cv2.CAP_PROP_AUTO_EXPOSURE, 1)):
            try:
                self._cap.set(prop, val)
            except cv2.error:
                pass

    def render(self, image: np.ndarray) -> None:
        if self.mirror_preview and self.show_window:
            image = np.ascontiguousarray(image[:, ::-1])
        super().render(image)
