"""Video renderer: VideoCapture to RGB frames, a lazy mp4v writer opened on
the first rendered frame, and ``make_split_frame`` (the composite without
rendering). Counterpart of ``animal_vision_tpu/io/video.py``."""

from __future__ import annotations

import os

import numpy as np

from animal_vision_tpu_torch.io.renderer import Renderer, compose_split, gui_available, require_cv2


class VideoRenderer(Renderer):
    def __init__(
        self,
        filename: str | None = None,
        save_to: str | None = None,
        show_window: bool = False,
        fps: float | None = None,
        window_name: str = "animal-vision",
    ):
        self.filename = filename
        self.save_to = save_to
        self.show_window = show_window and gui_available()
        self.fps = fps
        self.window_name = window_name
        self._cap = None
        self._writer = None

    def open(self) -> None:
        if self.filename is not None:
            cv2 = require_cv2()
            self._cap = cv2.VideoCapture(self.filename)
            if not self._cap.isOpened():
                raise FileNotFoundError(self.filename)
            if self.fps is None:
                self.fps = self._cap.get(cv2.CAP_PROP_FPS) or 30.0

    def get_image(self) -> np.ndarray | None:
        """Next frame as RGB uint8, or None at end of stream."""
        ok, frame = self._cap.read()
        if not ok:
            return None
        cv2 = require_cv2()
        return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)

    def frames(self):
        while True:
            frame = self.get_image()
            if frame is None:
                return
            yield frame

    def _ensure_writer(self, shape) -> None:
        if self._writer is None and self.save_to:
            cv2 = require_cv2()
            os.makedirs(os.path.dirname(self.save_to) or ".", exist_ok=True)
            fourcc = cv2.VideoWriter_fourcc(*"mp4v")
            self._writer = cv2.VideoWriter(self.save_to, fourcc, self.fps or 30.0, (shape[1], shape[0]))

    def render(self, image: np.ndarray) -> None:
        self._ensure_writer(image.shape)
        if self._writer is not None:
            cv2 = require_cv2()
            self._writer.write(cv2.cvtColor(image, cv2.COLOR_RGB2BGR))
        if self.show_window:
            cv2 = require_cv2()
            cv2.imshow(self.window_name, cv2.cvtColor(image, cv2.COLOR_RGB2BGR))
            if cv2.waitKey(1) & 0xFF == ord("q"):
                raise KeyboardInterrupt

    def make_split_frame(
        self,
        original: np.ndarray,
        modified: np.ndarray,
        left_label: str = "Original",
        right_label: str = "Transformed",
        draw_seam: bool = True,
    ) -> np.ndarray:
        """Composite without rendering (the serving path's entry)."""
        return compose_split(original, modified, left_label, right_label, draw_seam)

    def close(self) -> None:
        if self._cap is not None:
            self._cap.release()
            self._cap = None
        if self._writer is not None:
            self._writer.release()
            self._writer = None
        if self.show_window:
            require_cv2().destroyWindow(self.window_name)
