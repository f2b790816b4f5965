"""Still-image renderer: read once and cache as RGB uint8; render saves and
optionally shows. Counterpart of ``animal_vision_tpu/io/image.py``."""

from __future__ import annotations

import os

import numpy as np

from animal_vision_tpu_torch.io.renderer import Renderer, gui_available, require_cv2, to_rgb_uint8


class ImageRenderer(Renderer):
    def __init__(
        self,
        filename: str,
        show_window: bool = True,
        save_to: str | None = None,
        wait_key: int = 0,
        window_name: str = "animal-vision",
    ):
        self.filename = filename
        self.show_window = show_window and gui_available()
        self.save_to = save_to
        self.wait_key = wait_key
        self.window_name = window_name
        self._image: np.ndarray | None = None
        self._opened = False

    def open(self) -> None:
        self._opened = True
        if self.show_window:
            cv2 = require_cv2()
            cv2.namedWindow(self.window_name, cv2.WINDOW_NORMAL)

    def get_image(self) -> np.ndarray:
        """Read (once) and cache the file as RGB uint8."""
        if self._image is None:
            cv2 = require_cv2()
            frame = cv2.imread(self.filename, cv2.IMREAD_UNCHANGED)
            if frame is None:
                raise FileNotFoundError(self.filename)
            if frame.dtype != np.uint8:
                frame = np.clip(frame.astype(np.float32) / frame.max() * 255, 0, 255).astype(np.uint8)
            self._image = to_rgb_uint8(frame)
        return self._image

    def render(self, image: np.ndarray) -> None:
        if not self._opened:
            raise RuntimeError("call open() first")
        cv2 = require_cv2()
        if self.save_to:
            os.makedirs(os.path.dirname(self.save_to) or ".", exist_ok=True)
            cv2.imwrite(self.save_to, cv2.cvtColor(image, cv2.COLOR_RGB2BGR))
        if self.show_window:
            cv2.imshow(self.window_name, cv2.cvtColor(image, cv2.COLOR_RGB2BGR))
            cv2.waitKey(self.wait_key)

    def close(self) -> None:
        self._opened = False
        if self.show_window:
            require_cv2().destroyWindow(self.window_name)
