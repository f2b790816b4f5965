"""Renderer lifecycle ABC and the shared composition helpers.

Counterpart of ``animal_vision_tpu/io/renderer.py``: the same split
composition (half and half, 1-px seam, semi-transparent label boxes with
outlined text) and the same bytes on the same inputs. Presentation pixels
stay on the host, in OpenCV. cv2 is imported by the functions that use it
(``require_cv2``), so the port imports without it; a function that needs it
and finds none raises an ImportError that names it.
"""

from __future__ import annotations

import abc
import os

import numpy as np


def require_cv2():
    """The cv2 module, or an ImportError that names it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("OpenCV (cv2) is needed for frame I/O and composition: pip install opencv-python") from e
    return cv2


def gui_available() -> bool:
    """imshow only where a display exists and cv2 is installed."""
    if os.environ.get("ANIMAL_VISION_HEADLESS") or not (os.environ.get("DISPLAY") or os.name == "nt"):
        return False
    try:
        require_cv2()
    except ImportError:
        return False
    return True


def draw_label(img: np.ndarray, text: str, org: tuple[int, int]) -> None:
    """Semi-transparent label box with outlined text, in place (RGB)."""
    cv2 = require_cv2()
    font = cv2.FONT_HERSHEY_SIMPLEX
    scale, thick, pad = 0.6, 2, 6
    (tw, th), baseline = cv2.getTextSize(text, font, scale, thick)
    x, y = org
    x0, y0 = max(x - pad, 0), max(y - th - baseline - pad, 0)
    x1 = min(x + tw + pad, img.shape[1] - 1)
    y1 = min(y + baseline + pad, img.shape[0] - 1)
    overlay = img.copy()
    cv2.rectangle(overlay, (x0, y0), (x1, y1), (0, 0, 0), thickness=-1)
    cv2.addWeighted(overlay, 0.6, img, 0.4, 0, img)
    cv2.putText(img, text, (x, y), font, scale, (0, 0, 0), thick + 2, cv2.LINE_AA)
    cv2.putText(img, text, (x, y), font, scale, (255, 255, 255), thick, cv2.LINE_AA)


def compose_split(
    original: np.ndarray,
    modified: np.ndarray,
    left_label: str = "Original",
    right_label: str = "Transformed",
    draw_seam: bool = True,
) -> np.ndarray:
    """Half/half comparison frame: left = original, right = modified (resized
    to match), optional 1-px white seam, labels top-left/top-right. A new
    array; neither input is written."""
    cv2 = require_cv2()
    h, w, _ = original.shape
    if modified.shape[:2] != (h, w):
        modified = cv2.resize(modified, (w, h), interpolation=cv2.INTER_AREA)
    out = original.copy()
    mid = w // 2
    out[:, mid:, :] = modified[:, mid:, :]
    if draw_seam:
        out[:, mid : mid + 1, :] = 255
    draw_label(out, left_label, (10, 24))
    (rt_w, _), _ = cv2.getTextSize(right_label, cv2.FONT_HERSHEY_SIMPLEX, 0.55, 1)
    draw_label(out, right_label, (max(w - rt_w - 10, 10), 24))
    return out


def to_rgb_uint8(frame: np.ndarray, from_bgr: bool = True) -> np.ndarray:
    """Normalize decoder output (gray / BGR / BGRA) to RGB uint8."""
    cv2 = require_cv2()
    if frame.ndim == 2:
        return cv2.cvtColor(frame, cv2.COLOR_GRAY2RGB)
    if frame.shape[2] == 4:
        code = cv2.COLOR_BGRA2RGB if from_bgr else cv2.COLOR_RGBA2RGB
        return cv2.cvtColor(frame, code)
    return cv2.cvtColor(frame, cv2.COLOR_BGR2RGB) if from_bgr else frame


class Renderer(abc.ABC):
    """open -> get_image/render(...) -> close lifecycle."""

    @abc.abstractmethod
    def open(self) -> None: ...

    @abc.abstractmethod
    def render(self, image: np.ndarray) -> None: ...

    def render_split_compare(
        self,
        original: np.ndarray,
        modified: np.ndarray,
        left_label: str = "Original",
        right_label: str = "Transformed",
        draw_seam: bool = True,
    ) -> None:
        self.render(compose_split(original, modified, left_label, right_label, draw_seam))

    @abc.abstractmethod
    def close(self) -> None: ...
