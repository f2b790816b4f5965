"""Labeled gallery grid: each tile resized to the tile height (aspect kept),
a black label strip under it, padded to the largest cell, in an about
square grid. Counterpart of ``animal_vision_tpu/io/gallery.py``."""

from __future__ import annotations

import math

import numpy as np

from animal_vision_tpu_torch.io.renderer import require_cv2


def _to_uint8(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint8:
        return img
    x = img.astype(np.float32)
    if x.max() <= 1.0:
        x = x * 255.0
    return np.clip(x, 0, 255).astype(np.uint8)


def _resize_keep_ar(img: np.ndarray, tile_h: int) -> np.ndarray:
    cv2 = require_cv2()
    h, w = img.shape[:2]
    scale = tile_h / h
    return cv2.resize(img, (max(1, int(round(w * scale))), tile_h), interpolation=cv2.INTER_AREA)


def _label_strip(width: int, text: str, strip_h: int = 28) -> np.ndarray:
    cv2 = require_cv2()
    strip = np.zeros((strip_h, width, 3), np.uint8)
    cv2.putText(strip, text, (8, strip_h - 9), cv2.FONT_HERSHEY_SIMPLEX, 0.55, (255, 255, 255), 1, cv2.LINE_AA)
    return strip


def build_labeled_grid(
    images: list[np.ndarray],
    labels: list[str],
    tile_height: int = 256,
    cols: int | None = None,
) -> np.ndarray:
    """Stack labeled tiles into an approximately square grid."""
    if not images or len(images) != len(labels):
        raise ValueError(f"need one label per image and at least one image: {len(images)} images, {len(labels)} labels")
    cells = []
    for img, label in zip(images, labels):
        tile = _resize_keep_ar(_to_uint8(img), tile_height)
        cells.append(np.vstack([tile, _label_strip(tile.shape[1], label)]))
    max_h = max(c.shape[0] for c in cells)
    max_w = max(c.shape[1] for c in cells)
    padded = [np.pad(c, ((0, max_h - c.shape[0]), (0, max_w - c.shape[1]), (0, 0))) for c in cells]
    n = len(padded)
    ncols = cols or max(1, int(math.ceil(math.sqrt(n))))
    nrows = int(math.ceil(n / ncols))
    blank = np.zeros_like(padded[0])
    rows = []
    for r in range(nrows):
        row = padded[r * ncols : (r + 1) * ncols]
        row += [blank] * (ncols - len(row))
        rows.append(np.hstack(row))
    return np.vstack(rows)
