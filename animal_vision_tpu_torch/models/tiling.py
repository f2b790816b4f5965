"""Tiled full-resolution inference with Hann-feathered stitching.

Counterpart of ``animal_vision_tpu/models/tiling.py`` (the reference's
``predict_static.py``): fixed tiles with an overlap, each tile's output
weighted by a 2-D Hann window, accumulated, normalised and cropped. The
tiles are cut, stacked and accumulated on the frame's device. It is the
way a model whose memory grows faster than its pixels (AWAN's non-local
tail: an n x n matrix per quadrant) runs a full-HD frame.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from animal_vision_tpu_torch.models.mst_plus_plus import _reflect_index


@functools.lru_cache(maxsize=None)
def hann2d(size: int) -> np.ndarray:
    """2-D Hann window (the outer product of two 1-D ones) plus 1e-3, so
    that no weight vanishes at a tile's corners."""
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(size) / max(size - 1, 1))
    return (np.outer(w, w) + 1e-3).astype(np.float32)


def _tile_starts(extent: int, tile: int, stride: int) -> list[int]:
    if extent <= tile:
        return [0]
    starts = list(range(0, extent - tile + 1, stride))
    if starts[-1] != extent - tile:
        starts.append(extent - tile)
    return starts


def predict_tiled(apply_fn, frame: torch.Tensor, tile: int = 256, overlap: int = 64,
                  out_channels: int = 31) -> torch.Tensor:
    """Run ``apply_fn`` ((T, tile, tile, 3) -> (T, tile, tile, C)) once on
    all the overlapping tiles of an (H, W, 3) frame and stitch the outputs
    with Hann weights: (H, W, C) on the frame's device. A frame smaller
    than ``tile`` is reflect-padded up (numpy's ``mode="reflect"``). A
    caller that needs the tiles run a few at a time passes an
    ``apply_fn`` that does so."""
    h, w = frame.shape[:2]
    dev = frame.device
    fh, fw = max(h, tile), max(w, tile)
    if (fh, fw) != (h, w):
        frame = frame.index_select(0, _reflect_index(h, fh, dev)).index_select(1, _reflect_index(w, fw, dev))
    stride = tile - overlap
    starts = [(y, x) for y in _tile_starts(fh, tile, stride) for x in _tile_starts(fw, tile, stride)]
    outs = apply_fn(torch.stack([frame[y:y + tile, x:x + tile] for y, x in starts]))
    win = torch.from_numpy(hann2d(tile)).to(dev)
    # each tile pixel's index in the flattened frame
    local = (torch.arange(tile, device=dev)[:, None] * fw + torch.arange(tile, device=dev)[None, :]).flatten()
    index = torch.cat([local + y * fw + x for y, x in starts])
    acc = torch.zeros(fh * fw, out_channels, dtype=outs.dtype, device=dev)
    acc.index_add_(0, index, (outs * win[None, :, :, None]).reshape(-1, out_channels))
    norm = torch.zeros(fh * fw, dtype=win.dtype, device=dev)
    norm.index_add_(0, index, win.flatten().repeat(len(starts)))
    return (acc / norm[:, None]).reshape(fh, fw, out_channels)[:h, :w]
