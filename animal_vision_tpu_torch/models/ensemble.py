"""8-way self-ensemble inference.

Counterpart of ``forward_ensemble`` in ``animal_vision_tpu/models/ensemble.py``
(the reference's ``predict_code/test.py``): the model runs on every
combination of a horizontal flip, a vertical flip and a transpose of the
frames, each output is taken back through its transform, and the eight are
reduced by their mean or median. For "median" ``torch.median`` takes the
lower of the two middle values of the eight, as the reference does and the
JAX package reproduces (``ensemble.py:8-10``). ``predict_image`` and the
command line are not ported yet: they need the ``.mat`` I/O of ``eval.py``.
"""

from __future__ import annotations

import itertools

import torch


def _transform(data: torch.Tensor, xflip: bool, yflip: bool, transpose: bool, reverse: bool = False) -> torch.Tensor:
    """(B, H, W, C) through the flips and the transpose, or back."""
    if not reverse:
        if xflip:
            data = data.flip(2)
        if yflip:
            data = data.flip(1)
        if transpose:
            data = data.transpose(1, 2)
    else:
        if transpose:
            data = data.transpose(1, 2)
        if yflip:
            data = data.flip(1)
        if xflip:
            data = data.flip(2)
    return data


def forward_ensemble(apply_fn, x: torch.Tensor, ensemble_mode: str = "mean") -> torch.Tensor:
    """x: (B, H, W, 3). Returns the 8-view ensemble (B, H, W, C) of
    ``apply_fn``."""
    if ensemble_mode not in ("mean", "median"):
        raise ValueError(f"ensemble_mode must be 'mean' or 'median', got {ensemble_mode!r}")
    outputs = []
    for xflip, yflip, transpose in itertools.product((False, True), repeat=3):
        y = apply_fn(_transform(x, xflip, yflip, transpose).contiguous())
        outputs.append(_transform(y, xflip, yflip, transpose, reverse=True))
    stack = torch.stack(outputs)
    if ensemble_mode == "mean":
        return stack.mean(dim=0)
    return stack.median(dim=0).values
