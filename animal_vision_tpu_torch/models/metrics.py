"""HSI reconstruction quality metrics.

Counterpart of ``animal_vision_tpu/models/metrics.py`` (the reference's
``Loss_MRAE``, ``Loss_RMSE`` and ``Loss_PSNR``), on tensors of any device.
"""

from __future__ import annotations

import torch


def mrae(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean relative absolute error: mean(|pred - target| / target)."""
    return torch.mean(torch.abs(pred - target) / target)


def rmse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean((pred - target) ** 2))


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 255.0) -> torch.Tensor:
    """The reference ``Loss_PSNR``: both clamped to [0, 1] and scaled to
    [0, data_range], the MSE per image over all its other axes, then
    10 log10(data_range^2 / mse), averaged over the images
    (``metrics.py:23-31``)."""
    p = torch.clamp(pred, 0.0, 1.0) * data_range
    t = torch.clamp(target, 0.0, 1.0) * data_range
    mse = torch.mean((p - t) ** 2, dim=tuple(range(1, pred.dim())))
    return torch.mean(10.0 * torch.log10(data_range ** 2 / mse))
