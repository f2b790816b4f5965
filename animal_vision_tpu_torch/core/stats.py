"""Per-frame statistics of images and maps: exact percentiles, min-max
normalization, Rec.709 luma.

Counterpart of ``animal_vision_tpu/core/stats.py`` (``percentile``,
``safe_norm``, ``norm_by_percentile``, ``luminance709``). Maps carry an
explicit trailing channel axis, (..., H, W, 1), so every statistic reduces
over the last three axes: one value per frame of a batch, never over the
batch. ``percentile`` is ``np.percentile(..., method="linear")`` of each
frame, to the bit: a sort on the device gives the two order statistics and
the host computes numpy's float32 rank and weight. The JAX package's TPU
radix select and bucket masking give the same numbers and are not needed.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

EPS_DEFAULT = 1e-8


@functools.lru_cache(maxsize=None)
def percentile_rank(n: int, q: float) -> tuple[int, int, float]:
    """(lower index, upper index, weight) of ``np.percentile``'s linear
    method for ``n`` float32 values: numpy computes the rank in float32,
    ``(n - 1) * (q / float32(100))``, and clamps it to [0, n - 1]."""
    v = (n - 1) * np.asanyarray(np.true_divide(q, np.float32(100)))
    if v >= n - 1:
        return n - 1, n - 1, 0.0
    if v < 0:
        return 0, 0, 0.0
    lo = int(np.floor(v))
    return lo, lo + 1, float(np.float32(v - lo))


def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """Per-frame ``np.percentile(frame, q)`` of (..., H, W, C) float32, as a
    (..., 1, 1, 1) tensor on ``x``'s device: numpy's float32 interpolation
    ``a + (b-a)*g``, or ``b - (b-a)*(1-g)`` when ``g >= 0.5``."""
    x = x.to(torch.float32)
    flat = x.reshape(*x.shape[:-3], -1)
    lo, hi, g = percentile_rank(int(flat.shape[-1]), float(q))
    s = torch.sort(flat, dim=-1).values
    a, b = s[..., lo], s[..., hi]
    diff = b - a
    if g >= 0.5:
        out = b - diff * float(np.float32(1.0) - np.float32(g))
    else:
        out = a + diff * g
    return out.reshape(*x.shape[:-3], 1, 1, 1)


def safe_norm(x: torch.Tensor) -> torch.Tensor:
    """Per-frame min-max normalize to [0,1]; all zeros where the frame's
    range is < 1e-9."""
    x = x.to(torch.float32)
    mn = torch.amin(x, dim=(-3, -2, -1), keepdim=True)
    mx = torch.amax(x, dim=(-3, -2, -1), keepdim=True)
    rng = mx - mn
    flat = rng < 1e-9
    normed = (x - mn) / torch.where(flat, 1.0, rng)
    return torch.where(flat, torch.zeros_like(x), normed)


def norm_by_percentile(x: torch.Tensor, q: float, eps: float = EPS_DEFAULT) -> torch.Tensor:
    """x / max(percentile(x, q), eps), per frame."""
    return x / torch.clamp(percentile(x, q), min=eps)


def luminance709(rgb: torch.Tensor) -> torch.Tensor:
    """Rec.709 luma of (..., 3) linear RGB, as a (..., 1) map."""
    return 0.2126 * rgb[..., 0:1] + 0.7152 * rgb[..., 1:2] + 0.0722 * rgb[..., 2:3]
