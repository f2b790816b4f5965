"""Photometric post-effects of the non-UV species, over linear-RGB
(..., H, W, 3) float32 tensors. Counterpart of the two functions of
``animal_vision_tpu/core/effects.py`` that the non-UV species use."""

from __future__ import annotations

import numpy as np
import torch


def chroma_compression(img: torch.Tensor, strength: float = 0.4) -> torch.Tensor:
    """Lerp toward the per-pixel channel mean (gray)."""
    gray = torch.mean(img, dim=-1, keepdim=True)
    return gray + (img - gray) * (1.0 - strength)


def s_cone_gain_ramp(
    h: int, s_top: float, s_bottom: float, power: float, extra_boost: float
) -> np.ndarray:
    """The (H,) float32 vertical blue-gain ramp of ``s_cone_vertical_gain``."""
    w = np.linspace(s_top, s_bottom, h, dtype=np.float32)
    if power != 1.0:
        t = (w - s_bottom) / max(1e-8, s_top - s_bottom)
        t = np.clip(t, 0.0, 1.0) ** power
        w = s_bottom + (s_top - s_bottom) * t
    if extra_boost != 0.0:
        w = 1.0 + extra_boost * (w - 1.0)
    return np.asarray(w, dtype=np.float32)


def s_cone_vertical_gain(
    img: torch.Tensor,
    s_top: float = 1.0,
    s_bottom: float = 0.6,
    power: float = 1.0,
    extra_boost: float = 0.0,
) -> torch.Tensor:
    """Vertical ramp gain on the blue channel, clipped to [0,1] (the rat's
    dorsal S-cone bias)."""
    ramp = s_cone_gain_ramp(int(img.shape[-3]), s_top, s_bottom, power, extra_boost)
    gain = torch.from_numpy(ramp).to(img.device)[:, None]
    blue = torch.clamp(img[..., 2] * gain, 0.0, 1.0)
    return torch.cat([img[..., :2], blue[..., None]], dim=-1)
