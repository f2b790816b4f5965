"""Photometric post-effects over linear-RGB (..., H, W, 3) float32
tensors and (..., H, W, 1) maps. Counterpart of
``animal_vision_tpu/core/effects.py``. The UV effects blur with
``core/blur.py:gaussian_blur_uv`` (the ``blur_uv`` kernel on the card; its
plain version where ``plain``); ``tapetum_bloom`` and ``rod_vision`` with
the auto-ksize ``gaussian_blur``, as the JAX package does."""

from __future__ import annotations

import functools

import numpy as np
import torch

from animal_vision_tpu_torch.core import blur as _blur
from animal_vision_tpu_torch.core import stats as _stats


def chroma_compression(img: torch.Tensor, strength: float = 0.4) -> torch.Tensor:
    """Lerp toward the per-pixel channel mean (gray)."""
    gray = torch.mean(img, dim=-1, keepdim=True)
    return gray + (img - gray) * (1.0 - strength)


def tapetum_bloom(img: torch.Tensor, strength: float = 0.12, sigma: float = 3.0) -> torch.Tensor:
    """Luminance-masked screen-blend bloom in linear RGB."""
    x = torch.clamp(img.to(torch.float32), 0.0, 1.0)
    mask = torch.clamp((_stats.luminance709(x) - 0.4) / 0.6, 0.0, 1.0)
    mask = _blur.gaussian_blur_hwc(mask, sigma)
    blurred = _blur.gaussian_blur_hwc(x, sigma)
    screen = 1.0 - (1.0 - x) * (1.0 - blurred)
    return torch.clamp(x + strength * mask * (screen - x), 0.0, 1.0)


def rod_vision(
    img: torch.Tensor, chroma_scale: float = 0.08, luminance_boost: float = 1.4, gamma: float = 0.8
) -> torch.Tensor:
    """Scotopic (rod-dominant) rendering: scotopic luma, blur, desaturate,
    boost, gamma."""
    x = torch.clamp(img.to(torch.float32), 0.0, 1.0)
    lum = 0.1 * x[..., 0:1] + 0.8 * x[..., 1:2] + 0.1 * x[..., 2:3]
    gray = _blur.gaussian_blur_hwc(lum, 1.2)
    x = gray * (1.0 - chroma_scale) + x * chroma_scale
    x = torch.clamp(x * luminance_boost, 0.0, 1.0)
    return x**gamma


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


def scatter_and_blue_bias(img: torch.Tensor, sigma: float, blue_bias: float, plain: bool = False) -> torch.Tensor:
    """UV blur (when sigma > 0.15) plus an additive blue bias, blue clipped."""
    out = img
    if sigma > 0.15:
        out = _blur.gaussian_blur_uv(out, sigma, plain)
    blue = torch.clamp(out[..., 2:3] + float(blue_bias), 0.0, 1.0)
    return torch.cat([out[..., :2], blue], dim=-1)


def snow_glare_tone_compress(img: torch.Tensor, strength: float, knee: float = 0.8) -> torch.Tensor:
    """Soft-knee highlight compression in linear light."""
    if strength <= 0.0:
        return img
    x = torch.clamp(img, 0.0, 1.0)
    t = (x - knee) / (1.0 - knee)
    compressed = knee + (1.0 - knee) * (t / (1.0 + strength * t))
    return torch.where(x <= knee, x, compressed)


def unsharp_mask(img: torch.Tensor, sigma: float, amount, plain: bool = False) -> torch.Tensor:
    """img + amount * (img - blur(img)) with the UV blur."""
    return img + amount * (img - _blur.gaussian_blur_uv(img, sigma, plain))


def dog_bandpass(x: torch.Tensor, sigma_lo: float, sigma_hi: float, plain: bool = False) -> torch.Tensor:
    """Difference-of-Gaussians band-pass of (..., H, W, C) (UV blurs)."""
    return _blur.gaussian_blur_uv(x, sigma_lo, plain) - _blur.gaussian_blur_uv(x, sigma_hi, plain)


def radial_sigmoid_mask(shape_hw: tuple[int, int], radius: float, softness: float) -> np.ndarray:
    """(H, W) mask 1/(1+exp(-softness*(r-radius))) on the [-1,1]^2 grid: the
    UV species' peripheral-blur mask."""
    h, w = shape_hw
    yy = np.linspace(-1.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(-1.0, 1.0, w, dtype=np.float32)[None, :]
    r = np.sqrt(xx * xx + yy * yy)
    return (1.0 / (1.0 + np.exp(-softness * (r - radius)))).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _device_mask(h: int, w: int, radius: float, softness: float, device: str) -> torch.Tensor:
    """``radial_sigmoid_mask`` as an (H, W, 1) tensor on ``device``, made once."""
    return torch.from_numpy(radial_sigmoid_mask((h, w), radius, softness)[..., None]).to(device)


def radial_mask_on(img: torch.Tensor, radius: float, softness: float) -> torch.Tensor:
    """``radial_sigmoid_mask`` of ``img``'s (H, W) as an (H, W, 1) tensor on
    its device, made once per shape."""
    return _device_mask(int(img.shape[-3]), int(img.shape[-2]), float(radius), float(softness), str(img.device))


def peripheral_blur(
    img: torch.Tensor, sigma: float, radius: float, softness: float, plain: bool = False
) -> torch.Tensor:
    """Radial blend with a UV-blurred copy: sharp center, soft edges."""
    if sigma <= 0.0:
        return img
    soft = _blur.gaussian_blur_uv(img, sigma, plain)
    t = radial_mask_on(img, radius, softness)
    return (1.0 - t) * img + t * soft
