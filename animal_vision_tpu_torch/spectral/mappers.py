"""(U, B, G) cone-catch maps -> displayable linear RGB.

Counterpart of ``animal_vision_tpu/spectral/mappers.py``: ``hsv_to_rgb``,
the mappings of the honeybee's five modes and ``map_uv_purple_yellow``. Maps are (..., H, W, 1) tensors;
every percentile is per frame (``core/stats.py``); outputs are
(..., H, W, 3)."""

from __future__ import annotations

import math

import numpy as np
import torch

from animal_vision_tpu_torch.core import linalg
from animal_vision_tpu_torch.core.stats import EPS_DEFAULT, percentile
from animal_vision_tpu_torch.core.tables import device_table


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """Minimal HSV -> RGB over the last axis, values in [0,1]; a sector
    index outside 0..5 (only from NaN) gives 0, like the reference's
    np.select default."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i_mod = torch.remainder(i, 6)
    zeros = torch.zeros_like(v)

    def sel(options):
        out = zeros
        for idx, val in enumerate(options):
            out = torch.where(i_mod == idx, val, out)
        return out

    r = sel([v, q, p, p, t, v])
    g = sel([t, v, v, q, p, p])
    b = sel([p, p, t, v, v, q])
    return torch.stack([r, g, b], dim=-1)


def map_falsecolor(u, b, g, eps: float = EPS_DEFAULT) -> torch.Tensor:
    """UV -> magenta, blue -> blue/cyan, green -> green/yellow (p95 norms)."""
    u_n = u / torch.clamp(percentile(u, 95.0), min=eps)
    b_n = b / torch.clamp(percentile(b, 95.0), min=eps)
    g_n = g / torch.clamp(percentile(g, 95.0), min=eps)
    r = 0.85 * u_n + 0.10 * g_n
    gc = 0.80 * g_n + 0.20 * b_n
    bl = 0.70 * b_n + 0.40 * u_n
    return torch.clamp(torch.cat([r, gc, bl], dim=-1), 0.0, 1.0)


def map_linear_matrix(u, b, g, m: np.ndarray) -> torch.Tensor:
    """Linear RGB = M . [U, B, G]^T."""
    mt = device_table(np.asarray(m, np.float32).T, u.device)
    return linalg.frame_matmul(torch.cat([u, b, g], dim=-1), mt)


def map_opponent(u, b, g, eps: float = EPS_DEFAULT) -> torch.Tensor:
    """Opponent (HSV-like) mapping: hue from (G-B, B-U), p95 saturation and
    value."""
    o1 = g - b
    o2 = b - u
    lum = (u + b + g) / 3.0
    angle = torch.atan2(o2, o1)
    hue = (angle + math.pi) / (2 * math.pi)
    radius = torch.sqrt(o1 * o1 + o2 * o2)
    sat = radius / (percentile(radius, 95.0) + eps)
    val = lum / (percentile(lum, 95.0) + eps)
    hsv = torch.cat([hue, torch.clamp(sat, 0, 1), torch.clamp(val, 0, 1)], dim=-1)
    return hsv_to_rgb(hsv)


def _s2l(v: np.ndarray) -> np.ndarray:
    a = 0.055
    return np.where(v <= 0.04045, v / 12.92, ((v + a) / (1 + a)) ** 2.4).astype(np.float32)


def map_uv_purple_yellow(u, eps: float = EPS_DEFAULT) -> torch.Tensor:
    """UV-only purple <-> yellow ramp (p99 normalization, gamma 0.85)."""
    un = torch.clamp(u / torch.clamp(percentile(u, 99.0), min=eps), 0.0, 1.0) ** 0.85
    c0 = device_table(_s2l(np.array([128, 0, 150], np.float32) / 255.0), u.device)
    c1 = device_table(_s2l(np.array([255, 225, 60], np.float32) / 255.0), u.device)
    return torch.clamp((1.0 - un) * c0 + un * c1, 0.0, 1.0)


def map_uv_purple_yellow_soft(
    u,
    u_gamma: float = 0.90,
    accent_gamma: float = 0.85,
    accent_strength: float = 0.05,
    eps: float = EPS_DEFAULT,
) -> torch.Tensor:
    """Pastel UV-only mapping with luminance retarget and Reinhard
    compression (p98)."""
    denom = torch.clamp(percentile(u, 98.0), min=eps)
    un = torch.clamp(u / denom, 0.0, 1.0) ** u_gamma
    c0_np = _s2l(np.array([176, 124, 232], np.float32) / 255.0)
    c0 = device_table(c0_np, u.device)
    c1 = device_table(_s2l(np.array([255, 211, 138], np.float32) / 255.0), u.device)
    rgb = (1.0 - un) * c0 + un * c1
    if accent_strength > 0:
        w = un**accent_gamma
        rgb = rgb + accent_strength * w * device_table(c0_np - np.float32(0.5), u.device)
    y = 0.2126 * rgb[..., 0:1] + 0.7152 * rgb[..., 1:2] + 0.0722 * rgb[..., 2:3] + eps
    y_target = torch.clamp(0.22 + 0.55 * un, 0.0, 1.0)
    gain = torch.clamp(y_target / y, 0.6, 1.6)
    rgb = rgb * gain
    rgb = rgb / (1.0 + 0.6 * rgb)
    return torch.clamp(rgb, 0.0, 1.0)


def map_falsecolor_uv_mixed(u, b, g, alpha: float = 0.35) -> torch.Tensor:
    """Falsecolor blended with the soft UV tint, renormalized by the frame's
    p99 when that exceeds 1."""
    base = map_falsecolor(u, b, g)
    tint = map_uv_purple_yellow_soft(u)
    alpha = float(np.clip(alpha, 0.0, 1.0))
    mixed = (1.0 - alpha) * base + alpha * tint
    p99 = percentile(mixed, 99.0)
    mixed = torch.where(p99 > EPS_DEFAULT, mixed / torch.clamp(p99, min=1.0), mixed)
    return torch.clamp(mixed, 0.0, 1.0)
