"""Band weights, band integrals, illuminant and von Kries adaptation.

Counterpart of ``animal_vision_tpu/spectral/bands.py``. The weight and
illuminant tables are NumPy, identical to the JAX package's; the band
integrals contract an explicit (..., H, W, B) cube to an (..., H, W, 1)
map; the von Kries maps are (..., H, W, 1) tensors, each divided by its own
frame's max or mean."""

from __future__ import annotations

import functools

import numpy as np
import torch

from animal_vision_tpu_torch.core import linalg
from animal_vision_tpu_torch.core.stats import safe_norm
from animal_vision_tpu_torch.core.tables import device_table

EPS_DEFAULT = 1e-8


@functools.lru_cache(maxsize=None)
def bandpass_weights(lambdas: tuple, lo: float, hi: float) -> np.ndarray:
    """Raised-cosine weights on [lo, hi], normalized to sum 1."""
    wl = np.asarray(lambdas, dtype=np.float32)
    w = np.zeros_like(wl, dtype=np.float32)
    mask = (wl >= lo) & (wl <= hi)
    if not np.any(mask):
        return np.ones_like(wl) / float(wl.size)
    x = (wl[mask] - lo) / (hi - lo)
    w[mask] = 0.5 * (1.0 - np.cos(2.0 * np.pi * x))
    s = float(w.sum())
    if s > 1e-12:
        w /= s
    else:
        w = np.ones_like(wl) / float(wl.size)
    return w


def integrate_band(hsi: torch.Tensor, lambdas: np.ndarray, lo: float, hi: float) -> torch.Tensor:
    """The raised-cosine band integral of an (..., H, W, B) cube, as an
    (..., H, W, 1) map."""
    w = bandpass_weights(tuple(float(v) for v in np.asarray(lambdas)), lo, hi)
    return linalg.frame_matmul(hsi.to(torch.float32), device_table(w[:, None], hsi.device))


def integrate_uv(hsi: torch.Tensor, lambdas: np.ndarray, lo: float, hi: float) -> torch.Tensor:
    """``integrate_band``, min-max normalized per frame."""
    return safe_norm(integrate_band(hsi, lambdas, lo, hi))


def d65_like(lambdas_nm: np.ndarray) -> np.ndarray:
    """Smooth daylight SPD, mean-normalized."""
    lam = np.asarray(lambdas_nm, dtype=np.float64)
    x = (lam - 560.0) / 50.0
    base = np.exp(-0.5 * x**2) + 0.3 * np.exp(-0.5 * ((lam - 450.0) / 35.0) ** 2)
    base = base / base.mean()
    return base.astype(np.float32)


def von_kries_white_patch(u, b, g, eps: float = EPS_DEFAULT):
    """Divide each catch map by its frame's max."""
    return tuple(m / torch.clamp(torch.amax(m, dim=(-3, -2, -1), keepdim=True), min=eps) for m in (u, b, g))


def von_kries_gray_world(u, b, g, eps: float = EPS_DEFAULT):
    """Divide each catch map by its frame's mean."""
    return tuple(m / torch.clamp(torch.mean(m, dim=(-3, -2, -1), keepdim=True), min=eps) for m in (u, b, g))
