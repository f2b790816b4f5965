"""Sobel gradients and the structure tensor of (..., H, W, 1) maps.

Counterpart of ``animal_vision_tpu/core/gradients.py``: cv2.Sobel(ksize=3,
BORDER_REFLECT_101), the Sobel orientation, the Gaussian-windowed
structure tensor (products blurred with the UV blur) and its coherence and
energy. The map's trailing channel axis stays explicit, so x is axis -2
and y axis -3.
The JAX package's padded-bucket sign flip of Jxy is not needed: the port
runs every frame at its own shape.
"""

from __future__ import annotations

import numpy as np
import torch

from animal_vision_tpu_torch.core import blur as _blur
from animal_vision_tpu_torch.core.tables import device_table

_SMOOTH = np.array([1.0, 2.0, 1.0], dtype=np.float32)
_DERIV = np.array([-1.0, 0.0, 1.0], dtype=np.float32)


def sobel_x(img: torch.Tensor) -> torch.Tensor:
    """cv2.Sobel(dx=1, dy=0, ksize=3): derivative along x, smooth along y."""
    d, s = device_table(_DERIV, img.device), device_table(_SMOOTH, img.device)
    return _blur.conv1d_axis(_blur.conv1d_axis(img, d, -2), s, -3)


def sobel_y(img: torch.Tensor) -> torch.Tensor:
    """cv2.Sobel(dx=0, dy=1, ksize=3): derivative along y, smooth along x."""
    d, s = device_table(_DERIV, img.device), device_table(_SMOOTH, img.device)
    return _blur.conv1d_axis(_blur.conv1d_axis(img, d, -3), s, -2)


def orientation(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gx, gy, theta = atan2(gy, gx)) of a (..., H, W, 1) map from the 3x3
    Sobel."""
    gx = sobel_x(img)
    gy = sobel_y(img)
    return gx, gy, torch.atan2(gy, gx)


def structure_tensor(
    img: torch.Tensor, sigma: float, plain: bool = False
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Jxx, Jxy, Jyy) of a (..., H, W, 1) map: the Sobel products blurred
    with the UV kernel. The three products go through one blur as the three
    channels of one (..., H, W, 3) tensor."""
    if img.shape[-1] != 1:
        raise ValueError(f"structure_tensor takes (..., H, W, 1) maps, got {tuple(img.shape)}")
    gx = sobel_x(img)
    gy = sobel_y(img)
    j = _blur.gaussian_blur_uv(torch.cat([gx * gx, gx * gy, gy * gy], dim=-1), sigma, plain)
    return j[..., 0:1], j[..., 1:2], j[..., 2:3]


def coherence_energy(
    img: torch.Tensor, sigma: float, eps: float = 1e-8, plain: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalue coherence ((l1 - l2) / (l1 + l2)) and energy (l1 + l2) of
    the structure tensor of a (..., H, W, 1) map."""
    jxx, jxy, jyy = structure_tensor(img, sigma, plain)
    tr = jxx + jyy
    det_disc = torch.sqrt(torch.clamp((jxx - jyy) ** 2 + 4.0 * jxy * jxy, min=0.0))
    l1 = 0.5 * (tr + det_disc)
    l2 = 0.5 * (tr - det_disc)
    return (l1 - l2) / (l1 + l2 + eps), tr
