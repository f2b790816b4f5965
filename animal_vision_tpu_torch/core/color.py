"""Color-space primitives: sRGB transfer curves, LMS cone space, dichromat collapse.

Counterpart of ``animal_vision_tpu/core/color.py``. The 3x3 matrices are
NumPy host tables built with the reference's exact float32/float64 mixing;
the per-pixel functions are PyTorch and run on whatever device the tensor
lives on. Images are (..., H, W, 3) with channels last.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# RGB -> LMS (Hunt-Pointer-Estevez-like), row i = cone i weights.
M_RGB_TO_LMS = np.array(
    [
        [0.31399022, 0.63951294, 0.04649755],  # L
        [0.15537241, 0.75789446, 0.08670142],  # M
        [0.01775239, 0.10944209, 0.87256922],  # S
    ],
    dtype=np.float32,
)

# LMS -> RGB inverse (float64, as in the reference).
M_LMS_TO_RGB = np.array(
    [
        [5.472213, -4.6419606, 0.16963711],
        [-1.125242, 2.2931712, -0.16789523],
        [0.02980164, -0.19318072, 1.1636479],
    ],
    dtype=np.float64,
)

_SRGB_A = 0.055


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    """sRGB-encoded [0,1] -> linear light. IEC 61966-2-1 EOCF."""
    a = _SRGB_A
    return torch.where(x <= 0.04045, x / 12.92, ((x + a) / (1 + a)) ** 2.4)


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    """Linear light -> sRGB-encoded; negatives are clamped before the power."""
    a = _SRGB_A
    safe = torch.clamp(x, min=0.0)
    return torch.where(x <= 0.0031308, 12.92 * x, (1 + a) * safe ** (1 / 2.4) - a)


@functools.lru_cache(maxsize=None)
def collapse_lms_matrix(alpha: float, s_scale: float) -> np.ndarray:
    """3x3 linear-RGB -> linear-RGB dichromat matrix, applied as ``pixels @ T.T``.

    RGB basis -> LMS (float32), L and M collapsed to alpha*L + (1-alpha)*M,
    S scaled by s_scale, back to RGB through the float64 inverse, cast to
    float32. Like the reference, this applies the transpose of the explicit
    row-vector LMS chain that the cat uses.
    """
    basis = np.eye(3, dtype=np.float32)
    lms = basis @ M_RGB_TO_LMS.T
    collapse = np.array(
        [
            [alpha, 1.0 - alpha, 0.0],
            [alpha, 1.0 - alpha, 0.0],
            [0.0, 0.0, s_scale],
        ],
        dtype=np.float32,
    )
    collapsed = lms @ collapse.T
    rgb_out = collapsed @ M_LMS_TO_RGB.T  # promotes to float64
    return rgb_out.astype(np.float32)


def apply_color_matrix(img: torch.Tensor, matrix) -> torch.Tensor:
    """Apply a 3x3 color matrix (NumPy array or tensor) as ``pixels @ M.T``."""
    m = torch.as_tensor(matrix, dtype=img.dtype, device=img.device)
    return torch.einsum("...j,ij->...i", img, m)


def merge_l_m(lms: torch.Tensor, alpha: float) -> torch.Tensor:
    """Merge the L and M cones of (..., 3) LMS: LM = alpha L + (1-alpha) M,
    S kept."""
    lm = alpha * lms[..., 0] + (1.0 - alpha) * lms[..., 1]
    return torch.stack([lm, lm, lms[..., 2]], dim=-1)


def srgb_to_lms(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB -> LMS by the forward matrix."""
    return apply_color_matrix(img, M_RGB_TO_LMS)


def lms_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) LMS -> RGB by the inverse matrix, cast to float32."""
    return apply_color_matrix(img, M_LMS_TO_RGB.astype(np.float32))


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """float32 in [0,1]: divide by 255 iff the frame's max exceeds 1.

    The select is taken per frame over the last three (H, W, C) axes, so a
    batch (N, H, W, C) behaves like N single frames."""
    x = img.to(torch.float32)
    mx = torch.amax(x, dim=(-3, -2, -1), keepdim=True)
    scale = torch.where(mx > 1.0, 1.0 / 255.0, 1.0)
    return torch.clamp(x * scale, 0.0, 1.0)


def to_float01(img: torch.Tensor) -> torch.Tensor:
    """float32 in [0,1], the UV path's convention: integer frames divide by
    255 with no clip; float frames divide by 255, then clip, only where the
    frame's max exceeds 1.001. The test is per frame over the last three
    (H, W, C) axes, on the frames' device."""
    if not img.dtype.is_floating_point:
        return img.to(torch.float32) / 255.0
    x = img.to(torch.float32)
    needs = torch.amax(x, dim=(-3, -2, -1), keepdim=True) > 1.001
    return torch.where(needs, torch.clamp(x / 255.0, 0.0, 1.0), x)


def from_float01(img01: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float [0,1] -> ``dtype``; integers get ``clip(x*255 + 0.5, 0, 255)``
    truncated, as the reference's UV helpers do."""
    if not dtype.is_floating_point:
        return torch.clamp(img01 * 255.0 + 0.5, 0.0, 255.0).to(dtype)
    return img01.to(dtype)


def encode_output(linear_img: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """clip -> linear_to_srgb -> clip -> dtype restore.

    Integer outputs are ``(s*255 + 0.5)`` truncated, as the reference does."""
    srgb = torch.clamp(linear_to_srgb(torch.clamp(linear_img, 0.0, 1.0)), 0.0, 1.0)
    if not dtype.is_floating_point:
        return (srgb * 255.0 + 0.5).to(dtype)
    return srgb.to(dtype)
