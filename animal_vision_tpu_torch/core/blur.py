"""Gaussian blurs with OpenCV-matched semantics.

Counterpart of ``animal_vision_tpu/core/blur.py``. Kernel sizes, tap
weights, reflect-101 indices, the per-row streak tables and the scanline
profiles (``blur_profile_1d``) are NumPy host tables, identical to the JAX
package's; the blurs themselves are PyTorch shifted-slice sums over
(..., H, W, C) tensors. The UV blur
(``gaussian_blur_uv``) goes through the ``blur_uv`` kernel on the card.

The per-row "visual streak" blur keeps the reference's quirk: each (W, 3)
image row goes through ``cv2.GaussianBlur`` as a W x 3 single-channel
image, so pass 1 blurs along W with sigmaX[y] and also mixes the three
channels with the same kernel (reflect-101 over the 3-long channel axis),
pass 2 blurs along W with sigmaY[y], and nothing blurs vertically.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from animal_vision_tpu_torch.core.tables import device_table


def cv2_auto_ksize(sigma: float, uint8_depth: bool = False) -> int:
    """OpenCV's automatic Gaussian kernel size for ``ksize=(0,0)``:
    ``round(sigma * (3 if 8U else 4) * 2 + 1) | 1`` with banker's rounding."""
    factor = 3 if uint8_depth else 4
    k = int(np.round(sigma * factor * 2 + 1)) | 1
    return max(k, 1)


def uv_ksize(sigma: float) -> int:
    """The UV helper's explicit kernel size ``2*ceil(3*sigma)+1``."""
    return int(2 * math.ceil(3 * sigma) + 1)


@functools.lru_cache(maxsize=None)
def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """OpenCV ``getGaussianKernel``: float64 exp taps normalized to sum 1,
    cast to float32."""
    if ksize == 1:
        return np.ones((1,), dtype=np.float32)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k /= k.sum()
    return k.astype(np.float32)


def reflect101_index(p, n: int):
    """Map (possibly out-of-range) coordinates onto [0, n) with
    BORDER_REFLECT_101 (``gfedcb|abcdefgh|gfedcba``), for borders of any
    width through the period-2(n-1) reflection."""
    if n == 1:
        return np.zeros_like(np.asarray(p))
    period = 2 * (n - 1)
    m = np.mod(p, period)
    return np.where(m < n, m, period - m)


@functools.lru_cache(maxsize=256)
def _reflect_index(n: int, pad: int, device: str) -> torch.Tensor:
    """The reflect-101 source index of each of the n + 2*pad padded
    positions, as an int64 tensor on ``device``, made once."""
    idx = reflect101_index(np.arange(-pad, n + pad), n).astype(np.int64)
    return torch.from_numpy(idx).to(device)


def _pad_reflect101(img: torch.Tensor, pad: int, axis: int) -> torch.Tensor:
    """Pad ``img`` along ``axis`` by ``pad`` on both sides with reflect-101."""
    if pad == 0:
        return img
    return torch.index_select(img, axis, _reflect_index(int(img.shape[axis]), pad, str(img.device)))


def conv1d_axis(img: torch.Tensor, kernel, axis: int) -> torch.Tensor:
    """Correlate ``img`` with a 1-D ``kernel`` (NumPy array or tensor) along
    ``axis`` with reflect-101 borders, as a sum of shifted slices."""
    k = torch.as_tensor(kernel, dtype=img.dtype, device=img.device)
    taps = int(k.shape[0])
    if taps == 1:
        return img * k[0]
    pad = taps // 2
    padded = _pad_reflect101(img, pad, axis)
    n = img.shape[axis]
    out = None
    for t in range(taps):
        term = padded.narrow(axis, t, n) * k[t]
        out = term if out is None else out + term
    return out


def gaussian_blur(
    img: torch.Tensor,
    sigma_x: float,
    sigma_y: float | None = None,
    ksize: tuple[int, int] | None = None,
    axes: tuple[int, int] = (-2, -3),
) -> torch.Tensor:
    """Separable Gaussian blur, like ``cv2.GaussianBlur(img, ksize or (0,0),
    sigma_x, sigma_y)`` on float32 with reflect-101 borders: the x pass
    first. ``axes`` is (x axis, y axis): the default fits (..., H, W, C);
    (-1, -2) fits (..., H, W). A ``sigma_y`` of None or <= 0 is
    ``sigma_x``, and a kernel size <= 0 (or ``ksize`` None) is OpenCV's
    automatic one."""
    if sigma_y is None or sigma_y <= 0:
        sigma_y = sigma_x
    kx, ky = ksize if ksize is not None else (0, 0)
    kx = kx if kx > 0 else cv2_auto_ksize(sigma_x)
    ky = ky if ky > 0 else cv2_auto_ksize(sigma_y)
    out = conv1d_axis(img, device_table(gaussian_kernel_1d(kx, float(sigma_x)), img.device), axes[0])
    return conv1d_axis(out, device_table(gaussian_kernel_1d(ky, float(sigma_y)), img.device), axes[1])


def gaussian_blur_hwc(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Auto-ksize isotropic Gaussian blur of (..., H, W, C), W pass first,
    like ``cv2.GaussianBlur(img, (0,0), sigma)`` on float32."""
    return gaussian_blur(img, sigma, sigma, axes=(-2, -3))


def gaussian_blur_hw(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Auto-ksize isotropic Gaussian blur of (..., H, W) arrays."""
    return gaussian_blur(img, sigma, sigma, axes=(-1, -2))


def uv_taps(sigma: float, device) -> torch.Tensor:
    """The ``uv_ksize(sigma)`` Gaussian taps as a float32 tensor on
    ``device``, made once per (sigma, device)."""
    return device_table(gaussian_kernel_1d(uv_ksize(sigma), float(sigma)), device)


def gaussian_blur_uv(img: torch.Tensor, sigma: float, plain: bool = False) -> torch.Tensor:
    """UV-helper blur of (..., H, W, C) with an explicit trailing channel
    axis (C = 1 for a map): ``k = 2*ceil(3*sigma)+1`` taps, reflect-101, W
    pass first. The input unchanged when ``sigma <= 0``. Runs the
    ``blur_uv`` kernel (its plain version on the CPU, or where ``plain``)."""
    from animal_vision_tpu_torch.ops import fused_blur  # it imports this module

    if sigma <= 0:
        return img
    taps = uv_taps(float(sigma), img.device)
    frames = img.reshape(-1, *img.shape[-3:])
    out = fused_blur.blur_uv_plain(frames, taps) if plain else fused_blur.blur_uv(frames, taps)
    return out.reshape(img.shape)


def blur_profile_1d(profile: np.ndarray, sigma: float) -> np.ndarray:
    """The UV blur (``uv_ksize`` taps, reflect-101) of a per-row (H,)
    profile, in NumPy: the scanline row gains. The reference blurs an
    (H, W) row-constant image; its W pass is the identity, so the blur folds
    to this 1-D pass, computed once on the host."""
    if sigma <= 0:
        return profile.astype(np.float32)
    k = uv_ksize(sigma)
    kern = gaussian_kernel_1d(k, sigma).astype(np.float32)
    r = k // 2
    n = profile.shape[0]
    padded = profile.astype(np.float32)[reflect101_index(np.arange(-r, n + r), n)]
    out = np.zeros(n, dtype=np.float32)
    for t in range(k):
        out += kern[t] * padded[t : t + n]
    return out


def _channel_mix_matrix(ksize: int, sigma: float, channels: int = 3) -> np.ndarray:
    """Fold a 1-D Gaussian applied over a ``channels``-long axis (reflect-101,
    any number of reflections) into a channels x channels matrix."""
    kern = gaussian_kernel_1d(ksize, sigma).astype(np.float64)
    r = ksize // 2
    m = np.zeros((channels, channels), dtype=np.float64)
    for c in range(channels):
        for t in range(ksize):
            src = reflect101_index(c + t - r, channels)
            m[c, int(src)] += kern[t]
    return m.astype(np.float32)


def streak_sigma_map(
    height: int,
    y_center: float,
    sigma_streak: float,
    sigma_far: float,
    falloff: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-row (sigmaX, sigmaY) of the visual-streak blur: sigma rises away
    from the streak row, and sigmaX = max(0.4, 0.5*sigma)."""
    yy = np.linspace(0.0, 1.0, height, dtype=np.float32)
    d = np.abs(yy - y_center)
    smap = sigma_streak + (sigma_far - sigma_streak) * (1.0 - np.exp(-falloff * d * d))
    return np.maximum(0.4, 0.5 * smap), smap


def _row_kernel_table(sigmas: np.ndarray) -> tuple[np.ndarray, int]:
    """Stack per-row auto-ksize Gaussian kernels into an (H, Kmax) table,
    zero-padded and centered."""
    ks = [cv2_auto_ksize(float(s)) for s in sigmas]
    kmax = max(ks)
    table = np.zeros((len(sigmas), kmax), dtype=np.float32)
    for y, (s, k) in enumerate(zip(sigmas, ks)):
        kern = gaussian_kernel_1d(k, float(s))
        off = (kmax - k) // 2
        table[y, off : off + k] = kern
    return table, kmax


def _rowwise_conv_w(img: torch.Tensor, table: np.ndarray, kmax: int) -> torch.Tensor:
    """Per-row 1-D convolution along W of (..., H, W, C), one kernel per row
    from an (H, Kmax) table, reflect-101 along W."""
    w = img.shape[-2]
    padded = _pad_reflect101(img, kmax // 2, axis=-2)
    tab = torch.from_numpy(table).to(img.device)
    out = None
    for t in range(kmax):
        term = padded.narrow(-2, t, w) * tab[:, t][:, None, None]
        out = term if out is None else out + term
    return out


@functools.lru_cache(maxsize=64)
def _streak_host_tables(h: int, params: tuple):
    """(pass-1 table, pass-1 width, (H, 3, 3) channel mixes, pass-2 table,
    pass-2 width) of ``streak_blur`` for ``h`` rows."""
    sx, sy = streak_sigma_map(h, *params)
    tab1, kmax1 = _row_kernel_table(sx)
    mix = np.stack(
        [_channel_mix_matrix(cv2_auto_ksize(float(s)), float(s)) for s in sx], axis=0
    )
    tab2, kmax2 = _row_kernel_table(sy)
    return tab1, kmax1, mix, tab2, kmax2


def streak_blur(
    img: torch.Tensor,
    y_center: float = 0.5,
    sigma_streak: float = 0.8,
    sigma_far: float = 2.2,
    falloff: float = 6.0,
) -> torch.Tensor:
    """Anisotropic acuity blur with a sharp horizontal visual streak, on
    (..., H, W, 3), including the reference's row-as-image quirk (module
    docstring): pass 1 (sigmaX[y] along W plus the per-row channel mix),
    then pass 2 (sigmaY[y] along W)."""
    params = (y_center, sigma_streak, sigma_far, falloff)
    tab1, kmax1, mix, tab2, kmax2 = _streak_host_tables(int(img.shape[-3]), params)
    out = _rowwise_conv_w(img, tab1, kmax1)
    out = torch.einsum("hij,...hwj->...hwi", torch.from_numpy(mix).to(img.device), out)
    return _rowwise_conv_w(out, tab2, kmax2)
