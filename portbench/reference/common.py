"""Plain float32 PyTorch pieces shared by the references.

Frozen from the port's plain composition and its host tables (OpenCV's
semantics: auto kernel sizes, reflect-101 borders, INTER_LINEAR taps), so
that a later change to the program cannot move the yardstick. Imports
nothing of the program. Images are (..., H, W, C) with channels last.

``precision(tf32)`` sets how cuBLAS and cuDNN run float32 products for the
block: off for the reference, on for its control (the nearest precision
below the configuration's float32).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

M_RGB_TO_LMS = np.array(
    [
        [0.31399022, 0.63951294, 0.04649755],
        [0.15537241, 0.75789446, 0.08670142],
        [0.01775239, 0.10944209, 0.87256922],
    ],
    dtype=np.float32,
)
M_LMS_TO_RGB = np.array(
    [
        [5.472213, -4.6419606, 0.16963711],
        [-1.125242, 2.2931712, -0.16789523],
        [0.02980164, -0.19318072, 1.1636479],
    ],
    dtype=np.float64,
)
EPS = 1e-8


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 products in full precision (``tf32=False``) or in TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def table(a, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)


# ---------------------------------------------------------------- colour


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    safe = torch.clamp(x, min=0.0)
    return torch.where(x <= 0.0031308, 12.92 * x, 1.055 * safe ** (1 / 2.4) - 0.055)


def collapse_lms_matrix(alpha: float, s_scale: float) -> np.ndarray:
    """The dichromat matrix: RGB -> LMS (float32), L and M merged by alpha,
    S scaled, back through the float64 inverse, float32."""
    lms = np.eye(3, dtype=np.float32) @ M_RGB_TO_LMS.T
    collapse = np.array(
        [[alpha, 1.0 - alpha, 0.0], [alpha, 1.0 - alpha, 0.0], [0.0, 0.0, s_scale]], dtype=np.float32
    )
    return ((lms @ collapse.T) @ M_LMS_TO_RGB.T).astype(np.float32)


def apply_color_matrix(img: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...j,ij->...i", img, m)


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1]: / 255 where the frame's max exceeds 1."""
    x = img.to(torch.float32)
    mx = torch.amax(x, dim=(-3, -2, -1), keepdim=True)
    return torch.clamp(x * torch.where(mx > 1.0, 1.0 / 255.0, 1.0), 0.0, 1.0)


def encode_u8(linear: torch.Tensor) -> torch.Tensor:
    srgb = torch.clamp(linear_to_srgb(torch.clamp(linear, 0.0, 1.0)), 0.0, 1.0)
    return (srgb * 255.0 + 0.5).to(torch.uint8)


# ---------------------------------------------------------------- blurs


def cv2_auto_ksize(sigma: float) -> int:
    return max(int(np.round(sigma * 4 * 2 + 1)) | 1, 1)


def uv_ksize(sigma: float) -> int:
    return int(2 * math.ceil(3 * sigma) + 1)


def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    """OpenCV's getGaussianKernel: float64 taps normalised to 1, float32."""
    if ksize == 1:
        return np.ones((1,), dtype=np.float32)
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def reflect101(p, n: int):
    if n == 1:
        return np.zeros_like(np.asarray(p))
    period = 2 * (n - 1)
    m = np.mod(p, period)
    return np.where(m < n, m, period - m)


def pad_reflect101(img: torch.Tensor, pad: int, axis: int) -> torch.Tensor:
    if pad == 0:
        return img
    n = int(img.shape[axis])
    idx = torch.from_numpy(reflect101(np.arange(-pad, n + pad), n).astype(np.int64)).to(img.device)
    return torch.index_select(img, axis, idx)


def conv1d_axis(img: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """Correlate with 1-D ``taps`` along ``axis``, reflect-101, as a sum of
    shifted slices in tap order."""
    k = table(taps, img.device)
    if k.numel() == 1:
        return img * k[0]
    n = img.shape[axis]
    padded = pad_reflect101(img, k.numel() // 2, axis)
    out = None
    for t in range(k.numel()):
        term = padded.narrow(axis, t, n) * k[t]
        out = term if out is None else out + term
    return out


def gaussian_blur_hwc(img: torch.Tensor, sigma: float, ksize: int | None = None) -> torch.Tensor:
    """Isotropic Gaussian of (..., H, W, C), W pass first; OpenCV's auto
    kernel size unless ``ksize``."""
    k = ksize or cv2_auto_ksize(sigma)
    taps = gaussian_kernel_1d(k, float(sigma))
    return conv1d_axis(conv1d_axis(img, taps, -2), taps, -3)


def streak_sigma_map(h: int, y_center: float, sigma_streak: float, sigma_far: float, falloff: float):
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)
    d = np.abs(yy - y_center)
    smap = sigma_streak + (sigma_far - sigma_streak) * (1.0 - np.exp(-falloff * d * d))
    return np.maximum(0.4, 0.5 * smap), smap


def _row_table(sigmas: np.ndarray) -> np.ndarray:
    ks = [cv2_auto_ksize(float(s)) for s in sigmas]
    kmax = max(ks)
    tab = np.zeros((len(sigmas), kmax), dtype=np.float32)
    for y, (s, k) in enumerate(zip(sigmas, ks)):
        off = (kmax - k) // 2
        tab[y, off:off + k] = gaussian_kernel_1d(k, float(s))
    return tab


def _channel_mix(ksize: int, sigma: float) -> np.ndarray:
    """A Gaussian over the 3-long channel axis (reflect-101) as a matrix."""
    kern = gaussian_kernel_1d(ksize, sigma).astype(np.float64)
    r = ksize // 2
    m = np.zeros((3, 3), dtype=np.float64)
    for c in range(3):
        for t in range(ksize):
            m[c, int(reflect101(c + t - r, 3))] += kern[t]
    return m.astype(np.float32)


def _rowwise_w(img: torch.Tensor, tab: np.ndarray) -> torch.Tensor:
    w, kmax = img.shape[-2], tab.shape[1]
    padded = pad_reflect101(img, kmax // 2, -2)
    t = table(tab, img.device)
    out = None
    for i in range(kmax):
        term = padded.narrow(-2, i, w) * t[:, i][:, None, None]
        out = term if out is None else out + term
    return out


def streak_blur(img: torch.Tensor, params) -> torch.Tensor:
    """The visual-streak blur with the reference's row-as-image quirk: each
    row blurs along W with sigmaX[y] and mixes its channels with the same
    kernel, then blurs along W with sigmaY[y]; nothing blurs vertically."""
    sx, sy = streak_sigma_map(int(img.shape[-3]), *params)
    mix = np.stack([_channel_mix(cv2_auto_ksize(float(s)), float(s)) for s in sx])
    out = _rowwise_w(img, _row_table(sx))
    out = torch.einsum("hij,...hwj->...hwi", table(mix, img.device), out)
    return _rowwise_w(out, _row_table(sy))


def chroma_compression(img: torch.Tensor, strength: float) -> torch.Tensor:
    gray = torch.mean(img, dim=-1, keepdim=True)
    return gray + (img - gray) * (1.0 - strength)


def s_cone_ramp(h: int, s_top: float, s_bottom: float, power: float, extra: float) -> np.ndarray:
    w = np.linspace(s_top, s_bottom, h, dtype=np.float32)
    if power != 1.0:
        t = np.clip((w - s_bottom) / max(1e-8, s_top - s_bottom), 0.0, 1.0) ** power
        w = s_bottom + (s_top - s_bottom) * t
    if extra != 0.0:
        w = 1.0 + extra * (w - 1.0)
    return np.asarray(w, dtype=np.float32)


def s_cone_gain(img: torch.Tensor, params) -> torch.Tensor:
    gain = table(s_cone_ramp(int(img.shape[-3]), *params), img.device)[:, None]
    blue = torch.clamp(img[..., 2] * gain, 0.0, 1.0)
    return torch.cat([img[..., :2], blue[..., None]], dim=-1)


# ---------------------------------------------------------------- geometry


def linear_resize_matrix(src: int, dst: int) -> np.ndarray:
    """OpenCV INTER_LINEAR along one axis as a dense (src, dst) matrix."""
    scale = src / dst
    fx = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx
    fx = np.where(sx < 0, 0.0, fx)
    sx = np.maximum(sx, 0)
    fx = np.where(sx >= src - 1, 1.0, fx)
    sx = np.minimum(sx, max(src - 2, 0))
    idx = np.stack([sx, np.minimum(sx + 1, src - 1)]).astype(np.int32)
    w = np.stack([1.0 - fx, fx]).astype(np.float32)
    m = np.zeros((src, dst), dtype=np.float64)
    for t in range(2):
        for d in range(dst):
            m[idx[t, d], d] += w[t, d]
    return m.astype(np.float32)


def binocular_warp(w: int, fov_in_deg: float, half_fov_deg: float, overlap_deg: float) -> np.ndarray:
    """The cat's two-eye warp as one (W, W) column matrix: each eye's
    bilinear taps, validity mask and cos^2 blend, normalised by the sum of
    the blends."""
    phi = np.deg2rad(half_fov_deg)
    psi = np.deg2rad(fov_in_deg * 0.5)
    alpha = max(0.0, phi - 0.5 * np.deg2rad(overlap_deg))
    theta = np.linspace(-1.0, 1.0, w, dtype=np.float32) * phi
    blend = (np.cos(0.5 * np.pi * (theta / phi)) ** 2).astype(np.float32)
    eyes = []
    for gamma in (theta - alpha, theta + alpha):
        xs = ((gamma / psi) * (w * 0.5) + (w * 0.5)).astype(np.float32)
        eyes.append((xs, blend * (np.abs(gamma) <= psi).astype(np.float32)))
    wsum = eyes[0][1] + eyes[1][1] + 1e-8
    total = np.zeros((w, w), dtype=np.float32)
    for xs, wt in eyes:
        m = np.zeros((w, w), dtype=np.float64)
        for x in range(w):
            wn = float(wt[x]) / float(wsum[x])
            if wn == 0.0:
                continue
            x0 = int(np.floor(float(xs[x])))
            fx = float(xs[x]) - x0
            if 0 <= x0 < w:
                m[x0, x] += wn * (1.0 - fx)
            if 0 <= x0 + 1 < w:
                m[x0 + 1, x] += wn * fx
        total = total + m.astype(np.float32)
    return total


def zoom_scale(camera_hfov_deg: float, half_fov_deg: float, ratio: float) -> float:
    eff = min(float(camera_hfov_deg), 2.0 * float(half_fov_deg))
    cam = math.tan(math.radians(camera_hfov_deg) * 0.5)
    hum = math.tan(math.radians(eff / max(1.01, float(ratio))) * 0.5)
    return float(cam / max(hum, 1e-6))


# ---------------------------------------------------------------- statistics


def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """Per-frame ``np.percentile(frame, q)`` (linear, float32 rank) of
    (..., H, W, C), as (..., 1, 1, 1)."""
    flat = x.to(torch.float32).reshape(*x.shape[:-3], -1)
    n = int(flat.shape[-1])
    v = (n - 1) * np.asanyarray(np.true_divide(q, np.float32(100)))
    if v >= n - 1:
        lo, hi, g = n - 1, n - 1, 0.0
    else:
        lo = int(np.floor(v))
        hi, g = lo + 1, float(np.float32(v - lo))
    s = torch.sort(flat, dim=-1).values
    a, b = s[..., lo], s[..., hi]
    if g >= 0.5:
        out = b - (b - a) * float(np.float32(1.0) - np.float32(g))
    else:
        out = a + (b - a) * g
    return out.reshape(*x.shape[:-3], 1, 1, 1)
