"""Geometry: cv2-exact resize and the UV panorama warp, and the cat's
tables (linear resize and binocular FOV warp as dense per-axis matrices).

Counterpart of ``animal_vision_tpu/core/geometry.py``'s resize family,
``panorama_warp`` and the cat's tables. Tap indices and weights are NumPy,
with OpenCV's float-path coefficient formulas, identical to the JAX
package's. ``resize`` and ``panorama_warp`` apply them per axis on the
device as ``torch.index_select`` gathers and weighted sums in tap order
(the JAX package's CPU path), over (..., H, W, C) tensors. The cat's device
work is a matrix product per axis (``core/linalg.py``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def _linear_taps(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """cv2 INTER_LINEAR float path: fx=(x+0.5)*scale-0.5 with edge clamping."""
    scale = src / dst
    dx = np.arange(dst, dtype=np.float64)
    fx = (dx + 0.5) * scale - 0.5
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx
    fx = np.where(sx < 0, 0.0, fx)
    sx = np.maximum(sx, 0)
    fx = np.where(sx >= src - 1, 1.0, fx)
    sx = np.minimum(sx, max(src - 2, 0))
    idx = np.stack([sx, np.minimum(sx + 1, src - 1)], axis=0)
    w = np.stack([1.0 - fx, fx], axis=0)
    return idx.astype(np.int32), w.astype(np.float32)


def _cubic_taps(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """cv2 INTER_CUBIC (Keys, A=-0.75) with replicate-clamped indices."""
    a = -0.75
    scale = src / dst
    dx = np.arange(dst, dtype=np.float64)
    fx = (dx + 0.5) * scale - 0.5
    sx = np.floor(fx).astype(np.int64)
    t = fx - sx
    w0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    w1 = ((a + 2) * t - (a + 3)) * t * t + 1
    w2 = ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1
    w3 = 1.0 - w0 - w1 - w2
    idx = np.stack([sx - 1, sx, sx + 1, sx + 2], axis=0)
    idx = np.clip(idx, 0, src - 1)
    w = np.stack([w0, w1, w2, w3], axis=0)
    return idx.astype(np.int32), w.astype(np.float32)


def _nearest_taps(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """cv2 INTER_NEAREST: sx = floor(x*scale), clamped (no center offset)."""
    scale = src / dst
    sx = np.clip(np.floor(np.arange(dst) * scale), 0, src - 1)
    return sx[None].astype(np.int32), np.ones((1, dst), dtype=np.float32)


def _area_matrix(src: int, dst: int) -> np.ndarray:
    """cv2 INTER_AREA general downscale: fractional box coverage per axis,
    as a dense (dst, src) matrix."""
    scale = src / dst
    m = np.zeros((dst, src), dtype=np.float64)
    for x in range(dst):
        start = x * scale
        end = min((x + 1) * scale, float(src))
        j0 = int(math.floor(start))
        j1 = int(math.ceil(end))
        for j in range(j0, min(j1, src)):
            ov = min(end, j + 1) - max(start, j)
            if ov > 0:
                m[x, j] = ov / scale
    return m.astype(np.float32)


def _area_upscale_taps(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """cv2 INTER_AREA when upscaling: modified-linear coefficients
    (sx=floor(dx*scale); fx=(dx+1)-(sx+1)*inv_scale; fx<=0 -> 0)."""
    scale = src / dst
    inv_scale = dst / src
    dx = np.arange(dst, dtype=np.float64)
    sx = np.floor(dx * scale).astype(np.int64)
    fx = (dx + 1) - (sx + 1) * inv_scale
    fx = np.where(fx <= 0, 0.0, fx - np.floor(fx))
    fx = np.where(sx >= src - 1, 0.0, fx)
    sx = np.minimum(sx, src - 1)
    idx = np.stack([sx, np.minimum(sx + 1, src - 1)], axis=0)
    w = np.stack([1.0 - fx, fx], axis=0)
    return idx.astype(np.int32), w.astype(np.float32)


_TAP_BUILDERS = {
    "linear": _linear_taps,
    "cubic": _cubic_taps,
    "nearest": _nearest_taps,
    "area": _area_upscale_taps,
}


def _taps_to_dense(idx: np.ndarray, w: np.ndarray, src: int) -> np.ndarray:
    """Fold per-output tap (indices, weights) into a dense (src, dst) matrix."""
    dst = idx.shape[1]
    m = np.zeros((src, dst), dtype=np.float64)
    for t in range(idx.shape[0]):
        for d in range(dst):
            m[idx[t, d], d] += w[t, d]
    return m.astype(np.float32)


def _dense_to_taps(m: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """A dense (dst, src) matrix as taps: each output's nonzero sources in
    increasing order, padded with index 0 and weight 0."""
    nz = [np.nonzero(row)[0] for row in m]
    taps = max(1, max(len(c) for c in nz))
    idx = np.zeros((taps, m.shape[0]), dtype=np.int32)
    w = np.zeros((taps, m.shape[0]), dtype=np.float32)
    for d, cols in enumerate(nz):
        idx[: len(cols), d] = cols
        w[: len(cols), d] = m[d, cols]
    return idx, w


def dense_axis_matrix(src: int, dst: int, interp: str) -> np.ndarray:
    """(dst, src) dense resize matrix for one axis, cv2-exact coefficients."""
    if interp == "area" and dst <= src:
        return _area_matrix(src, dst)
    idx, w = _TAP_BUILDERS[interp](src, dst)
    return _taps_to_dense(idx, w, src).T.copy()


@functools.lru_cache(maxsize=None)
def _resize_plan(src_hw: tuple[int, int], dst_hw: tuple[int, int], interp: str):
    """Per-axis (indices (T, dst), weights (T, dst)) tap plans, (H, W).
    cv2 takes the true area algorithm only when downscaling both axes."""
    (sh, sw), (dh, dw) = src_hw, dst_hw
    if interp == "area" and dh <= sh and dw <= sw:
        return (_dense_to_taps(dense_axis_matrix(sh, dh, "area")),
                _dense_to_taps(dense_axis_matrix(sw, dw, "area")))
    build = _TAP_BUILDERS[interp]
    return build(sh, dh), build(sw, dw)


def _to_device(idx: np.ndarray, w: np.ndarray, device: str):
    """One axis' taps as (int64 indices, float32 weights) on ``device``."""
    return (torch.from_numpy(idx.astype(np.int64)).to(device),
            torch.from_numpy(np.ascontiguousarray(w, dtype=np.float32)).to(device))


@functools.lru_cache(maxsize=64)
def _device_resize(src_hw: tuple[int, int], dst_hw: tuple[int, int], interp: str, device: str):
    """``_resize_plan``'s (H taps, W taps) on ``device``, made once."""
    (iy, wy), (ix, wx) = _resize_plan(src_hw, dst_hw, interp)
    return _to_device(iy, wy, device), _to_device(ix, wx, device)


@functools.lru_cache(maxsize=64)
def _device_panorama(w: int, scale_x: float, device: str):
    """The kept columns' cubic W taps of ``panorama_warp``."""
    new_w = max(2, int(np.round(w * scale_x)))
    idx, wgt = _cubic_taps(w, new_w)
    if new_w != w:
        start = (new_w - w) // 2
        idx, wgt = idx[:, start : start + w], wgt[:, start : start + w]
    return _to_device(idx, wgt, device)


def _apply_taps(img: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """Gather and weight along ``axis`` (-3 for H, -2 for W) of
    (..., H, W, C), summing the taps in order."""
    idx, w = taps
    view = (-1, 1, 1) if axis == -3 else (-1, 1)
    out = None
    for t in range(idx.shape[0]):
        term = torch.index_select(img, axis, idx[t]) * w[t].view(view)
        out = term if out is None else out + term
    return out


def resize(img: torch.Tensor, dst_hw: tuple[int, int], interp: str = "linear") -> torch.Tensor:
    """Resize (..., H, W, C) to ``dst_hw`` with cv2-matched ``linear`` /
    ``cubic`` / ``nearest`` / ``area`` coefficients, in float32, H first."""
    src_hw = (int(img.shape[-3]), int(img.shape[-2]))
    dst_hw = (int(dst_hw[0]), int(dst_hw[1]))
    if src_hw == dst_hw and interp != "area":
        return img
    taps_y, taps_x = _device_resize(src_hw, dst_hw, interp, str(img.device))
    return _apply_taps(_apply_taps(img, taps_y, -3), taps_x, -2)


def panorama_warp(img: torch.Tensor, scale_x: float) -> torch.Tensor:
    """Widen (..., H, W, C) horizontally by ``scale_x`` with INTER_CUBIC and
    center-crop back to W. Only the kept columns' W taps run: the cubic
    taps of H to H are the identity (weights 0, 1, 0, 0)."""
    if abs(scale_x - 1.0) < 1e-3:
        return img
    return _apply_taps(img, _device_panorama(int(img.shape[-2]), float(scale_x), str(img.device)), -2)


def resize_matrix(src: int, dst: int) -> np.ndarray:
    """A 1-D cv2 INTER_LINEAR resize as a dense (src, dst) float32 matrix."""
    return _taps_to_dense(*_linear_taps(src, dst), src)


def zoom_scale_from_fov_ratio(
    camera_hfov_deg: float, per_eye_half_fov_deg: float, animal_to_human_ratio: float
) -> float:
    """scale = tan(cam/2) / tan((eff_fov/ratio)/2)."""
    phi = float(per_eye_half_fov_deg)
    eff = min(float(camera_hfov_deg), 2.0 * phi)
    ratio = max(1.01, float(animal_to_human_ratio))
    cam = math.tan(math.radians(camera_hfov_deg) * 0.5)
    hum = math.tan(math.radians(eff / ratio) * 0.5)
    return float(cam / max(hum, 1e-6))


@functools.lru_cache(maxsize=None)
def _binocular_maps(
    in_hw: tuple[int, int],
    out_hw: tuple[int, int],
    fov_in_deg: float,
    per_eye_half_fov_deg: float,
    overlap_deg: float,
):
    """Per-eye remap coordinates, row map and cos^2 blend weights (masked
    by each eye's validity)."""
    h_in, w_in = in_hw
    out_h, out_w = out_hw
    phi = np.deg2rad(per_eye_half_fov_deg)
    psi = np.deg2rad(fov_in_deg * 0.5)
    ov = np.deg2rad(overlap_deg)
    alpha = max(0.0, phi - 0.5 * ov)

    u = np.linspace(-1.0, 1.0, out_w, dtype=np.float32)
    uu = np.broadcast_to(u[None, :], (out_h, out_w))
    theta = uu * phi
    gamma_l = theta - alpha
    gamma_r = theta + alpha

    def to_xsrc(g):
        return ((g / psi) * (w_in * 0.5) + (w_in * 0.5)).astype(np.float32)

    ymap = np.repeat(
        np.linspace(0, h_in - 1, out_h, dtype=np.float32)[:, None], out_w, axis=1
    )
    valid_l = (np.abs(gamma_l) <= psi).astype(np.float32)
    valid_r = (np.abs(gamma_r) <= psi).astype(np.float32)
    w_l = (np.cos(0.5 * np.pi * (theta / phi)) ** 2).astype(np.float32) * valid_l
    w_r = (np.cos(0.5 * np.pi * (theta / phi)) ** 2).astype(np.float32) * valid_r
    return to_xsrc(gamma_l), to_xsrc(gamma_r), ymap, w_l, w_r


@functools.lru_cache(maxsize=None)
def binocular_warp_matrices(
    in_w: int,
    out_w: int,
    fov_in_deg: float,
    per_eye_half_fov_deg: float,
    overlap_deg: float,
    out_h_probe: int = 2,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-eye (W_in, W_out) float32 warp matrices, blend-normalized.

    The warp's source columns and weights depend only on the output column,
    so each eye's remap with its bilinear taps, validity mask, black border
    and cos^2 blend is one column matrix: ``warped = img @ (M_l + M_r)``."""
    xl, xr, _ymap, w_l, w_r = _binocular_maps(
        (out_h_probe, in_w),
        (out_h_probe, out_w),
        fov_in_deg,
        per_eye_half_fov_deg,
        overlap_deg,
    )
    wsum = w_l[0] + w_r[0] + 1e-8
    out = []
    for eye_x, eye_w in ((xl[0], w_l[0]), (xr[0], w_r[0])):
        m = np.zeros((in_w, out_w), dtype=np.float64)
        for x in range(out_w):
            wn = float(eye_w[x]) / float(wsum[x])
            if wn == 0.0:
                continue
            xs = float(eye_x[x])
            x0 = int(np.floor(xs))
            fx = xs - x0
            if 0 <= x0 < in_w:
                m[x0, x] += wn * (1.0 - fx)
            if 0 <= x0 + 1 < in_w:
                m[x0 + 1, x] += wn * fx
        out.append(m.astype(np.float32))
    return out[0], out[1]
