"""Geometry host tables for the cat: cv2-matched linear resize and the
binocular FOV warp, as dense per-axis matrices (NumPy only).

Counterpart of the parts of ``animal_vision_tpu/core/geometry.py`` that the
cat needs. The device work is a matrix product per axis
(``core/linalg.py``).
"""

from __future__ import annotations

import functools
import math

import numpy as np


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


def resize_matrix(src: int, dst: int) -> np.ndarray:
    """A 1-D cv2 INTER_LINEAR resize as a dense (src, dst) float32 matrix."""
    idx, wgt = _linear_taps(src, dst)
    m = np.zeros((src, dst), dtype=np.float64)
    for t in range(idx.shape[0]):
        for d in range(dst):
            m[idx[t, d], d] += wgt[t, d]
    return m.astype(np.float32)


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
