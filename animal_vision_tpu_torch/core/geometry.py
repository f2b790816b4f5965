"""Geometry: cv2-exact resize, the UV panorama warp, bilinear remap, the
center zoom and the binocular FOV warp.

Counterpart of ``animal_vision_tpu/core/geometry.py``. Tap indices and
weights are NumPy, with OpenCV's float-path coefficient formulas,
identical to the JAX package's. ``resize`` and ``panorama_warp`` apply them
per axis on the device as ``torch.index_select`` gathers and weighted sums
in tap order (the JAX package's CPU path), over (..., H, W, C) tensors.
``remap_bilinear`` is cv2.remap's INTER_LINEAR with a constant border as
four gathers. The cat's device work is a matrix product per axis
(``core/linalg.py``); ``binocular_warp_matrix`` and ``binocular_fov_warp``
are the library's two forms of its warp.
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


def remap_bilinear(img: torch.Tensor, map_x, map_y, border_value: float = 0.0) -> torch.Tensor:
    """``cv2.remap(img, map_x, map_y, INTER_LINEAR, BORDER_CONSTANT)`` of
    (..., H, W, C) with (H_out, W_out) maps of source coordinates (NumPy
    arrays or tensors): each of the four bilinear taps that falls outside
    the source contributes ``border_value``. The taps are gathers over the
    flattened (H W) axis, summed in cv2's order."""
    h, w, c = (int(s) for s in img.shape[-3:])
    mx = torch.as_tensor(map_x, dtype=torch.float32, device=img.device)
    my = torch.as_tensor(map_y, dtype=torch.float32, device=img.device)
    x0, y0 = torch.floor(mx), torch.floor(my)
    fx, fy = mx - x0, my - y0
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    flat = img.reshape(*img.shape[:-3], h * w, c)

    def tap(yi, xi):
        valid = ((xi >= 0) & (xi < w) & (yi >= 0) & (yi < h))[..., None]
        idx = (torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)).reshape(-1)
        vals = torch.index_select(flat, -2, idx).reshape(*img.shape[:-3], *mx.shape, c)
        return torch.where(valid, vals, float(border_value))

    w00, w01 = ((1 - fx) * (1 - fy))[..., None], (fx * (1 - fy))[..., None]
    w10, w11 = ((1 - fx) * fy)[..., None], (fx * fy)[..., None]
    return (tap(y0i, x0i) * w00 + tap(y0i, x0i + 1) * w01 + tap(y0i + 1, x0i) * w10
            + tap(y0i + 1, x0i + 1) * w11)


def center_zoom(img: torch.Tensor, scale: float) -> torch.Tensor:
    """Center-crop (H/scale, W/scale) of (..., H, W, C) and resize back
    with INTER_LINEAR; the input itself for scale <= 1."""
    if scale <= 1.0:
        return img
    h, w = int(img.shape[-3]), int(img.shape[-2])
    cw, ch = max(1, int(np.round(w / scale))), max(1, int(np.round(h / scale)))
    x0, y0 = (w - cw) // 2, (h - ch) // 2
    return resize(img[..., y0 : y0 + ch, x0 : x0 + cw, :], (h, w), "linear")


def panorama_warp(img: torch.Tensor, scale_x: float) -> torch.Tensor:
    """Widen (..., H, W, C) horizontally by ``scale_x`` with INTER_CUBIC and
    center-crop back to W. Only the kept columns' W taps run: the cubic
    taps of H to H are the identity (weights 0, 1, 0, 0)."""
    if abs(scale_x - 1.0) < 1e-3:
        return img
    return _apply_taps(img, _device_panorama(int(img.shape[-2]), float(scale_x), str(img.device)), -2)


def vertical_remap_plan(map_y: np.ndarray, device) -> list[tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]:
    """The device tables of ``vertical_remap_static`` for a static (H, W)
    row map: per row offset d = floor(map_y) - y that occurs, the clamped
    source rows y + d and y + d + 1 and their (H, W, 1) weights
    (1 - f, f), masked to the pixels whose offset is d."""
    h = int(map_y.shape[0])
    iy = np.floor(map_y).astype(np.int64)
    frac = (map_y - iy).astype(np.float32)
    d = iy - np.arange(h)[:, None]
    rows = np.arange(h)
    plan = []
    for dd in range(int(d.min()), int(d.max()) + 1):
        mask = d == dd
        if not mask.any():
            continue
        src0, src1 = np.clip(rows + dd, 0, h - 1), np.clip(rows + dd + 1, 0, h - 1)
        w0 = (mask * (1.0 - frac)).astype(np.float32)[..., None]
        w1 = (mask * frac).astype(np.float32)[..., None]
        plan.append(tuple(torch.from_numpy(a).to(device) for a in (src0, src1, w0, w1)))
    return plan


def vertical_remap_static(img: torch.Tensor, plan) -> torch.Tensor:
    """Bilinear vertical-only remap of (..., H, W, C) with a static row map
    (``vertical_remap_plan``): cv2.remap with the identity x map and
    INTER_LINEAR where the map stays in bounds. Sums the offsets in
    increasing order, each as shifted rows with edge clamp, like the JAX
    package."""
    out = torch.zeros_like(img)
    for src0, src1, w0, w1 in plan:
        out = out + torch.index_select(img, -3, src0) * w0 + torch.index_select(img, -3, src1) * w1
    return out


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


@functools.lru_cache(maxsize=None)
def binocular_warp_matrix(
    in_w: int,
    out_w: int,
    fov_in_deg: float,
    per_eye_half_fov_deg: float,
    overlap_deg: float,
    out_h_probe: int = 2,
) -> np.ndarray:
    """The binocular FOV warp as one (W_in, W_out) column matrix, the sum
    of the two eyes' ``binocular_warp_matrices``:
    ``warped = clip(img01 @ M, 0, 1)`` along W."""
    ml, mr = binocular_warp_matrices(in_w, out_w, fov_in_deg, per_eye_half_fov_deg, overlap_deg, out_h_probe)
    return ml + mr


@functools.lru_cache(maxsize=16)
def _device_binocular(in_hw, out_hw, fov_in_deg, per_eye_half_fov_deg, overlap_deg, device: str):
    """``_binocular_maps`` with the blend weights normalized, on ``device``."""
    xl, xr, ymap, w_l, w_r = _binocular_maps(in_hw, out_hw, fov_in_deg, per_eye_half_fov_deg, overlap_deg)
    wsum = w_l + w_r + 1e-8
    return tuple(torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)
                 for a in (xl, xr, ymap, w_l[..., None], w_r[..., None], wsum[..., None]))


def binocular_fov_warp(
    img01: torch.Tensor,
    fov_in_deg: float,
    per_eye_half_fov_deg: float,
    overlap_deg: float,
    out_hw: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Wide-FOV binocular blend of (..., H, W, C): each eye's yaw remap
    (bilinear, black border) weighted by cos^2 and its validity, the sum
    normalized and clipped to [0, 1]."""
    h, w = int(img01.shape[-3]), int(img01.shape[-2])
    out_hw = (h, w) if out_hw is None else (int(out_hw[0]), int(out_hw[1]))
    xl, xr, ymap, w_l, w_r, wsum = _device_binocular(
        (h, w), out_hw, float(fov_in_deg), float(per_eye_half_fov_deg), float(overlap_deg), str(img01.device))
    left = remap_bilinear(img01, xl, ymap, 0.0)
    right = remap_bilinear(img01, xr, ymap, 0.0)
    return torch.clamp((left * w_l + right * w_r) / wsum, 0.0, 1.0)
