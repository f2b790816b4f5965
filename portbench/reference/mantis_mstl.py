"""Plain reference of mantis shrimp with MST-L as its spectrum (configuration
``mantis_mstl``).

The chain of the reference application's ``animals/mantis_shrimp.py`` on
the shared UV skeleton, with the hyperspectral cube from MST-L
(``mst_l.forward``) in place of the analytic upsampler:

1. uint8 / 255, sRGB -> linear;
2. the panorama warp (x 1.12, cubic along W, centre crop): the baseline;
3. area-down to ``hsi_scale`` (0.25: 270 x 480 of a 1080p frame);
4. MST-L on that frame clipped to [0, 1], the cube clipped at 0;
5. the ten raised-cosine band weights on MST-L's 31 bands of 400-700 nm;
6. linear-up to the frame;
7. the render: each band min-max normalised per frame, divided by the
   frame's 95th percentile, an argmax barcode mixed with the soft weights
   through a 10-hue table, red kill and haze, a soft blur, Sobel
   orientation gains for a polarisation-guided unsharp mask, the barcode
   blend, scanline row gains and the peripheral blur;
8. linear -> sRGB -> uint8 (x 255 + 0.5, truncated).

float32; the caller sets the products' precision (``common.precision``).
The host tables (resize and panorama taps, scanline gains, the radial
mask, the hue table, the band weights) are worked out here again, frozen
from the port's plain composition, so that a later change to the program
cannot move the yardstick. Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import common as c
from portbench.reference import mst_l

#: MST-L's band grid (31 bands, 400-700 nm)
LAMBDAS = np.linspace(400.0, 700.0, 31, dtype=np.float32)
_SMOOTH = np.array([1.0, 2.0, 1.0], dtype=np.float32)
_DERIV = np.array([-1.0, 0.0, 1.0], dtype=np.float32)


# ---------------------------------------------------------------- host tables


def bandpass_weights(lo: float, hi: float) -> np.ndarray:
    """Raised-cosine weights on [lo, hi] over ``LAMBDAS``, summing to 1;
    uniform where no band sample has weight."""
    wl = LAMBDAS
    w = np.zeros_like(wl, dtype=np.float32)
    inside = (wl >= lo) & (wl <= hi)
    if not np.any(inside):
        return np.ones_like(wl) / float(wl.size)
    x = (wl[inside] - lo) / (hi - lo)
    w[inside] = 0.5 * (1.0 - np.cos(2.0 * np.pi * x))
    s = float(w.sum())
    return w / s if s > 1e-12 else np.ones_like(wl) / float(wl.size)


def band_columns(bands) -> np.ndarray:
    """(31, n) band weights of the (lo, hi) pairs."""
    return np.stack([bandpass_weights(lo, hi) for lo, hi in bands], axis=1)


def hue_lut(n: int, sat: float = 0.95) -> np.ndarray:
    """(n, 3) hue circle, HSV to RGB with v = 1."""
    h = np.arange(n, dtype=np.float32) / max(n, 1)
    i = np.floor(h * 6.0).astype(np.int32) % 6
    f = h * 6.0 - np.floor(h * 6.0)
    v = np.ones_like(h)
    p, q, t = v * (1.0 - sat), v * (1.0 - f * sat), v * (1.0 - (1.0 - f) * sat)
    r = np.select([i == k for k in range(6)], [v, q, p, p, t, v], default=v)
    g = np.select([i == k for k in range(6)], [t, v, v, q, p, p], default=v)
    b = np.select([i == k for k in range(6)], [p, p, t, v, v, q], default=v)
    return np.stack([r, g, b], axis=-1).astype(np.float32)


def linear_taps(src: int, dst: int):
    """OpenCV INTER_LINEAR along one axis: (2, dst) indices and weights."""
    fx = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx
    fx = np.where(sx < 0, 0.0, fx)
    sx = np.maximum(sx, 0)
    fx = np.where(sx >= src - 1, 1.0, fx)
    sx = np.minimum(sx, max(src - 2, 0))
    idx = np.stack([sx, np.minimum(sx + 1, src - 1)])
    return idx, np.stack([1.0 - fx, fx]).astype(np.float32)


def cubic_taps(src: int, dst: int):
    """OpenCV INTER_CUBIC (A = -0.75) along one axis, indices clamped:
    (4, dst) indices and weights."""
    a = -0.75
    fx = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    sx = np.floor(fx).astype(np.int64)
    t = fx - sx
    w0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    w1 = ((a + 2) * t - (a + 3)) * t * t + 1
    w2 = ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1
    w3 = 1.0 - w0 - w1 - w2
    idx = np.clip(np.stack([sx - 1, sx, sx + 1, sx + 2]), 0, src - 1)
    return idx, np.stack([w0, w1, w2, w3]).astype(np.float32)


def area_taps(src: int, dst: int):
    """OpenCV INTER_AREA downscale along one axis: each output's covered
    sources in order with their float32 shares, zero-padded."""
    scale = src / dst
    rows = []
    for x in range(dst):
        start, end = x * scale, min((x + 1) * scale, float(src))
        row = []
        for j in range(int(math.floor(start)), min(int(math.ceil(end)), src)):
            ov = min(end, j + 1) - max(start, j)
            if ov > 0:
                row.append((j, np.float32(ov / scale)))
        rows.append(row)
    k = max(len(r) for r in rows)
    idx, w = np.zeros((k, dst), np.int64), np.zeros((k, dst), np.float32)
    for d, row in enumerate(rows):
        for t, (j, v) in enumerate(row):
            idx[t, d], w[t, d] = j, v
    return idx, w


def scanline_gain(h: int, freq: float, gain: float, soften: float) -> np.ndarray:
    """(H, 1, 1) row gains: a sine of ``freq`` periods over the frame,
    blurred along H with the UV kernel (reflect-101), around 1."""
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)
    prof = (0.5 + 0.5 * np.sin(2.0 * np.pi * freq * y)).astype(np.float32)
    k = c.uv_ksize(soften)
    kern = c.gaussian_kernel_1d(k, soften).astype(np.float32)
    r = k // 2
    padded = prof[c.reflect101(np.arange(-r, h + r), h)]
    rows = np.zeros(h, dtype=np.float32)
    for t in range(k):
        rows += kern[t] * padded[t:t + h]
    return (1.0 + gain * (rows[:, None] - 0.5))[..., None]


def radial_mask(h: int, w: int, radius: float, softness: float) -> np.ndarray:
    """(H, W, 1) sigmoid of the distance from the centre on [-1, 1]^2."""
    yy = np.linspace(-1.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(-1.0, 1.0, w, dtype=np.float32)[None, :]
    r = np.sqrt(xx * xx + yy * yy)
    return (1.0 / (1.0 + np.exp(-softness * (r - radius)))).astype(np.float32)[..., None]


# ---------------------------------------------------------------- frame ops


def apply_taps(img: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """Gather and weight along ``axis`` of (..., H, W, C), the taps summed
    in order."""
    idx, w = taps
    view = (-1, 1, 1) if axis == -3 else (-1, 1)
    out = None
    for t in range(idx.shape[0]):
        i = torch.from_numpy(np.ascontiguousarray(idx[t])).to(img.device)
        term = torch.index_select(img, axis, i) * c.table(w[t], img.device).view(view)
        out = term if out is None else out + term
    return out


def resize(img: torch.Tensor, taps_h, taps_w) -> torch.Tensor:
    return apply_taps(apply_taps(img, taps_h, -3), taps_w, -2)


def blur_uv(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """The UV blur: 2 ceil(3 sigma) + 1 Gaussian taps, reflect-101, W first."""
    taps = c.gaussian_kernel_1d(c.uv_ksize(sigma), sigma)
    return c.conv1d_axis(c.conv1d_axis(img, taps, -2), taps, -3)


def sobel_x(img: torch.Tensor) -> torch.Tensor:
    return c.conv1d_axis(c.conv1d_axis(img, _DERIV, -2), _SMOOTH, -3)


def sobel_y(img: torch.Tensor) -> torch.Tensor:
    return c.conv1d_axis(c.conv1d_axis(img, _DERIV, -3), _SMOOTH, -2)


def luminance709(rgb: torch.Tensor) -> torch.Tensor:
    return 0.2126 * rgb[..., 0:1] + 0.7152 * rgb[..., 1:2] + 0.0722 * rgb[..., 2:3]


def to_u8(linear: torch.Tensor) -> torch.Tensor:
    """Clip, linear -> sRGB, x 255 + 0.5, clip, truncate."""
    return torch.clamp(c.linear_to_srgb(torch.clamp(linear, 0.0, 1.0)) * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)


def render(ms: dict, baseline_lin: torch.Tensor, maps: torch.Tensor, lut: torch.Tensor, row_gain: torch.Tensor,
           periph: torch.Tensor) -> torch.Tensor:
    """Mantis shrimp's linear-RGB rendering of one (H, W, 3) frame with its
    (H, W, n) band maps."""
    n = maps.shape[-1]
    mn = torch.amin(maps, dim=(-3, -2), keepdim=True)
    rng = torch.amax(maps, dim=(-3, -2), keepdim=True) - mn
    flat = rng < 1e-9
    s = torch.where(flat, 0.0, (maps - mn) / torch.where(flat, 1.0, rng))
    s_norm = torch.clamp(s / (c.percentile(s, 95.0) + 1e-8), 0.0, 1.0)
    wtm = ms["winner_take_most"]
    weights = s_norm / (torch.sum(s_norm, dim=-1, keepdim=True) + 1e-8)
    w_comb = (1.0 - wtm) * weights + wtm * F.one_hot(torch.argmax(s_norm, dim=-1), n).to(torch.float32)
    barcode = w_comb @ lut
    yb = luminance709(barcode)
    barcode = torch.clamp(yb + (barcode - yb) * (1.0 + ms["barcode_saturation"]), 0.0, 1.0)

    out = torch.cat([torch.clamp(baseline_lin[..., 0:1] * (1.0 - ms["red_kill"]), 0.0, 1.0),
                     baseline_lin[..., 1:3]], dim=-1)
    a = float(np.clip(ms["haze_strength"], 0.0, 1.0))
    out = (1.0 - a) * out + a * c.table(np.array(ms["haze_tint"], np.float32), out.device)
    out = blur_uv(out, ms["pre_soft_sigma"])

    broad = torch.mean(s_norm, dim=-1, keepdim=True)
    theta = torch.atan2(sobel_y(broad), sobel_x(broad))
    evec = float(np.deg2rad(ms["evec_angle_deg"]))
    mix = ms["orientation_mix"]
    cos2 = (1.0 - mix) * float(np.cos(2 * evec)) + mix * torch.cos(2.0 * theta)
    sin2 = (1.0 - mix) * float(np.sin(2 * evec)) + mix * torch.sin(2.0 * theta)
    align01 = torch.clamp(0.5 * (cos2 + 1.0), 0.0, 1.0) ** ms["pol_linear_gamma"]
    align_circ = torch.clamp(0.5 * (sin2 + 1.0), 0.0, 1.0)
    pol_gain = 1.0 + ms["pol_linear_strength"] * align01 + ms["pol_circular_strength"] * align_circ
    high = torch.clamp(out - blur_uv(out, ms["unsharp_sigma"]), -1.0, 1.0)
    out = torch.clamp(out + (ms["unsharp_amount"] * pol_gain) * high, 0.0, 1.0)

    op = ms["barcode_opacity"]
    out = torch.clamp((1.0 - op) * out + op * barcode, 0.0, 1.0)
    out = torch.clamp(out * row_gain, 0.0, 1.0)
    soft = blur_uv(out, ms["periph_blur_sigma"])
    return (1.0 - periph) * out + periph * soft


def program(config: dict, state: dict, h: int, w: int, device):
    """(N, H, W, 3) uint8 -> (baseline, transformed), one frame at a time."""
    ms = config["mantis_shrimp"]
    sd = {k: v.to(device=device, dtype=torch.float32) for k, v in state.items()}
    cols = c.table(band_columns(ms["bands"]), device)
    lut = c.table(hue_lut(len(ms["bands"])), device)
    row_gain = c.table(scanline_gain(h, ms["scan_row_freq"], ms["scan_row_gain"], ms["scan_soften"]), device)
    periph = c.table(radial_mask(h, w, ms["periph_radius"], ms["periph_softness"]), device)
    new_w = max(2, int(np.round(w * ms["panorama_scale"])))
    pidx, pw = cubic_taps(w, new_w)
    start = (new_w - w) // 2
    pano = (pidx[:, start:start + w], pw[:, start:start + w])
    sh, sw = max(1, int(round(h * ms["hsi_scale"]))), max(1, int(round(w * ms["hsi_scale"])))
    down, up = (area_taps(h, sh), area_taps(w, sw)), (linear_taps(sh, h), linear_taps(sw, w))

    def frame(image: torch.Tensor):
        lin = c.srgb_to_linear(image.to(torch.float32) / 255.0)
        base = apply_taps(lin, pano, -2)
        small = resize(base, *down)
        cube = torch.clamp(mst_l.forward(torch.clamp(small, 0.0, 1.0)[None], sd)[0], min=0.0)
        maps = resize(cube @ cols, *up)
        return to_u8(base), to_u8(render(ms, base, maps, lut, row_gain, periph))

    def fn(images: torch.Tensor):
        pairs = [frame(im) for im in images]
        return torch.stack([p[0] for p in pairs]), torch.stack([p[1] for p in pairs])

    return fn


def make(config: dict, h: int, w: int, device, state: dict | None = None) -> dict:
    return {name: program(config, state, h, w, device) for name in config["species"]}
