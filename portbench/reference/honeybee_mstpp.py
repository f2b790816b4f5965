"""Plain reference of honeybee with MST++ as its spectrum (configuration
``honeybee_mstpp``).

The chain of the reference application's ``animals/honeybee.py`` with the
hyperspectral cube from MST++ (``mst_plus_plus.forward``) in place of the
analytic upsampler: uint8 / 255 -> MST++ on the frame clipped to [0, 1]
-> the cube clipped at 0 -> the three cone catches (log-normal UV, blue
and green curves on 31 bands of 400-700 nm, times a D65-like illuminant)
-> white-patch von Kries adaptation -> a sigma-0.2 blur of the catches ->
the opponent mapping (hue from (G-B, B-U), p95 saturation and value) ->
linear->sRGB -> uint8. The baseline is the input frame. float32; the
caller sets the products' precision (``common.precision``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import common as c
from portbench.reference import mst_plus_plus


def catch_columns(hb: dict) -> np.ndarray:
    """(31, 3) float64: each cone curve (sum-normalised in float32) times
    the illuminant."""
    lam = np.linspace(hb["lambda_min_nm"], hb["lambda_max_nm"], hb["bands"], dtype=np.float32).astype(np.float64)
    cols = []
    for peak, sigma in hb["cones"]:
        curve = np.exp(-0.5 * ((lam - peak) / sigma) ** 2).astype(np.float32)
        cols.append(curve / curve.sum())
    x = (lam - 560.0) / 50.0
    e = np.exp(-0.5 * x**2) + 0.3 * np.exp(-0.5 * ((lam - 450.0) / 35.0) ** 2)
    e = (e / e.mean()).astype(np.float32).astype(np.float64)
    return np.stack([col.astype(np.float64) * e for col in cols], axis=1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - f * s), v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i, 6)
    zeros = torch.zeros_like(v)

    def sel(options):
        out = zeros
        for idx, val in enumerate(options):
            out = torch.where(i == idx, val, out)
        return out

    return torch.stack([sel([v, q, p, p, t, v]), sel([t, v, v, q, p, p]), sel([p, p, t, v, v, q])], dim=-1)


def opponent(u, b, g) -> torch.Tensor:
    o1, o2 = g - b, b - u
    lum = (u + b + g) / 3.0
    hue = (torch.atan2(o2, o1) + math.pi) / (2 * math.pi)
    radius = torch.sqrt(o1 * o1 + o2 * o2)
    sat = radius / (c.percentile(radius, 95.0) + c.EPS)
    val = lum / (c.percentile(lum, 95.0) + c.EPS)
    return hsv_to_rgb(torch.cat([hue, torch.clamp(sat, 0, 1), torch.clamp(val, 0, 1)], dim=-1))


def program(config: dict, state: dict, device):
    """(N, H, W, 3) uint8 -> (baseline, transformed), one frame at a time
    so that MST++'s activations fit."""
    hb = config["honeybee"]
    cols = c.table(catch_columns(hb), device)
    taps = c.gaussian_kernel_1d(c.uv_ksize(hb["blur_sigma_px"]), hb["blur_sigma_px"])
    sd = {k: v.to(device=device, dtype=torch.float32) for k, v in state.items()}

    def frame(image: torch.Tensor) -> torch.Tensor:
        x = torch.clamp(image.to(torch.float32) / 255.0, 0.0, 1.0)[None]
        cube = torch.clamp(mst_plus_plus.forward(x, sd), min=0.0)
        ubg = cube @ cols
        ubg = ubg / torch.clamp(torch.amax(ubg, dim=(-3, -2), keepdim=True), min=c.EPS)
        ubg = c.conv1d_axis(c.conv1d_axis(ubg, taps, -2), taps, -3)
        rgb = opponent(ubg[..., 0:1], ubg[..., 1:2], ubg[..., 2:3])
        return c.encode_u8(torch.clamp(rgb, 0.0, 1.0))[0]

    def fn(images: torch.Tensor):
        return images, torch.stack([frame(im) for im in images])

    return fn


def make(config: dict, h: int, w: int, device, state: dict | None = None) -> dict:
    return {name: program(config, state, device) for name in config["species"]}
