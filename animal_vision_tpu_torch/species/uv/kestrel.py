"""Kestrel: UV vole-trail detection over a sky/ground split.

Counterpart of ``animal_vision_tpu/species/uv/kestrel.py``: sky weight =
sigmoid of (0.6 vertical prior + 0.4 blue dominance, UV-blurred at 3.0,
p98-normalized); structure-tensor ridge "trailness" on the UV map (sigma
3); sky cool tint and haze, ground warm tint and contrast; a ground-only
magenta UV overlay (0.60, 0.12, 0.70) at 0.55; trailness-gated unsharp
mask; peripheral blur 0.7 at 0.82/7; panorama 1.10. Every percentile is per
frame."""

from __future__ import annotations

import numpy as np
import torch

from animal_vision_tpu_torch.core import blur, effects, gradients
from animal_vision_tpu_torch.core.stats import percentile, safe_norm
from animal_vision_tpu_torch.species.uv.common import UVAnimal


class Kestrel(UVAnimal):
    lambdas = np.linspace(300.0, 700.0, 81, dtype=np.float32)
    hsi_scale = 0.25
    panorama_scale = 1.10

    sky_cool_tint = np.array([0.95, 0.98, 1.03], np.float32)
    sky_haze = 0.10
    ground_warm_tint = np.array([1.02, 1.01, 0.99], np.float32)
    ground_contrast = 0.08
    uv_overlay_strength = 0.55
    uv_magenta = np.array([0.60, 0.12, 0.70], np.float32)
    ridge_sigma = 3.0
    ridge_gain = 1.0
    unsharp_sigma = 1.0
    unsharp_amount = 0.30
    periph_blur_sigma = 0.7
    periph_radius = 0.82
    periph_softness = 7.0

    def _band_specs(self):
        return [(320.0, 400.0), (440.0, 500.0), (500.0, 570.0), (600.0, 680.0)]

    def _ridge(self, u, plain):
        gxx, gxy, gyy = gradients.structure_tensor(u, self.ridge_sigma, plain)
        trace = gxx + gyy
        root = torch.sqrt(torch.clamp((0.5 * (gxx - gyy)) ** 2 + gxy * gxy, min=0.0))
        lam1 = 0.5 * trace + root
        lam2 = 0.5 * trace - root
        coh = (lam1 - lam2) / (lam1 + lam2 + 1e-8)
        energy = torch.clamp(trace, min=0.0)
        energy = energy / (percentile(energy, 95.0) + 1e-8)
        return torch.clamp(coh * energy, 0.0, 1.0)

    def _render(self, baseline_lin, maps, plain):
        u = safe_norm(safe_norm(maps[..., 0:1]))
        bv = safe_norm(maps[..., 1:2])
        gv = safe_norm(maps[..., 2:3])

        h = int(baseline_lin.shape[-3])
        vert_prior = self._const(np.linspace(1.0, 0.0, h, dtype=np.float32)[:, None, None])
        blue_dom = torch.clamp(bv - 0.6 * gv, 0.0, 1.0)
        sky_score = blur.gaussian_blur_uv(0.6 * vert_prior + 0.4 * blue_dom, 3.0, plain)
        sky_score = torch.clamp(sky_score / (percentile(sky_score, 98.0) + 1e-8), 0.0, 1.0)
        sky_w = 1.0 / (1.0 + torch.exp(-6.0 * (sky_score - 0.45)))
        ground_w = 1.0 - sky_w

        trailness = torch.clamp(self.ridge_gain * self._ridge(u, plain) * (1.0 - sky_w), 0.0, 1.0)

        render = baseline_lin
        a = float(np.clip(self.sky_haze, 0.0, 1.0))
        sky_tinted = torch.clamp(render * self._const(self.sky_cool_tint), 0.0, 1.0)
        haze_col = self._const(np.array([0.90, 0.97, 1.00], np.float32))
        render = sky_w * ((1.0 - a) * sky_tinted + a * haze_col) + ground_w * render

        ground_part = torch.clamp(render * self._const(self.ground_warm_tint), 0.0, 1.0)
        blurred = blur.gaussian_blur_uv(ground_part, 1.2, plain)
        ground_part = torch.clamp(ground_part + self.ground_contrast * (ground_part - blurred), 0.0, 1.0)
        render = sky_w * render + ground_w * ground_part

        u95 = torch.clamp(u / (percentile(u, 95.0) + 1e-8), 0.0, 1.0)
        uv_rgb = u95 * self._const(self.uv_magenta)
        s = self.uv_overlay_strength
        render = torch.clamp((1.0 - s * ground_w) * render + (s * ground_w) * uv_rgb, 0.0, 1.0)

        blurred = blur.gaussian_blur_uv(render, self.unsharp_sigma, plain)
        high = torch.clamp(render - blurred, -1.0, 1.0)
        render = torch.clamp(render + (self.unsharp_amount * trailness) * high, 0.0, 1.0)

        return effects.peripheral_blur(
            render, self.periph_blur_sigma, self.periph_radius, self.periph_softness, plain
        )
