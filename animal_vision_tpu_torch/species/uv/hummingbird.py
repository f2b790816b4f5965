"""Hummingbird: non-spectral UV+X combination colours with a metamer tint.

Counterpart of ``animal_vision_tpu/species/uv/hummingbird.py``: combination
maps UxB, UxG, UxR = safe_norm(U * band), DoG band-passed (0.8/2.0, p95);
combination-gated clarity and sheen (weights 0.55/0.65/0.75 times 0.28); a
weighted metamer tint (electric-cyan, mint and orchid sRGB targets in
linear light, saturation 1.45) blended at 0.55; a nectar-guide lift (blur
1.0, p95, [0.20, 0.25, 0.10] times 0.25); peripheral blur 0.6; panorama
1.05; red kill 0.10. Every statistic is per frame."""

from __future__ import annotations

import numpy as np
import torch

from animal_vision_tpu_torch.core import blur, effects
from animal_vision_tpu_torch.core.stats import luminance709, percentile, safe_norm
from animal_vision_tpu_torch.species.uv.common import UVAnimal


def _s2l(rgb) -> np.ndarray:
    v = np.array(rgb, np.float32) / 255.0
    a = 0.055
    return np.where(v <= 0.04045, v / 12.92, ((v + a) / (1 + a)) ** 2.4).astype(np.float32)


class Hummingbird(UVAnimal):
    lambdas = np.linspace(300.0, 700.0, 81, dtype=np.float32)
    hsi_scale = 0.25
    panorama_scale = 1.05

    red_kill = 0.10
    base_soft_sigma = 0.25
    unsharp_sigma = 0.9
    unsharp_amount = 0.24
    combo_opacity = 0.55
    combo_saturation = 0.45
    combo_sheen = 0.28
    tgt_uvb = _s2l((120, 150, 255))
    tgt_uvg = _s2l((110, 255, 170))
    tgt_uvr = _s2l((255, 110, 210))
    guide_sigma = 1.0
    guide_gain = 0.25
    periph_blur_sigma = 0.6
    periph_radius = 0.82
    periph_softness = 7.0

    def _band_specs(self):
        return [(320.0, 400.0), (430.0, 500.0), (500.0, 570.0), (600.0, 680.0)]

    def _render(self, baseline_lin, maps, plain):
        u = safe_norm(safe_norm(maps[..., 0:1]))
        bv = safe_norm(maps[..., 1:2])
        gv = safe_norm(maps[..., 2:3])
        rv = safe_norm(maps[..., 3:4])

        def bandpass(m):
            d = torch.clamp(
                blur.gaussian_blur_uv(m, 0.8, plain) - blur.gaussian_blur_uv(m, 2.0, plain), 0.0, 1.0
            )
            return torch.clamp(d / (percentile(d, 95.0) + 1e-8), 0.0, 1.0)

        uxb = bandpass(safe_norm(u * bv))
        uxg = bandpass(safe_norm(u * gv))
        uxr = bandpass(safe_norm(u * rv))

        render = torch.cat(
            [torch.clamp(baseline_lin[..., 0:1] * (1.0 - self.red_kill), 0.0, 1.0), baseline_lin[..., 1:3]], dim=-1
        )
        render = blur.gaussian_blur_uv(render, self.base_soft_sigma, plain)

        combo_max = torch.maximum(torch.maximum(uxb, uxg), uxr)
        blurred = blur.gaussian_blur_uv(render, self.unsharp_sigma, plain)
        high = torch.clamp(render - blurred, -1.0, 1.0)
        render = torch.clamp(render + (self.unsharp_amount * combo_max) * high, 0.0, 1.0)

        sheen = 0.55 * uxb + 0.65 * uxg + 0.75 * uxr
        render = torch.clamp(render + self.combo_sheen * sheen, 0.0, 1.0)

        w_sum = uxb + uxg + uxr + 1e-8
        tint = (
            (uxb / w_sum) * self._const(self.tgt_uvb)
            + (uxg / w_sum) * self._const(self.tgt_uvg)
            + (uxr / w_sum) * self._const(self.tgt_uvr)
        )
        y = luminance709(tint)
        tint = torch.clamp(y + (tint - y) * (1.0 + self.combo_saturation), 0.0, 1.0)
        render = torch.clamp((1.0 - self.combo_opacity) * render + self.combo_opacity * tint, 0.0, 1.0)

        u_s = blur.gaussian_blur_uv(u, self.guide_sigma, plain)
        u_s = torch.clamp(u_s / (percentile(u_s, 95.0) + 1e-8), 0.0, 1.0)
        lift = self._const(np.array([0.20, 0.25, 0.10], np.float32))
        render = torch.clamp(render + self.guide_gain * u_s * lift, 0.0, 1.0)

        return effects.peripheral_blur(
            render, self.periph_blur_sigma, self.periph_radius, self.periph_softness, plain
        )
