"""Northern anchovy: UV polarization-sensitive ocean vision.

Counterpart of ``animal_vision_tpu/species/uv/anchovy.py``: the Sobel
orientation of the UV map, a doubled-angle blend of the local and the
global E-vector (mix 0.35), a polarization gain 1 + 0.55 (align^1.2 Un
|grad U|); a polarization-guided unsharp mask; UV-aligned gloss and
band-agreement chroma; red kill 0.25; panorama 1.2. Every percentile is per
frame."""

from __future__ import annotations

import numpy as np
import torch

from animal_vision_tpu_torch.core import blur, effects, gradients
from animal_vision_tpu_torch.core.stats import percentile, safe_norm
from animal_vision_tpu_torch.species.uv.common import UVAnimal


class Anchovy(UVAnimal):
    lambdas = np.linspace(300.0, 700.0, 81, dtype=np.float32)
    hsi_scale = 0.25
    panorama_scale = 1.20

    red_kill = 0.25
    base_soft_sigma = 0.30
    unsharp_sigma = 1.0
    unsharp_amount = 0.35
    haze_strength = 0.04
    haze_tint = np.array([0.90, 0.97, 1.00], dtype=np.float32)
    evec_angle_deg = 0.0
    pol_strength = 0.55
    pol_gamma = 1.2
    orientation_mix = 0.35
    uv_gloss_gain = 0.28
    blue_chroma_gain = 0.18
    green_chroma_gain = 0.10
    periph_blur_sigma = 0.6
    periph_radius = 0.78
    periph_softness = 7.0

    def _band_specs(self):
        return [(320.0, 400.0), (440.0, 500.0), (500.0, 570.0), (600.0, 680.0)]

    def _render(self, baseline_lin, maps, plain):
        un = safe_norm(safe_norm(maps[..., 0:1]))
        bn = safe_norm(maps[..., 1:2])
        gn = safe_norm(maps[..., 2:3])

        gx = gradients.sobel_x(un)
        gy = gradients.sobel_y(un)
        theta = torch.atan2(gy, gx)
        evec = float(np.deg2rad(self.evec_angle_deg))
        mix = float(np.clip(self.orientation_mix, 0.0, 1.0))
        cos2 = (1.0 - mix) * float(np.cos(2.0 * evec)) + mix * torch.cos(2.0 * theta)
        align01 = torch.clamp(0.5 * (cos2 + 1.0), 0.0, 1.0) ** self.pol_gamma

        uv_mag = torch.sqrt(gx * gx + gy * gy)
        uv_mag = torch.clamp(uv_mag / (percentile(uv_mag, 95.0) + 1e-8), 0.0, 1.0)
        pol_gain = 1.0 + self.pol_strength * (align01 * un * uv_mag)

        render = torch.cat(
            [torch.clamp(baseline_lin[..., 0:1] * (1.0 - self.red_kill), 0.0, 1.0), baseline_lin[..., 1:3]], dim=-1
        )
        a = float(np.clip(self.haze_strength, 0.0, 1.0))
        render = (1.0 - a) * render + a * self._const(self.haze_tint)
        render = blur.gaussian_blur_uv(render, self.base_soft_sigma, plain)

        blurred = blur.gaussian_blur_uv(render, self.unsharp_sigma, plain)
        high = torch.clamp(render - blurred, -1.0, 1.0)
        render = torch.clamp(render + (self.unsharp_amount * pol_gain) * high, 0.0, 1.0)

        gloss = self.uv_gloss_gain * (align01 * un)
        render = torch.cat(
            [
                render[..., 0:1],
                torch.clamp(
                    torch.clamp(render[..., 1:2] + 0.30 * gloss, 0.0, 1.0) + self.green_chroma_gain * (gn * un),
                    0.0,
                    1.0,
                ),
                torch.clamp(
                    torch.clamp(render[..., 2:3] + 0.70 * gloss, 0.0, 1.0) + self.blue_chroma_gain * (bn * un),
                    0.0,
                    1.0,
                ),
            ],
            dim=-1,
        )
        return effects.peripheral_blur(
            render, self.periph_blur_sigma, self.periph_radius, self.periph_softness, plain
        )
