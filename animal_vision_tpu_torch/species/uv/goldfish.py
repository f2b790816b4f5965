"""Goldfish: freshwater tetrachromat with a UV sheen.

Counterpart of ``animal_vision_tpu/species/uv/goldfish.py``: bands UV
320-400 / blue 430-500 / green 500-570 / red 600-680; red attenuation,
blue-green lift, haze tint, a global blur, UV magenta sheen, blue/green
reinforcement, peripheral radial blur; panorama 1.45, spectral maps at 0.25
scale."""

from __future__ import annotations

import numpy as np
import torch

from animal_vision_tpu_torch.core import blur, effects
from animal_vision_tpu_torch.core.stats import safe_norm
from animal_vision_tpu_torch.species.uv.common import UVAnimal


class Goldfish(UVAnimal):
    lambdas = np.linspace(300.0, 700.0, 81, dtype=np.float32)
    hsi_scale = 0.25
    panorama_scale = 1.45

    uv_boost = 3.0
    haze_strength = 0.12
    haze_tint = np.array([0.78, 0.92, 1.0], dtype=np.float32)
    red_kill = 0.55
    green_lift = 0.12
    blue_lift = 0.06
    base_blur_sigma = 0.8
    periph_blur_sigma = 1.8
    periph_radius = 0.65
    periph_softness = 6.0

    def _band_specs(self):
        return [(320.0, 400.0), (430.0, 500.0), (500.0, 570.0), (600.0, 680.0)]

    def _render(self, baseline_lin, maps, plain):
        u = safe_norm(maps[..., 0:1])
        bv = safe_norm(maps[..., 1:2])
        gv = safe_norm(maps[..., 2:3])
        rv = safe_norm(maps[..., 3:4])
        uv_sal = safe_norm(u / (1e-6 + 0.45 * gv + 0.35 * bv + 0.15 * rv))

        r = torch.clamp(baseline_lin[..., 0:1] * (1.0 - self.red_kill), 0.0, 1.0)
        g = torch.clamp(baseline_lin[..., 1:2] + self.green_lift, 0.0, 1.0)
        b = torch.clamp(baseline_lin[..., 2:3] + self.blue_lift, 0.0, 1.0)
        render = torch.cat([r, g, b], dim=-1)

        a = float(np.clip(self.haze_strength, 0.0, 1.0))
        render = (1.0 - a) * render + a * self._const(self.haze_tint)

        render = blur.gaussian_blur_uv(render, self.base_blur_sigma, plain)

        render = torch.cat(
            [
                torch.clamp(render[..., 0:1] + self.uv_boost * 0.42 * uv_sal, 0.0, 1.0),
                torch.clamp(render[..., 1:2] + self.uv_boost * 0.12 * uv_sal, 0.0, 1.0),
                torch.clamp(render[..., 2:3] + self.uv_boost * 0.35 * uv_sal, 0.0, 1.0),
            ],
            dim=-1,
        )
        render = torch.cat(
            [
                render[..., 0:1],
                torch.clamp(render[..., 1:2] + 0.30 * gv, 0.0, 1.0),
                torch.clamp(render[..., 2:3] + 0.22 * bv, 0.0, 1.0),
            ],
            dim=-1,
        )
        return effects.peripheral_blur(
            render, self.periph_blur_sigma, self.periph_radius, self.periph_softness, plain
        )
