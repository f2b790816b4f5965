"""Damselfish: a reef fish with a UV-guided unsharp mask and blue/yellow
chroma.

Counterpart of ``animal_vision_tpu/species/uv/damselfish.py``: bands UV
320-400 / blue 440-500 / yellow 560-600 / red 600-680; red kill 0.35; base
blur 0.35; UV-guided unsharp (sigma 1.2, gain 1 + 0.45 Un); UV gloss lift
B/G/R 0.60/0.30/0.15; blue/yellow chroma gains 0.22/0.28 (yellow to
0.65 G + 0.35 R); peripheral blur 0.8 at radius 0.70, softness 7;
panorama 1.25."""

from __future__ import annotations

import numpy as np
import torch

from animal_vision_tpu_torch.core import blur, effects
from animal_vision_tpu_torch.core.stats import safe_norm
from animal_vision_tpu_torch.species.uv.common import UVAnimal


class Damselfish(UVAnimal):
    lambdas = np.linspace(300.0, 700.0, 81, dtype=np.float32)
    hsi_scale = 0.25
    panorama_scale = 1.25

    uv_edge_boost = 0.45
    uv_gloss_boost = 0.30
    blue_chroma_gain = 0.22
    yellow_chroma_gain = 0.28
    red_kill = 0.35
    base_blur_sigma = 0.35
    unsharp_sigma = 1.2
    periph_radius = 0.70
    periph_softness = 7.0
    periph_extra_blur = 0.8

    def _band_specs(self):
        return [(320.0, 400.0), (440.0, 500.0), (560.0, 600.0), (600.0, 680.0)]

    def _render(self, baseline_lin, maps, plain):
        un = safe_norm(safe_norm(maps[..., 0:1]))
        bn = safe_norm(maps[..., 1:2])
        yn = safe_norm(maps[..., 2:3])

        render = torch.cat(
            [torch.clamp(baseline_lin[..., 0:1] * (1.0 - self.red_kill), 0.0, 1.0), baseline_lin[..., 1:3]], dim=-1
        )
        if self.base_blur_sigma > 0.0:
            render = blur.gaussian_blur_uv(render, self.base_blur_sigma, plain)

        if self.unsharp_sigma > 0.0 and self.uv_edge_boost > 0.0:
            blurred = blur.gaussian_blur_uv(render, self.unsharp_sigma, plain)
            highpass = torch.clamp(render - blurred, -1.0, 1.0)
            gain = 1.0 + self.uv_edge_boost * un
            render = torch.clamp(render + gain * highpass, 0.0, 1.0)

        if self.uv_gloss_boost > 0.0:
            lift = self.uv_gloss_boost * un
            render = torch.cat(
                [
                    torch.clamp(render[..., 0:1] + 0.15 * lift, 0.0, 1.0),
                    torch.clamp(render[..., 1:2] + 0.30 * lift, 0.0, 1.0),
                    torch.clamp(render[..., 2:3] + 0.60 * lift, 0.0, 1.0),
                ],
                dim=-1,
            )

        y_boost = self.yellow_chroma_gain * yn
        render = torch.cat(
            [
                torch.clamp(render[..., 0:1] + 0.35 * y_boost, 0.0, 1.0),
                torch.clamp(render[..., 1:2] + 0.65 * y_boost, 0.0, 1.0),
                torch.clamp(render[..., 2:3] + self.blue_chroma_gain * bn, 0.0, 1.0),
            ],
            dim=-1,
        )
        return effects.peripheral_blur(
            render, self.periph_extra_blur, self.periph_radius, self.periph_softness, plain
        )
