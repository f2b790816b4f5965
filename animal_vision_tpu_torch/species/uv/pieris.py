"""Pieris butterfly: a UV nectar-guide warm-white lift and a foliage
opponent.

Counterpart of ``animal_vision_tpu/species/uv/pieris.py``: a UV guide map
(blur 1.2, p95) lifts [0.35, 0.35 + 0.08, 0.25] times 0.75; the foliage
opponent G - 0.5 (U + B) adds +G 0.25; a clarity unsharp 0.22 at 0.8;
center attention times 1 + 0.12 (1 - t); panorama 1.05. Every percentile is
per frame."""

from __future__ import annotations

import numpy as np
import torch

from animal_vision_tpu_torch.core import blur, effects
from animal_vision_tpu_torch.core.stats import percentile, safe_norm
from animal_vision_tpu_torch.species.uv.common import UVAnimal


class Pieris(UVAnimal):
    lambdas = np.linspace(300.0, 700.0, 81)
    hsi_scale = 0.25
    panorama_scale = 1.05

    guide_sigma = 1.2
    guide_gain = 0.75
    foliage_opponent_gain = 0.25
    petal_warmth = 0.08
    clarity_unsharp_sigma = 0.8
    clarity_amount = 0.22
    center_bias = 0.12
    bias_radius = 0.80
    bias_softness = 7.0

    def _band_specs(self):
        return [(320.0, 400.0), (430.0, 500.0), (500.0, 570.0)]

    def _render(self, baseline_lin, maps, plain):
        u = safe_norm(safe_norm(maps[..., 0:1]))
        bv = safe_norm(maps[..., 1:2])
        gv = safe_norm(maps[..., 2:3])

        u_s = blur.gaussian_blur_uv(u, self.guide_sigma, plain)
        u_s = torch.clamp(u_s / (percentile(u_s, 95.0) + 1e-8), 0.0, 1.0)

        guide = self.guide_gain * u_s
        lift = self._const(np.array([0.35, 0.35 + self.petal_warmth, 0.25], np.float32))
        render = torch.clamp(baseline_lin + guide * lift, 0.0, 1.0)

        foliage = torch.clamp(gv - 0.5 * (u + bv), 0.0, 1.0)
        render = torch.cat(
            [
                render[..., 0:1],
                torch.clamp(render[..., 1:2] + self.foliage_opponent_gain * foliage, 0.0, 1.0),
                render[..., 2:3],
            ],
            dim=-1,
        )

        blurred = blur.gaussian_blur_uv(render, self.clarity_unsharp_sigma, plain)
        render = torch.clamp(render + self.clarity_amount * (render - blurred), 0.0, 1.0)

        t = effects.radial_mask_on(render, self.bias_radius, self.bias_softness)
        return torch.clamp(render * (1.0 + self.center_bias * (1.0 - t)), 0.0, 1.0)
