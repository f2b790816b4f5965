"""Heliconius butterfly: UV-and-red conjunction signal pop.

Counterpart of ``animal_vision_tpu/species/uv/heliconius.py``: a DoG
band-pass (0.8/2.2) on UV and on red, their product, p95-normalized; the
background cooled and desaturated where the conjunction is weak; a
conjunction-gated unsharp mask, +R 0.40 conj, saturation boost
1 + 0.45 conj; panorama 1.05. Every percentile is per frame."""

from __future__ import annotations

import numpy as np
import torch

from animal_vision_tpu_torch.core import blur
from animal_vision_tpu_torch.core.stats import luminance709, percentile, safe_norm
from animal_vision_tpu_torch.species.uv.common import UVAnimal


def _sat_apply(lin: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    y = luminance709(lin)
    return torch.clamp(y + (lin - y) * scale, 0.0, 1.0)


class Heliconius(UVAnimal):
    lambdas = np.linspace(300.0, 700.0, 81)
    hsi_scale = 0.25
    panorama_scale = 1.05

    conj_sigma_small = 0.8
    conj_sigma_large = 2.2
    sat_boost = 0.45
    red_gain = 0.40
    bg_desat = 0.20
    bg_cool = 0.04
    base_soft_sigma = 0.30
    unsharp_sigma = 1.0
    unsharp_amount = 0.25

    def _band_specs(self):
        return [(320.0, 400.0), (600.0, 680.0), (500.0, 570.0)]

    def _dog(self, m, plain):
        return torch.clamp(
            blur.gaussian_blur_uv(m, self.conj_sigma_small, plain) - blur.gaussian_blur_uv(m, self.conj_sigma_large, plain),
            0.0,
            1.0,
        )

    def _render(self, baseline_lin, maps, plain):
        u = safe_norm(safe_norm(maps[..., 0:1]))
        rb = safe_norm(maps[..., 1:2])

        conj = self._dog(u, plain) * self._dog(rb, plain)
        conj = torch.clamp(conj / (percentile(conj, 95.0) + 1e-8), 0.0, 1.0)

        render = blur.gaussian_blur_uv(baseline_lin, self.base_soft_sigma, plain)

        bg_w = 1.0 - conj
        render = torch.cat(
            [render[..., :2], torch.clamp(render[..., 2:3] + self.bg_cool * bg_w, 0.0, 1.0)], dim=-1
        )
        render = _sat_apply(render, 1.0 - self.bg_desat * bg_w)

        blurred = blur.gaussian_blur_uv(render, self.unsharp_sigma, plain)
        render = torch.clamp(render + (self.unsharp_amount * conj) * (render - blurred), 0.0, 1.0)
        render = torch.cat([torch.clamp(render[..., 0:1] + self.red_gain * conj, 0.0, 1.0), render[..., 1:]], dim=-1)
        return _sat_apply(render, 1.0 + self.sat_boost * conj)
