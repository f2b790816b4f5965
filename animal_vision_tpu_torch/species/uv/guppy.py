"""Guppy: UV "private channel" spot saliency in a shallow stream.

Counterpart of ``animal_vision_tpu/species/uv/guppy.py``: a DoG band-pass
on UV (sigmas 0.8/2.4, p95-normalized) -> spot saliency; a spot-gated
unsharp mask and B/G/R lifts scaled by Bn/Gn/Un; luma-preserving background
desaturation where UV is weak; a warm tint; an edge vignette; panorama
1.22. Every percentile is per frame."""

from __future__ import annotations

import numpy as np
import torch

from animal_vision_tpu_torch.core import blur, effects
from animal_vision_tpu_torch.core.stats import luminance709, percentile, safe_norm
from animal_vision_tpu_torch.species.uv.common import UVAnimal


class Guppy(UVAnimal):
    lambdas = np.linspace(300.0, 700.0, 81, dtype=np.float32)
    hsi_scale = 0.25
    panorama_scale = 1.22

    red_kill = 0.28
    haze_strength = 0.06
    haze_tint = np.array([0.92, 0.98, 1.00], dtype=np.float32)
    warm_tint = np.array([1.03, 1.01, 0.99], dtype=np.float32)
    base_soft_sigma = 0.35
    unsharp_sigma = 0.9
    unsharp_amount = 0.28
    dog_small_sigma = 0.8
    dog_large_sigma = 2.4
    uv_chroma_boost = 0.40
    uv_blue_gain = 0.55
    uv_green_gain = 0.35
    uv_red_gain = 0.12
    background_desat = 0.18
    vignette_strength = 0.12
    vignette_radius = 0.78
    vignette_softness = 7.0

    def _band_specs(self):
        return [(320.0, 400.0), (430.0, 500.0), (500.0, 570.0), (600.0, 680.0)]

    def _render(self, baseline_lin, maps, plain):
        un = safe_norm(safe_norm(maps[..., 0:1]))
        bn = safe_norm(maps[..., 1:2])
        gn = safe_norm(maps[..., 2:3])

        render = torch.cat(
            [torch.clamp(baseline_lin[..., 0:1] * (1.0 - self.red_kill), 0.0, 1.0), baseline_lin[..., 1:3]], dim=-1
        )
        a = float(np.clip(self.haze_strength, 0.0, 1.0))
        render = (1.0 - a) * render + a * self._const(self.haze_tint)
        render = torch.clamp(render * self._const(self.warm_tint), 0.0, 1.0)
        render = blur.gaussian_blur_uv(render, self.base_soft_sigma, plain)

        uv_dog = torch.clamp(
            blur.gaussian_blur_uv(un, self.dog_small_sigma, plain) - blur.gaussian_blur_uv(un, self.dog_large_sigma, plain),
            0.0,
            1.0,
        )
        uv_spot = torch.clamp(uv_dog / (percentile(uv_dog, 95.0) + 1e-8), 0.0, 1.0)

        blurred = blur.gaussian_blur_uv(render, self.unsharp_sigma, plain)
        high = torch.clamp(render - blurred, -1.0, 1.0)
        render = torch.clamp(render + (self.unsharp_amount * uv_spot) * high, 0.0, 1.0)

        lift = self.uv_chroma_boost * uv_spot
        render = torch.cat(
            [
                torch.clamp(render[..., 0:1] + self.uv_red_gain * lift * un, 0.0, 1.0),
                torch.clamp(render[..., 1:2] + self.uv_green_gain * lift * gn, 0.0, 1.0),
                torch.clamp(render[..., 2:3] + self.uv_blue_gain * lift * bn, 0.0, 1.0),
            ],
            dim=-1,
        )

        # luma-preserving background desaturation where UV is weak
        y = luminance709(render)
        mean_chroma = torch.mean(torch.abs(render - y), dim=-1, keepdim=True)
        sat = mean_chroma / (percentile(mean_chroma, 95.0) + 1e-8)
        desat = 1.0 - self.background_desat * (1.0 - un) * (1.0 - sat)
        render = torch.clamp(y + (render - y) * desat, 0.0, 1.0)

        # edge vignette
        t = effects.radial_mask_on(render, self.vignette_radius, self.vignette_softness)
        vign = 1.0 - self.vignette_strength * t
        return torch.clamp(render * vign, 0.0, 1.0)
