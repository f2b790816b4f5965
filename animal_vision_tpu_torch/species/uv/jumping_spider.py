"""Jumping spider: foveated principal eyes with UV display-patch pop.

Counterpart of ``animal_vision_tpu/species/uv/jumping_spider.py``: a UV
patch DoG (0.9/2.2), G<->UV opponent shaping, patch-gated clarity,
scanlines (freq 22, gain 0.08), static attention spots at (0.50, 0.52) and
(0.57, 0.48) with sigma 0.08 (brightness and a local-sharpen blend),
foveation at r = 0.38 with a steep sigmoid, peripheral blur 2.2 and a 0.22
vignette; panorama 1.02. Every percentile is per frame."""

from __future__ import annotations

import functools

import numpy as np
import torch

from animal_vision_tpu_torch.core import blur, effects
from animal_vision_tpu_torch.core.stats import percentile, safe_norm
from animal_vision_tpu_torch.species.uv.common import UVAnimal
from animal_vision_tpu_torch.species.uv.mantis_shrimp import scanline_gain


@functools.lru_cache(maxsize=16)
def _spots_mask(h: int, w: int, spots: tuple, sigma: float, device: str) -> torch.Tensor:
    """(H, W, 1) sum of Gaussian spots over the [0, 1]^2 grid, divided by
    its 95th percentile and clipped to [0, 1], on ``device``."""
    yy = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    mask = np.zeros((h, w), np.float32)
    s2 = max(sigma, 1e-4) ** 2
    for yc, xc in spots:
        mask += np.exp(-((yy - yc) ** 2 + (xx - xc) ** 2) / (2.0 * s2))
    m95 = max(1e-8, float(np.percentile(mask, 95.0)))
    return torch.from_numpy(np.clip(mask / m95, 0.0, 1.0).astype(np.float32)[..., None]).to(device)


class JumpingSpider(UVAnimal):
    lambdas = np.linspace(300.0, 700.0, 81, dtype=np.float32)
    hsi_scale = 0.25
    panorama_scale = 1.02

    dog_small_sigma = 0.9
    dog_large_sigma = 2.2
    uv_patch_gain = 0.95
    opponent_gain = 0.30
    red_kill = 0.25
    base_soft_sigma = 0.25
    clarity_sigma = 0.9
    clarity_amount = 0.24
    fovea_radius = 0.38
    fovea_softness = 10.0
    periph_blur_sigma = 2.2
    periph_vignette_strength = 0.22
    scan_row_freq = 22.0
    scan_row_gain = 0.08
    scan_soften = 0.9
    spots = ((0.50, 0.52), (0.57, 0.48))
    spot_sigma = 0.08
    spot_gain = 0.20

    def _band_specs(self):
        return [(320.0, 400.0), (500.0, 570.0), (430.0, 500.0), (600.0, 680.0)]

    def _render(self, baseline_lin, maps, plain):
        h, w = int(baseline_lin.shape[-3]), int(baseline_lin.shape[-2])
        u = safe_norm(safe_norm(maps[..., 0:1]))
        gv = safe_norm(maps[..., 1:2])
        bv = safe_norm(maps[..., 2:3])

        render = torch.cat(
            [torch.clamp(baseline_lin[..., 0:1] * (1.0 - self.red_kill), 0.0, 1.0), baseline_lin[..., 1:3]], dim=-1
        )
        render = blur.gaussian_blur_uv(render, self.base_soft_sigma, plain)

        uv_dog = torch.clamp(
            blur.gaussian_blur_uv(u, self.dog_small_sigma, plain) - blur.gaussian_blur_uv(u, self.dog_large_sigma, plain),
            0.0,
            1.0,
        )
        uv_patch = torch.clamp(uv_dog / (percentile(uv_dog, 95.0) + 1e-8), 0.0, 1.0)

        opp = gv - u
        opp = torch.clamp(opp / (percentile(torch.abs(opp), 95.0) + 1e-8), -1.0, 1.0)
        g_boost = torch.clamp(opp, 0.0, 1.0) * self.opponent_gain
        u_boost = torch.clamp(-opp, 0.0, 1.0) * self.opponent_gain
        render = torch.cat(
            [
                torch.clamp(render[..., 0:1] + 0.12 * u_boost * u, 0.0, 1.0),
                torch.clamp(render[..., 1:2] + 0.40 * g_boost, 0.0, 1.0),
                torch.clamp(render[..., 2:3] + 0.30 * u_boost * bv, 0.0, 1.0),
            ],
            dim=-1,
        )

        blurred = blur.gaussian_blur_uv(render, self.clarity_sigma, plain)
        high = torch.clamp(render - blurred, -1.0, 1.0)
        render = torch.clamp(render + (self.clarity_amount * self.uv_patch_gain * uv_patch) * high, 0.0, 1.0)

        row_gain = scanline_gain(h, self.scan_row_freq, self.scan_row_gain, self.scan_soften)
        render = torch.clamp(render * self._const(row_gain), 0.0, 1.0)

        # attention spots
        spots = _spots_mask(h, w, tuple(self.spots), float(self.spot_sigma), str(self.device))
        render = torch.clamp(render + self.spot_gain * spots, 0.0, 1.0)
        sblur = blur.gaussian_blur_uv(render, 0.8, plain)
        sharp = torch.clamp(render + 0.25 * torch.clamp(render - sblur, -1.0, 1.0), 0.0, 1.0)
        render = torch.clamp((1.0 - 0.6 * spots) * render + (0.6 * spots) * sharp, 0.0, 1.0)

        # foveation: strong peripheral blur + vignette
        edge_w = effects.radial_mask_on(render, self.fovea_radius, self.fovea_softness)
        periph = blur.gaussian_blur_uv(render, self.periph_blur_sigma, plain)
        render = (1.0 - edge_w) * render + edge_w * periph
        vign = 1.0 - self.periph_vignette_strength * edge_w
        return torch.clamp(render * vign, 0.0, 1.0)
