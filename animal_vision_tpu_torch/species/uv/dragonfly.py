"""Dragonfly: dorsal sky polarization and a ventral water-finder.

Counterpart of ``animal_vision_tpu/species/uv/dragonfly.py``: a sky/ground
sigmoid (prior 0.6, blue 0.4, mid 0.46, steepness 6, blur 2.5, p98); the
elevation-swept sky E-vector (90 deg, sweeping -45 deg down the frame)
against the local orientation of 0.6 B + 0.4 U; water as horizontal
polarization cos(2 theta) on the ground; dorsal +B/+G gains times the
alignment and the sky mask, an exposure balance and the sky gain; ventral
water gains and green support; global clarity and a highlight soft knee
(0.85/0.35); peripheral blur 0.7; panorama 1.15. Every percentile is per
frame."""

from __future__ import annotations

import numpy as np
import torch

from animal_vision_tpu_torch.core import blur, effects, gradients
from animal_vision_tpu_torch.core.stats import percentile, safe_norm
from animal_vision_tpu_torch.species.uv.common import UVAnimal


class Dragonfly(UVAnimal):
    lambdas = np.linspace(300.0, 700.0, 81, dtype=np.float32)
    hsi_scale = 0.25
    panorama_scale = 1.15

    sky_prior_strength = 0.6
    sky_blue_weight = 0.4
    sky_sigmoid_mid = 0.46
    sky_sigmoid_steepness = 6.0
    sky_pol_strength = 0.65
    sky_pol_gamma = 1.3
    water_pol_strength = 0.55
    water_pol_gamma = 1.2
    sky_evec_base_deg = 90.0
    sky_evec_sweep_deg = -45.0
    red_kill = 0.22
    sky_uv_blue_gain = (0.25, 0.20)
    water_uv_blue_gain = (0.30, 0.24)
    ventral_green_gain = 0.12
    base_soft_sigma = 0.30
    unsharp_sigma = 1.0
    unsharp_amount = 0.30
    highlight_knee = 0.85
    highlight_strength = 0.35
    periph_blur_sigma = 0.7
    periph_radius = 0.80
    periph_softness = 7.0

    def _band_specs(self):
        return [(320.0, 400.0), (440.0, 500.0), (500.0, 570.0), (600.0, 680.0)]

    def _render(self, baseline_lin, maps, plain):
        h = int(baseline_lin.shape[-3])
        u = safe_norm(safe_norm(maps[..., 0:1]))
        bv = safe_norm(maps[..., 1:2])
        gv = safe_norm(maps[..., 2:3])

        vert_prior = self._const(np.linspace(1.0, 0.0, h, dtype=np.float32)[:, None, None])
        blue_dom = torch.clamp(bv - 0.6 * gv, 0.0, 1.0)
        score = blur.gaussian_blur_uv(
            self.sky_prior_strength * vert_prior + self.sky_blue_weight * blue_dom, 2.5, plain
        )
        score = score / (percentile(score, 98.0) + 1e-8)
        sky_w = 1.0 / (1.0 + torch.exp(-self.sky_sigmoid_steepness * (score - self.sky_sigmoid_mid)))
        ground_w = 1.0 - sky_w

        ub = 0.6 * bv + 0.4 * u
        theta = torch.atan2(gradients.sobel_y(ub), gradients.sobel_x(ub))
        cos2_l, sin2_l = torch.cos(2.0 * theta), torch.sin(2.0 * theta)
        y_norm = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
        sky_evec = np.deg2rad(self.sky_evec_base_deg) + np.deg2rad(self.sky_evec_sweep_deg) * y_norm
        cos2_s = self._const(np.cos(2.0 * sky_evec).astype(np.float32)[..., None])
        sin2_s = self._const(np.sin(2.0 * sky_evec).astype(np.float32)[..., None])
        align_sky01 = torch.clamp(0.5 * (cos2_l * cos2_s + sin2_l * sin2_s + 1.0), 0.0, 1.0) ** self.sky_pol_gamma
        align_water01 = torch.clamp(0.5 * (cos2_l + 1.0), 0.0, 1.0) ** self.water_pol_gamma

        render = torch.cat(
            [torch.clamp(baseline_lin[..., 0:1] * (1.0 - self.red_kill), 0.0, 1.0), baseline_lin[..., 1:3]], dim=-1
        )
        render = blur.gaussian_blur_uv(render, self.base_soft_sigma, plain)

        sky_gain = 1.0 + self.sky_pol_strength * (align_sky01 * sky_w)
        render = torch.clamp(render * (0.95 + 0.05 * sky_w), 0.0, 1.0)
        render = torch.cat(
            [
                render[..., 0:1],
                torch.clamp(render[..., 1:2] + 0.10 * (u * sky_w * align_sky01), 0.0, 1.0),
                torch.clamp(render[..., 2:3] + self.sky_uv_blue_gain[1] * (bv * sky_w * align_sky01), 0.0, 1.0),
            ],
            dim=-1,
        )
        render = torch.clamp(render * sky_gain, 0.0, 1.0)

        water_gain = 1.0 + self.water_pol_strength * (align_water01 * ground_w)
        b2 = torch.clamp(render[..., 2:3] + self.water_uv_blue_gain[1] * (bv * ground_w * align_water01), 0.0, 1.0)
        b2 = torch.clamp(b2 + self.water_uv_blue_gain[0] * (u * ground_w * align_water01), 0.0, 1.0)
        g2 = torch.clamp(render[..., 1:2] + self.ventral_green_gain * (gv * ground_w), 0.0, 1.0)
        render = torch.cat([render[..., 0:1], g2, b2], dim=-1)
        render = torch.clamp(render * water_gain, 0.0, 1.0)

        blurred = blur.gaussian_blur_uv(render, self.unsharp_sigma, plain)
        high = torch.clamp(render - blurred, -1.0, 1.0)
        render = torch.clamp(render + self.unsharp_amount * high, 0.0, 1.0)
        render = effects.snow_glare_tone_compress(render, strength=self.highlight_strength, knee=self.highlight_knee)
        return effects.peripheral_blur(
            render, self.periph_blur_sigma, self.periph_radius, self.periph_softness, plain
        )
