"""Anableps (four-eyed fish): split-world air/water rendering.

Counterpart of ``animal_vision_tpu/species/uv/anableps.py``: a rippled
horizon (sine, amplitude 6 px, 2.5 waves at y = 0.44) and a sigmoid
air/water seam (softness 8 px); the air branch a warm gain (1.06, 1.03,
0.99) and an unsharp mask (sigma 1.0, 0.35); the water branch goldfish-style
attenuation (red kill 0.55, lifts 0.12/0.08), haze (0.10, tint 0.80/0.92/
1.00), blur 0.7, a UV shimmer (boost 3.4, gains R/G/B 0.36/0.18/0.42), band
reinforcement (0.20 Bv, 0.26 Gv) and an exponential refraction push below
the horizon (3 px, decay 2.5 seam) as a static vertical remap; peripheral
blur 1.2 at r 0.70, softness 6; panorama 1.2."""

from __future__ import annotations

import functools

import numpy as np
import torch

from animal_vision_tpu_torch.core import blur, effects, geometry
from animal_vision_tpu_torch.core.stats import safe_norm
from animal_vision_tpu_torch.species.uv.common import UVAnimal


@functools.lru_cache(maxsize=16)
def _device_geometry(h: int, w: int, params: tuple, device: str):
    """(air weight (H, W, 1), water weight (H, W, 1), the refraction's
    vertical remap plan) on ``device``, from the host tables of
    ``Anableps._geometry_tables``."""
    air_w, map_y = Anableps.geometry_tables(h, w, *params)
    return (torch.from_numpy(air_w[..., None]).to(device), torch.from_numpy((1.0 - air_w)[..., None]).to(device),
            geometry.vertical_remap_plan(map_y, device))


class Anableps(UVAnimal):
    lambdas = np.linspace(300.0, 700.0, 81, dtype=np.float32)
    hsi_scale = 0.25
    panorama_scale = 1.20

    horizon_y = 0.44
    seam_softness_px = 8.0
    ripple_amp_px = 6.0
    ripple_waves = 2.5
    refract_push_px = 3.0
    air_warmth = np.array([1.06, 1.03, 0.99], dtype=np.float32)
    air_clarity_unsharp = 0.35
    air_unsharp_sigma = 1.0
    red_kill = 0.55
    blue_lift = 0.08
    green_lift = 0.12
    haze_strength = 0.10
    haze_tint = np.array([0.80, 0.92, 1.00], dtype=np.float32)
    base_blur_sigma_water = 0.7
    uv_boost = 3.4
    uv_r_gain = 0.36
    uv_g_gain = 0.18
    uv_b_gain = 0.42
    periph_blur_sigma = 1.2
    periph_radius = 0.70
    periph_softness = 6.0

    def _band_specs(self):
        return [(320.0, 400.0), (430.0, 500.0), (500.0, 570.0), (600.0, 680.0)]

    @staticmethod
    def geometry_tables(h: int, w: int, horizon_y: float, ripple_amp_px: float, ripple_waves: float,
                        seam_softness_px: float, refract_push_px: float) -> tuple[np.ndarray, np.ndarray]:
        """(H, W) air weight of the rippled seam and (H, W) source row of
        the refraction push, float32."""
        y0 = int(np.clip(horizon_y * h, 0, h - 1))
        if ripple_amp_px > 0.0:
            x = np.linspace(0, 2.0 * np.pi * ripple_waves, w, dtype=np.float32)
            ripple = (ripple_amp_px * np.sin(x)).astype(np.float32)
        else:
            ripple = np.zeros((w,), np.float32)
        yy = np.arange(h, dtype=np.float32)[:, None]
        seam = max(1.0, float(seam_softness_px))
        horizon = y0 + ripple[None, :]
        dist = yy - horizon
        air_w = (1.0 / (1.0 + np.exp(+dist / seam))).astype(np.float32)

        y_idx = np.repeat(np.arange(h, dtype=np.float32)[:, None], w, axis=1)
        below = np.maximum(y_idx - horizon, 0.0)
        push = refract_push_px * np.exp(-below / (2.5 * seam))
        map_y = np.clip(y_idx + push, 0, h - 1).astype(np.float32)
        return air_w, map_y

    def _render(self, baseline_lin, maps, plain):
        h, w = int(baseline_lin.shape[-3]), int(baseline_lin.shape[-2])
        un = safe_norm(safe_norm(maps[..., 0:1]))
        bv = safe_norm(maps[..., 1:2])
        gv = safe_norm(maps[..., 2:3])
        params = (float(self.horizon_y), float(self.ripple_amp_px), float(self.ripple_waves),
                  float(self.seam_softness_px), float(self.refract_push_px))
        air_w, water_w, remap = _device_geometry(h, w, params, str(self.device))

        # air branch
        air = torch.clamp(baseline_lin * self._const(self.air_warmth), 0.0, 1.0)
        air = torch.clamp(
            air + self.air_clarity_unsharp
            * torch.clamp(air - blur.gaussian_blur_uv(air, self.air_unsharp_sigma, plain), -1.0, 1.0),
            0.0,
            1.0,
        )

        # water branch
        water = torch.cat(
            [
                torch.clamp(baseline_lin[..., 0:1] * (1.0 - self.red_kill), 0.0, 1.0),
                torch.clamp(baseline_lin[..., 1:2] + self.green_lift, 0.0, 1.0),
                torch.clamp(baseline_lin[..., 2:3] + self.blue_lift, 0.0, 1.0),
            ],
            dim=-1,
        )
        a = float(np.clip(self.haze_strength, 0.0, 1.0))
        water = (1.0 - a) * water + a * self._const(self.haze_tint)
        water = blur.gaussian_blur_uv(water, self.base_blur_sigma_water, plain)
        water = torch.cat(
            [
                torch.clamp(water[..., 0:1] + self.uv_boost * self.uv_r_gain * un, 0.0, 1.0),
                torch.clamp(water[..., 1:2] + self.uv_boost * self.uv_g_gain * un, 0.0, 1.0),
                torch.clamp(water[..., 2:3] + self.uv_boost * self.uv_b_gain * un, 0.0, 1.0),
            ],
            dim=-1,
        )
        water = torch.cat(
            [
                water[..., 0:1],
                torch.clamp(water[..., 1:2] + 0.26 * gv, 0.0, 1.0),
                torch.clamp(water[..., 2:3] + 0.20 * bv, 0.0, 1.0),
            ],
            dim=-1,
        )
        if self.refract_push_px > 0.0:
            water = geometry.vertical_remap_static(water, remap)

        render = air * air_w + water * water_w
        return effects.peripheral_blur(
            render, self.periph_blur_sigma, self.periph_radius, self.periph_softness, plain
        )
