"""RatUV: a UV-aware rat with a day/night mode.

Counterpart of ``animal_vision_tpu/species/uv/rat_uv.py``: 129 float64
bands over 320-700 nm, UV 330-400 / B 400-500 / G 500-600, a falsecolor
proxy (``map_falsecolor``'s weights on p95-normalized maps) composited at
alpha 0.55 over the baseline, then the scatter blur and blue bias, the day
soft knee (0.82, 0.65) or the night midtone lift (+0.18), and a vignette
that darkens toward the top (the ground stays bright); panorama 1.45,
``hsi_scale`` 0.55.

``mode="auto"`` chooses per frame: night where the median Rec.709 luma of
the frame's ``to_float01`` is below 0.12 (``core/stats.percentile`` at 50,
which averages the two middle values as ``jnp.median`` does). Both
renderings run and ``torch.where`` selects per frame, so a batch equals
its frames and nothing waits for the device; "day" and "night" run one.
"""

from __future__ import annotations

import numpy as np
import torch

from animal_vision_tpu_torch.core import color, effects
from animal_vision_tpu_torch.core.stats import percentile, safe_norm
from animal_vision_tpu_torch.species.uv.common import UVAnimal

NIGHT_LUMA = 0.12


class RatUV(UVAnimal):
    lambdas = np.linspace(320.0, 700.0, 129, dtype=np.float64)
    hsi_scale = 0.55
    panorama_scale = 1.45

    uv_boost_alpha = 0.55
    day_blur_sigma = 0.8
    night_blur_sigma = 1.25
    blue_bias_day = 0.03
    blue_bias_night = 0.05
    tone_knee = 0.82
    tone_strength = 0.65
    ground_vignette_day = 0.10
    ground_vignette_night = 0.14
    mode = "auto"  # "auto" | "day" | "night"

    _night: torch.Tensor | None = None

    def _band_specs(self):
        return [(330.0, 400.0), (400.0, 500.0), (500.0, 600.0)]

    def _render_mode(self, comp: torch.Tensor, night: bool, plain: bool) -> torch.Tensor:
        sigma = self.night_blur_sigma if night else self.day_blur_sigma
        bias = self.blue_bias_night if night else self.blue_bias_day
        render = effects.scatter_and_blue_bias(comp, sigma, bias, plain)
        if night:
            y = 0.2126 * render[..., 0:1] + 0.7152 * render[..., 1:2] + 0.0722 * render[..., 2:3]
            render = torch.clamp(render * ((y + 0.18) / (y + 1e-6)), 0.0, 1.0)
            gv = self.ground_vignette_night
        else:
            render = effects.snow_glare_tone_compress(render, self.tone_strength, self.tone_knee)
            gv = self.ground_vignette_day
        yy = np.linspace(0.0, 1.0, int(render.shape[-3]), dtype=np.float32)
        gain_v = self._const((1.0 - gv * yy)[:, None, None])
        return torch.clamp(render * gain_v, 0.0, 1.0)

    def _render(self, baseline_lin, maps, plain):
        def n95(x):
            return x / torch.clamp(percentile(x, 95.0), min=1e-8)

        un, bn, gn = n95(safe_norm(maps[..., 0:1])), n95(maps[..., 1:2]), n95(maps[..., 2:3])
        false = torch.cat([
            torch.clamp(0.85 * un + 0.10 * gn, 0.0, 1.0),
            torch.clamp(0.80 * gn + 0.20 * bn, 0.0, 1.0),
            torch.clamp(0.70 * bn + 0.40 * un, 0.0, 1.0),
        ], dim=-1)
        a = self.uv_boost_alpha
        comp = torch.clamp((1.0 - a) * baseline_lin + a * false, 0.0, 1.0)
        if self.mode == "day":
            return self._render_mode(comp, False, plain)
        if self.mode == "night":
            return self._render_mode(comp, True, plain)
        return torch.where(self._night, self._render_mode(comp, True, plain), self._render_mode(comp, False, plain))

    @staticmethod
    def is_night(image: torch.Tensor) -> torch.Tensor:
        """Per frame of (..., H, W, 3): median luma of ``to_float01`` below
        0.12, as a (..., 1, 1, 1) bool tensor on the frames' device."""
        img01 = color.to_float01(image)
        y = 0.2126 * img01[..., 0:1] + 0.7152 * img01[..., 1:2] + 0.0722 * img01[..., 2:3]
        return percentile(y, 50.0) < NIGHT_LUMA

    def _build_program(self, shape, dtype, kernels):
        fn = super()._build_program(shape, dtype, kernels)
        if self.mode != "auto":
            return fn

        def auto(image):
            self._night = self.is_night(image)
            try:
                return fn(image)
            finally:
                self._night = None

        return auto
