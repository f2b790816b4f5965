"""Reindeer: UV saliency boost with snow-glare control.

Counterpart of ``animal_vision_tpu/species/uv/reindeer.py``: the UV band
300-410 nm boosted 3.5x against a 420-680 nm backdrop, soft-knee snow-glare
compression 0.55, winter scatter blur 1.2 plus blue bias 0.08, panorama
1.3, spectral maps at 0.25 scale."""

from __future__ import annotations

import numpy as np
import torch

from animal_vision_tpu_torch.core import effects
from animal_vision_tpu_torch.core.stats import safe_norm
from animal_vision_tpu_torch.species.uv.common import UVAnimal


class Reindeer(UVAnimal):
    lambdas = np.linspace(300.0, 700.0, 81, dtype=np.float32)
    hsi_scale = 0.25
    panorama_scale = 1.3

    uv_boost = 3.5
    snow_glare_compression = 0.55
    winter_mode = True
    scatter_sigma = 1.2
    blue_bias = 0.08

    def _band_specs(self):
        return [(300.0, 410.0), (420.0, 680.0)]

    def _render(self, baseline_lin, maps, plain):
        uv_map = safe_norm(maps[..., 0:1])
        vis_map = safe_norm(maps[..., 1:2])
        uv_sal = safe_norm(uv_map / (1e-6 + 0.6 * vis_map))

        render = torch.cat(
            [
                baseline_lin[..., 0:1],
                torch.clamp(baseline_lin[..., 1:2] + self.uv_boost * 0.15 * uv_sal, 0.0, 1.0),
                torch.clamp(baseline_lin[..., 2:3] + self.uv_boost * 0.35 * uv_sal, 0.0, 1.0),
            ],
            dim=-1,
        )
        render = effects.snow_glare_tone_compress(render, strength=self.snow_glare_compression)
        if self.winter_mode:
            render = effects.scatter_and_blue_bias(render, self.scatter_sigma, self.blue_bias, plain)
        return render
