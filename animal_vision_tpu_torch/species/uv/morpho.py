"""Morpho butterfly: structural blue iridescence and an ommatidial mosaic.

Counterpart of ``animal_vision_tpu/species/uv/morpho.py``: the orientation
of the blue-band texture drives a cyan <-> deep-blue shift; a UV gloss
sheen [0.10, 0.25, 0.45] times 0.55; an ommatidial mosaic (area down by
0.35, nearest up); center clarity as an inverse vignette (unsharp 0.22,
sigma 1.0, radius 0.82, softness 7); panorama 1.05. Every statistic is per
frame.

``orientation_gate`` (None keeps the reference's behaviour): on flat frames
the orientation is the arctangent of numerical noise, and a gate fades the
shift and the sheen to neutral where the raw band's range is below it.
``species.get_animal("morpho")`` reads it from ``ANIMAL_VISION_MORPHO_GATE``.
"""

from __future__ import annotations

import numpy as np
import torch

from animal_vision_tpu_torch.core import blur, effects, geometry, gradients
from animal_vision_tpu_torch.core.stats import percentile, safe_norm
from animal_vision_tpu_torch.species.uv.common import UVAnimal


def _frame_range(m: torch.Tensor) -> torch.Tensor:
    """max - min of each frame of (..., H, W, 1)."""
    return torch.amax(m, dim=(-3, -2, -1), keepdim=True) - torch.amin(m, dim=(-3, -2, -1), keepdim=True)


class Morpho(UVAnimal):
    lambdas = np.linspace(300.0, 700.0, 81)
    hsi_scale = 0.25
    panorama_scale = 1.05

    sheen_strength = 0.55
    hue_shift_strength = 0.45
    gloss_sigma = 1.0
    mosaic_downscale = 0.35
    center_clarity = 0.25
    vignette_softness = 7.0
    vignette_radius = 0.82
    orientation_gate: float | None = None

    def _band_specs(self):
        return [(320.0, 400.0), (440.0, 500.0), (500.0, 570.0)]

    def _render(self, baseline_lin, maps, plain):
        u = safe_norm(safe_norm(maps[..., 0:1]))
        bv = safe_norm(maps[..., 1:2])

        ori = torch.atan2(gradients.sobel_y(bv), gradients.sobel_x(bv))
        align = 0.5 * (1.0 + torch.cos(2.0 * ori))
        if self.orientation_gate is not None:
            gate = torch.clamp(_frame_range(maps[..., 1:2]) / self.orientation_gate, 0.0, 1.0)
            align = 0.5 + gate * (align - 0.5)

        gloss = blur.gaussian_blur_uv(u, self.gloss_sigma, plain)
        gloss = torch.clamp(gloss / (percentile(gloss, 95.0) + 1e-8), 0.0, 1.0)
        if self.orientation_gate is not None:
            gloss = gloss * torch.clamp(_frame_range(maps[..., 0:1]) / self.orientation_gate, 0.0, 1.0)

        shift_cyan = self.hue_shift_strength * align
        shift_deep = self.hue_shift_strength * (1.0 - align)
        render = torch.cat(
            [
                baseline_lin[..., 0:1],
                torch.clamp(baseline_lin[..., 1:2] + 0.35 * shift_cyan, 0.0, 1.0),
                torch.clamp(baseline_lin[..., 2:3] + 0.40 * shift_deep + 0.25 * shift_cyan, 0.0, 1.0),
            ],
            dim=-1,
        )
        sheen = self._const(np.array([0.10, 0.25, 0.45], np.float32))
        render = torch.clamp(render + self.sheen_strength * gloss * sheen, 0.0, 1.0)

        # ommatidial mosaic: area down, nearest up
        h, w = int(render.shape[-3]), int(render.shape[-2])
        hs = max(1, int(round(h * self.mosaic_downscale)))
        ws = max(1, int(round(w * self.mosaic_downscale)))
        render = geometry.resize(geometry.resize(render, (hs, ws), "area"), (h, w), "nearest")

        # center clarity (inverse vignette)
        t = effects.radial_mask_on(render, self.vignette_radius, self.vignette_softness)
        sharp = render + 0.22 * (render - blur.gaussian_blur_uv(render, 1.0, plain))
        return torch.clamp((1.0 - t) * sharp + t * render, 0.0, 1.0)
