"""Honeybee: cone catches with von Kries adaptation.

Counterpart of ``animal_vision_tpu/species/uv/honeybee.py``. 31 bands over
400-700 nm (the 350 nm UV cone is sampled only by its >= 400 nm tail, as in
the reference), reflectance x a D65-like illuminant, log-normal cone curves
(350/440/540 nm, sigma 25/30/35, sum-normalized), white-patch adaptation, a
sigma=0.2 UV blur and five mapping modes (default 'opponent'). The baseline
is the input frame. The illuminant and the cone curves fold with the lobe
matrix into one (3, 3) matrix, so the catches come straight from the
linearized frame; the converter gets sRGB [0,1] here (one linearization,
unlike the other UV species). The three catch maps blur as the three
channels of one tensor. ``hsi_provider`` (MST++, ``models/providers.py``)
replaces the analytic cube: it runs on the full-size frame and the catch
columns contract its cube.
"""

from __future__ import annotations

import numpy as np
import torch

from animal_vision_tpu_torch.core import blur, color, geometry, linalg
from animal_vision_tpu_torch.species.base import Animal
from animal_vision_tpu_torch.spectral import bands as sbands
from animal_vision_tpu_torch.spectral import classic, mappers


def honeybee_cone_curves(lambdas: np.ndarray) -> list[np.ndarray]:
    """Log-normal-ish UV/Blue/Green curves, each sum-normalized."""
    lam = np.asarray(lambdas, dtype=np.float64)

    def g(peak, sigma):
        return np.exp(-0.5 * ((lam - peak) / sigma) ** 2)

    out = []
    for c in (g(350.0, 25.0), g(440.0, 30.0), g(540.0, 35.0)):
        c = c.astype(np.float32)
        s = c.sum()
        out.append(c / s if s > 0 else c)
    return out


class HoneyBee(Animal):
    MAPPING_MODES = ("falsecolor", "custom_matrix", "opponent", "uv_purple_yellow", "falsecolor_uv_mixed")

    def __init__(
        self,
        device: str | torch.device = "cuda",
        *,
        hsi_band_centers_nm: np.ndarray | None = None,
        adaptation: str | None = "white_patch",
        mapping_mode: str = "opponent",
        custom_matrix: np.ndarray | None = None,
        blur_sigma_px: float = 0.2,
        assume_hsi_is_reflectance: bool = True,
        hsi_downsample: bool = False,
        hsi_scale: float = 0.1,
        hsi_provider=None,
    ):
        super().__init__(device)
        if mapping_mode not in self.MAPPING_MODES:
            raise ValueError(f"Unknown mapping_mode: {mapping_mode}")
        if mapping_mode == "custom_matrix" and np.shape(custom_matrix) != (3, 3):
            raise ValueError("mapping_mode='custom_matrix' needs a (3, 3) custom_matrix")
        self.lambdas = (
            np.linspace(400.0, 700.0, 31, dtype=np.float32)
            if hsi_band_centers_nm is None
            else np.asarray(hsi_band_centers_nm, dtype=np.float32)
        )
        self.adaptation = adaptation
        self.mapping_mode = mapping_mode
        self.custom_matrix = custom_matrix
        self.blur_sigma_px = float(blur_sigma_px or 0.0)
        self.assume_hsi_is_reflectance = assume_hsi_is_reflectance
        self.hsi_downsample = bool(hsi_downsample)
        self.hsi_scale = float(hsi_scale)
        self.hsi_provider = hsi_provider

    def _catch_columns(self) -> np.ndarray:
        """(B, 3) columns: cone curve x illuminant."""
        curves = honeybee_cone_curves(self.lambdas)
        if self.assume_hsi_is_reflectance:
            e = sbands.d65_like(self.lambdas).astype(np.float64)
        else:
            e = np.ones_like(self.lambdas, dtype=np.float64)
        return np.stack([c.astype(np.float64) * e for c in curves], axis=1)

    def _build_program(self, shape, dtype, kernels):
        h, w = int(shape[0]), int(shape[1])
        m = self._table(classic.fused_band_matrix(self.lambdas, self._catch_columns()))  # (3, 3)
        cols = self._table(self._catch_columns())  # (B, 3)
        provider = self.hsi_provider
        small = None
        if self.hsi_downsample and 0.05 <= self.hsi_scale < 1.0:
            small = (max(1, int(round(h * self.hsi_scale))), max(1, int(round(w * self.hsi_scale))))
        custom = self.custom_matrix
        plain = not kernels

        def catches(img01):
            if provider is not None:
                return linalg.frame_matmul(provider(img01, plain=plain), cols)
            if small is None:
                return linalg.frame_matmul(color.srgb_to_linear(img01), m)
            lin = color.srgb_to_linear(geometry.resize(img01, small, "area"))
            return geometry.resize(linalg.frame_matmul(lin, m), (h, w), "linear")

        def fn(image):
            ubg = catches(color.to_float01(image))
            u, b, g = ubg[..., 0:1], ubg[..., 1:2], ubg[..., 2:3]
            if self.adaptation == "white_patch":
                u, b, g = sbands.von_kries_white_patch(u, b, g)
            elif self.adaptation == "gray_world":
                u, b, g = sbands.von_kries_gray_world(u, b, g)

            if self.blur_sigma_px > 0:
                ubg = blur.gaussian_blur_uv(torch.cat([u, b, g], dim=-1), self.blur_sigma_px, plain)
                u, b, g = ubg[..., 0:1], ubg[..., 1:2], ubg[..., 2:3]

            mode = self.mapping_mode
            if mode == "falsecolor":
                rgb = mappers.map_falsecolor(u, b, g)
            elif mode == "custom_matrix":
                rgb = mappers.map_linear_matrix(u, b, g, custom)
            elif mode == "opponent":
                rgb = mappers.map_opponent(u, b, g)
            elif mode == "uv_purple_yellow":
                rgb = mappers.map_uv_purple_yellow_soft(u)
            else:
                rgb = mappers.map_falsecolor_uv_mixed(u, b, g, alpha=0.45)

            out_srgb = color.linear_to_srgb(torch.clamp(rgb, 0.0, 1.0))
            if not dtype.is_floating_point:
                return image, (out_srgb * 255.0 + 0.5).to(dtype)
            return image, out_srgb.to(dtype)

        return fn
