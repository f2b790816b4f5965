"""Mantis shrimp: a 10-band spectral barcode and polarization gains.

Counterpart of ``animal_vision_tpu/species/uv/mantis_shrimp.py``: ten
narrow bands -> an N-hue HSV table; a winner-take-most argmax tint blended
with the soft weighted mix (0.35); saturation 1.40; linear and
circular-ish polarization gains from the local orientation of the broad
energy (E-vector 30 deg, mix 0.5); a polarization-guided unsharp mask;
barcode blend 0.55; midband scanlines (freq 26, gain 0.08, soften 0.8);
peripheral blur 0.7; panorama 1.12. Every statistic (each band's min and
max, the 95th percentile) is per frame."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from animal_vision_tpu_torch.core import blur, effects, gradients, linalg
from animal_vision_tpu_torch.core.stats import luminance709, percentile
from animal_vision_tpu_torch.species.uv.common import UVAnimal

BANDS = (
    (320.0, 360.0),
    (360.0, 400.0),
    (400.0, 430.0),
    (430.0, 460.0),
    (460.0, 490.0),
    (490.0, 520.0),
    (520.0, 550.0),
    (550.0, 580.0),
    (580.0, 610.0),
    (610.0, 680.0),
)


def _hue_lut(n: int, sat: float = 0.95) -> np.ndarray:
    """(N, 3) vivid hue circle (HSV to RGB with v = 1)."""
    h = np.arange(n, dtype=np.float32) / max(n, 1)
    i = np.floor(h * 6.0).astype(np.int32) % 6
    f = h * 6.0 - np.floor(h * 6.0)
    v = np.ones_like(h)
    p = v * (1.0 - sat)
    q = v * (1.0 - f * sat)
    t = v * (1.0 - (1.0 - f) * sat)
    r = np.select([i == k for k in range(6)], [v, q, p, p, t, v], default=v)
    g = np.select([i == k for k in range(6)], [t, v, v, q, p, p], default=v)
    b = np.select([i == k for k in range(6)], [p, p, t, v, v, q], default=v)
    return np.stack([r, g, b], axis=-1).astype(np.float32)


def scanline_gain(h: int, freq: float, gain: float, soften: float) -> np.ndarray:
    """(H, 1, 1) row gains of the scanlines: a sine profile of ``freq``
    periods over the frame, UV-blurred with ``soften``, around 1."""
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)
    prof = (0.5 + 0.5 * np.sin(2.0 * np.pi * freq * y)).astype(np.float32)
    rows_j = blur.blur_profile_1d(prof, soften)[:, None]
    return (1.0 + gain * (rows_j - 0.5))[..., None]


class MantisShrimp(UVAnimal):
    lambdas = np.linspace(300.0, 700.0, 81, dtype=np.float32)
    hsi_scale = 0.25
    panorama_scale = 1.12

    red_kill = 0.18
    haze_strength = 0.03
    haze_tint = np.array([0.92, 0.98, 1.00], np.float32)
    pre_soft_sigma = 0.25
    unsharp_sigma = 1.0
    unsharp_amount = 0.32
    evec_angle_deg = 30.0
    pol_linear_strength = 0.55
    pol_linear_gamma = 1.2
    pol_circular_strength = 0.35
    orientation_mix = 0.5
    barcode_saturation = 0.40
    barcode_opacity = 0.55
    winner_take_most = 0.35
    scan_row_freq = 26.0
    scan_row_gain = 0.08
    scan_soften = 0.8
    periph_blur_sigma = 0.7
    periph_radius = 0.80
    periph_softness = 7.0

    def _band_specs(self):
        return list(BANDS)

    def _render(self, baseline_lin, maps, plain):
        h = int(baseline_lin.shape[-3])
        n = maps.shape[-1]
        # every band min-max normalized over its frame
        mn = torch.amin(maps, dim=(-3, -2), keepdim=True)
        rng = torch.amax(maps, dim=(-3, -2), keepdim=True) - mn
        flat = rng < 1e-9
        s = torch.where(flat, 0.0, (maps - mn) / torch.where(flat, 1.0, rng))

        lut = self._const(_hue_lut(n))
        s_norm = torch.clamp(s / (percentile(s, 95.0) + 1e-8), 0.0, 1.0)
        max_idx = torch.argmax(s_norm, dim=-1)
        weights = s_norm / (torch.sum(s_norm, dim=-1, keepdim=True) + 1e-8)
        wtm = self.winner_take_most
        w_comb = (1.0 - wtm) * weights + wtm * F.one_hot(max_idx, n).to(torch.float32)
        barcode = linalg.frame_matmul(w_comb, lut)
        yb = luminance709(barcode)
        barcode = torch.clamp(yb + (barcode - yb) * (1.0 + self.barcode_saturation), 0.0, 1.0)

        render = torch.cat(
            [torch.clamp(baseline_lin[..., 0:1] * (1.0 - self.red_kill), 0.0, 1.0), baseline_lin[..., 1:3]], dim=-1
        )
        a = float(np.clip(self.haze_strength, 0.0, 1.0))
        render = (1.0 - a) * render + a * self._const(self.haze_tint)
        render = blur.gaussian_blur_uv(render, self.pre_soft_sigma, plain)

        broad = torch.mean(s_norm, dim=-1, keepdim=True)
        theta = torch.atan2(gradients.sobel_y(broad), gradients.sobel_x(broad))
        evec = float(np.deg2rad(self.evec_angle_deg))
        mix = self.orientation_mix
        cos2 = (1.0 - mix) * float(np.cos(2 * evec)) + mix * torch.cos(2.0 * theta)
        sin2 = (1.0 - mix) * float(np.sin(2 * evec)) + mix * torch.sin(2.0 * theta)
        align01 = torch.clamp(0.5 * (cos2 + 1.0), 0.0, 1.0) ** self.pol_linear_gamma
        align_circ = torch.clamp(0.5 * (sin2 + 1.0), 0.0, 1.0)
        pol_gain = 1.0 + self.pol_linear_strength * align01 + self.pol_circular_strength * align_circ
        blurred = blur.gaussian_blur_uv(render, self.unsharp_sigma, plain)
        high = torch.clamp(render - blurred, -1.0, 1.0)
        render = torch.clamp(render + (self.unsharp_amount * pol_gain) * high, 0.0, 1.0)

        render = torch.clamp((1.0 - self.barcode_opacity) * render + self.barcode_opacity * barcode, 0.0, 1.0)
        row_gain = scanline_gain(h, self.scan_row_freq, self.scan_row_gain, self.scan_soften)
        render = torch.clamp(render * self._const(row_gain), 0.0, 1.0)

        return effects.peripheral_blur(
            render, self.periph_blur_sigma, self.periph_radius, self.periph_softness, plain
        )
