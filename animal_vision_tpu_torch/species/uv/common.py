"""The shared skeleton of the UV species.

Counterpart of ``animal_vision_tpu/species/uv/common.py``. The chain:
to_float01 -> sRGB->linear -> panorama warp (the baseline is the warped
frame) -> area-downsample -> band maps of the analytic spectrum ->
linear-upsample -> the species' rendering in linear RGB -> linear->sRGB ->
dtype restore. Frames are (..., H, W, 3) and maps (..., H, W, n); every
statistic is per frame, so a batch equals its frames.

The spectrum is never materialized at full size: the (3, B) lobe matrix
and the (B, n) band weights are two per-frame products with a relu between
(``_integrate_maps``), at the downsampled size. The reference's double
linearization is kept: the converter linearizes the already-linear
baseline.

``hsi_provider`` (``models/providers.py``, MST++) replaces the analytic
upsampler: the model runs on the downsampled frame and the band columns
contract its cube per frame.

Not ported: the JAX package's padded-bucket programs, which exist to bound
XLA recompiles and give the exact program's outputs; the port runs every
shape as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from animal_vision_tpu_torch.core import color, geometry, linalg
from animal_vision_tpu_torch.core.tables import device_table
from animal_vision_tpu_torch.species.base import Animal, Program
from animal_vision_tpu_torch.spectral import bands as spectral_bands
from animal_vision_tpu_torch.spectral import classic


def _integrate_maps(lin: torch.Tensor, g: torch.Tensor, wmat: torch.Tensor) -> torch.Tensor:
    """relu(lin @ G) @ W: the analytic cube contracted to band maps.

    The JAX package's ``nb <= 100`` branch, used for every band count: its
    planar form for more bands (rat_uv's 129) is an XLA input-fusion trick
    that recomputes the cube per map so that it never reaches HBM; it sums
    the same products in another order, and the two products here stay
    within its bars (``tests/test_torch_rat_uv.py``)."""
    return linalg.frame_matmul(torch.clamp(linalg.frame_matmul(lin, g), min=0.0), wmat)


def compute_band_maps(
    frame: torch.Tensor, lambdas: np.ndarray, weight_columns: np.ndarray, hsi_scale: float
) -> torch.Tensor:
    """(..., H, W, n) raw band integrals of the analytic spectrum of
    (..., H, W, 3) ``frame`` (linearized here, as the reference's converter
    does with whatever it is given). ``weight_columns`` is (B, n);
    0 < ``hsi_scale`` < 1 takes the area-down, linear-up speed path."""
    g = device_table(classic.lobe_matrix(tuple(float(v) for v in np.asarray(lambdas))), frame.device)
    wmat = device_table(np.asarray(weight_columns, dtype=np.float32), frame.device)

    def maps_of(x):
        return _integrate_maps(color.srgb_to_linear(x), g, wmat)

    frame = frame.to(torch.float32)
    h, w = int(frame.shape[-3]), int(frame.shape[-2])
    if 0.0 < hsi_scale < 1.0:
        small = (max(1, int(round(h * hsi_scale))), max(1, int(round(w * hsi_scale))))
        return geometry.resize(maps_of(geometry.resize(frame, small, "area")), (h, w), "linear")
    return maps_of(frame)


def band_weight_columns(lambdas: np.ndarray, band_specs) -> np.ndarray:
    """(B, n) stack of raised-cosine band weights for (lo, hi) pairs."""
    lam = tuple(float(v) for v in np.asarray(lambdas))
    cols = [spectral_bands.bandpass_weights(lam, lo, hi) for lo, hi in band_specs]
    return np.stack(cols, axis=1)


class UVAnimal(Animal):
    """Base for UV species following the shared skeleton. Subclasses set
    ``lambdas``, ``hsi_scale``, ``panorama_scale``, declare ``_band_specs``
    ((lo, hi) nm pairs) and implement ``_render``.

    ``hsi_provider`` (optional, ``use_hsi_provider``) replaces the analytic
    upsampler: a callable ``(frames, plain) -> cube`` from the frames the
    converter would get to an (..., h, w, len(lambdas)) cube."""

    lambdas: np.ndarray = np.linspace(300.0, 700.0, 81, dtype=np.float32)
    hsi_scale: float = 0.25
    panorama_scale: float = 1.0
    hsi_provider = None

    def _band_specs(self) -> list[tuple[float, float]]:
        raise NotImplementedError

    def _render(self, baseline_lin: torch.Tensor, maps: torch.Tensor, plain: bool) -> torch.Tensor:
        """Linear-RGB rendering of (..., H, W, 3) ``baseline_lin`` with the
        (..., H, W, n) band ``maps``; ``plain`` selects the blurs' plain
        versions."""
        raise NotImplementedError

    def _const(self, a) -> torch.Tensor:
        """A small float32 constant on this animal's device, made once."""
        return device_table(a, self.device)

    def use_hsi_provider(self, provider, lambdas: np.ndarray | None = None) -> "UVAnimal":
        """Swap in a model-based RGB -> HSI provider (and its band grid)."""
        self.hsi_provider = provider
        if lambdas is not None:
            self.lambdas = np.asarray(lambdas)
        self._programs.clear()
        return self

    def _small_dims(self, h: int, w: int) -> tuple[int, int]:
        return (
            max(1, int(round(h * self.hsi_scale))),
            max(1, int(round(w * self.hsi_scale))),
        )

    def _chain(self, dtype: torch.dtype, plain: bool, warp_fn, down_fn, up_fn) -> Program:
        """The species chain with the shape-dependent geometry injected:
        ``warp_fn`` (panorama or identity), ``down_fn``/``up_fn`` (the
        spectral speed path's resizes, or None at full size)."""
        g = self._table(classic.lobe_matrix(tuple(float(v) for v in np.asarray(self.lambdas))))
        cols = self._table(band_weight_columns(self.lambdas, self._band_specs()))
        provider = self.hsi_provider

        def maps_of(x):
            if provider is not None:
                return linalg.frame_matmul(provider(x, plain=plain), cols)
            return _integrate_maps(color.srgb_to_linear(x), g, cols)

        def fn(image):
            img_lin = color.srgb_to_linear(color.to_float01(image))
            baseline_lin = warp_fn(img_lin)
            baseline_srgb = color.linear_to_srgb(torch.clamp(baseline_lin, 0.0, 1.0))
            baseline_out = color.from_float01(baseline_srgb, dtype)
            if down_fn is not None:
                maps = up_fn(maps_of(down_fn(baseline_lin)))
            else:
                maps = maps_of(baseline_lin)
            render = self._render(baseline_lin, maps, plain)
            out = color.from_float01(color.linear_to_srgb(torch.clamp(render, 0.0, 1.0)), dtype)
            return baseline_out, out

        return fn

    def _build_program(self, shape, dtype, kernels):
        h, w = int(shape[0]), int(shape[1])
        if self.panorama_scale and abs(self.panorama_scale - 1.0) >= 1e-3:
            warp_fn = lambda x: geometry.panorama_warp(x, self.panorama_scale)  # noqa: E731
        else:
            warp_fn = lambda x: x  # noqa: E731
        down_fn = up_fn = None
        if 0.0 < self.hsi_scale < 1.0:
            small = self._small_dims(h, w)
            down_fn = lambda x: geometry.resize(x, small, "area")  # noqa: E731
            up_fn = lambda x: geometry.resize(x, (h, w), "linear")  # noqa: E731
        return self._chain(dtype, not kernels, warp_fn, down_fn, up_fn)
