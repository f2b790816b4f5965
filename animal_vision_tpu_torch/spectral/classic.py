"""The analytic 3-lobe RGB -> spectrum upsampler.

Counterpart of ``animal_vision_tpu/spectral/classic.py`` in
``mode="analytic"``: three Gaussian lobes (610/545/460 nm, sigmas
60/60/55) weighted by the linearized channels and normalized by the mean
total lobe response, i.e. ``cube = relu(linear(rgb) @ G)`` for a constant
(3, B) matrix G. The reference's channel-naming quirk is kept: it names its
input BGR but is fed RGB, so channel 0 drives the 460 nm lobe. Every
species integrates the cube against band weights at once, so it folds to
``linear(rgb) @ (G @ W)`` (``fused_band_matrix``).

``mode="mallett"`` is the reference's CPU path, Mallett & Yuksel 2019's
recovery ``sd = r B_r + g B_g + b B_b``: equally linear, so the same
products with the (3, B) basis in G's place. The basis is the package's
own table, ``spectral/data/mallett2019_basis_5nm.npz`` (solved against
``spectral/colorimetry.py``), interpolated linearly onto the caller's
grid. Unlike the analytic mode, channel 0 drives the red basis: each mode
keeps its own reference path's channel order.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from animal_vision_tpu_torch.core import color, linalg

_CENTERS = (610.0, 545.0, 460.0)  # R, G, B lobe centers (nm)
_SIGMAS = (60.0, 60.0, 55.0)
DATA = Path(__file__).resolve().parent / "data"


@functools.lru_cache(maxsize=None)
def lobe_matrix(wavelengths: tuple, assume_bgr_names: bool = True, dtype=np.float32) -> np.ndarray:
    """(3, B) matrix G mapping linearized channels to the spectral cube,
    with the mean-total-response normalization."""
    wl = np.asarray(wavelengths, dtype=np.float64)
    g_r = np.exp(-0.5 * ((wl - _CENTERS[0]) / _SIGMAS[0]) ** 2)
    g_g = np.exp(-0.5 * ((wl - _CENTERS[1]) / _SIGMAS[1]) ** 2)
    g_b = np.exp(-0.5 * ((wl - _CENTERS[2]) / _SIGMAS[2]) ** 2)
    denom = (g_r + g_g + g_b).mean() + 1e-8
    if assume_bgr_names:
        g = np.stack([g_b, g_g, g_r], axis=0)  # channel 0 -> 460 nm lobe
    else:
        g = np.stack([g_r, g_g, g_b], axis=0)
    return (g / denom).astype(dtype)


def check_uniform(wavelengths: np.ndarray) -> float:
    """The reference's uniform-grid requirement; returns the step."""
    if wavelengths.size < 2:
        raise ValueError("Need at least two wavelengths.")
    step = float(wavelengths[1] - wavelengths[0])
    if not np.allclose(np.diff(wavelengths), step):
        raise ValueError("`wavelengths` must be uniformly spaced.")
    return step


@functools.lru_cache(maxsize=None)
def _mallett_table(source: str = "derived"):
    """(5 nm wavelengths, (3, 81) basis) of Mallett 2019. ``source=
    "published"`` reads colour-science's own tabulation from
    ``data/mallett2019_published_5nm.npz`` (keys ``wl``, ``basis`` (N, 3)),
    which the repository does not hold: it raises FileNotFoundError."""
    if source == "published":
        with np.load(DATA / "mallett2019_published_5nm.npz") as z:
            return z["wl"].copy(), z["basis"].T.copy()
    with np.load(DATA / "mallett2019_basis_5nm.npz") as z:
        return z["wavelengths"].copy(), z["basis"].copy()


@functools.lru_cache(maxsize=None)
def mallett_basis_matrix(wavelengths: tuple, dtype=np.float32) -> np.ndarray:
    """(3, B) Mallett 2019 basis on the requested grid: linear
    interpolation of the 5 nm table, clamped to its ends outside
    380-780 nm."""
    wl_tab, basis = _mallett_table()
    wl = np.asarray(wavelengths, dtype=np.float64)
    return np.stack([np.interp(wl, wl_tab, basis[i]) for i in range(3)], axis=0).astype(dtype)


def upsampler_matrix(wavelengths: np.ndarray, mode: str, dtype=np.float32) -> np.ndarray:
    """The (3, B) matrix of ``mode`` ("analytic" or "mallett") on a grid."""
    key = tuple(float(v) for v in np.asarray(wavelengths))
    if mode == "analytic":
        return lobe_matrix(key, dtype=dtype)
    if mode == "mallett":
        return mallett_basis_matrix(key, dtype=dtype)
    raise ValueError(f"mode must be 'analytic' or 'mallett', got {mode!r}")


def classic_rgb_to_hsi(
    frame: torch.Tensor,
    wavelengths: np.ndarray | None = None,
    linearize: bool = True,
    mode: str = "analytic",
) -> torch.Tensor:
    """Explicit (..., H, W, B) cube of (..., H, W, 3) frames. Like the
    reference, the input is linearized as it is (uint8-range values are not
    rescaled first)."""
    if wavelengths is None:
        wavelengths = np.linspace(400.0, 700.0, 31, dtype=np.float32)
    check_uniform(np.asarray(wavelengths))
    g = torch.from_numpy(upsampler_matrix(wavelengths, mode)).to(frame.device)
    x = frame.to(torch.float32)
    if linearize:
        x = color.srgb_to_linear(x)
    return torch.clamp(linalg.frame_matmul(x, g), min=0.0)


def fused_band_matrix(wavelengths: np.ndarray, weight_vectors: np.ndarray, mode: str = "analytic") -> np.ndarray:
    """(3, n) float32 = G @ W in float64: integrates bands straight from
    linearized RGB without the cube (exact up to float association, since
    both maps are linear)."""
    check_uniform(np.asarray(wavelengths))
    g = upsampler_matrix(wavelengths, mode, np.float64)
    w = np.asarray(weight_vectors, dtype=np.float64)
    if w.ndim == 1:
        w = w[:, None]
    return (g @ w).astype(np.float32)
