"""Colorimetry of the Mallett 2019 spectral recovery, in NumPy.

Counterpart of ``animal_vision_tpu/spectral/colorimetry.py``, the
colorimetry that the shipped basis (``spectral/data/mallett2019_basis_5nm.npz``)
was solved against:

- the CIE 1931 2-degree colour matching functions as the multi-lobe
  piecewise Gaussian fits of Wyman, Sloan & Shirley 2013 ("Simple Analytic
  Approximations to the CIE XYZ Color Matching Functions", JCGT 2(2));
- the CIE D65 relative SPD from 20 nm anchors, linearly interpolated,
  100 at 560 nm;
- the sRGB primaries of IEC 61966-2-1 with the white point computed from
  the two above, so that a flat unit spectrum maps to linear RGB (1, 1, 1)
  exactly.
"""

from __future__ import annotations

import numpy as np

#: sRGB primary chromaticities (IEC 61966-2-1)
SRGB_PRIMARIES = np.array([[0.64, 0.33], [0.30, 0.60], [0.15, 0.06]], dtype=np.float64)

#: CIE D65 relative SPD anchors (wavelength nm, power; 100 at 560 nm), 380-780 nm
_D65_ANCHORS = np.array(
    [
        (380.0, 49.98), (400.0, 82.75), (420.0, 93.43), (440.0, 104.86),
        (460.0, 117.81), (480.0, 115.92), (500.0, 109.35), (520.0, 104.79),
        (540.0, 104.41), (560.0, 100.00), (580.0, 95.79), (600.0, 90.01),
        (620.0, 87.70), (640.0, 83.70), (660.0, 80.21), (680.0, 78.27),
        (700.0, 71.61), (720.0, 61.60), (740.0, 75.09), (760.0, 46.42),
        (780.0, 63.38),
    ],
    dtype=np.float64,
)


def _lobe(wl, peak, center, s_left, s_right):
    """One piecewise Gaussian of the Wyman et al. 2013 fit family."""
    t = (wl - center) * np.where(wl < center, s_left, s_right)
    return peak * np.exp(-0.5 * t * t)


def cie_xyz_cmf(wavelengths: np.ndarray) -> np.ndarray:
    """(3, N) CIE 1931 2-degree x, y, z matching functions (the
    Wyman-Sloan-Shirley multi-lobe fits)."""
    wl = np.asarray(wavelengths, dtype=np.float64)
    x = (
        _lobe(wl, 0.362, 442.0, 0.0624, 0.0374)
        + _lobe(wl, 1.056, 599.8, 0.0264, 0.0323)
        - _lobe(wl, 0.065, 501.1, 0.0490, 0.0382)
    )
    y = _lobe(wl, 0.821, 568.8, 0.0213, 0.0247) + _lobe(wl, 0.286, 530.9, 0.0613, 0.0322)
    z = _lobe(wl, 1.217, 437.0, 0.0845, 0.0278) + _lobe(wl, 0.681, 459.0, 0.0385, 0.0725)
    return np.stack([x, y, z], axis=0)


def d65_spd(wavelengths: np.ndarray) -> np.ndarray:
    """(N,) CIE D65 relative SPD (linear interpolation of the 20 nm anchors)."""
    wl = np.asarray(wavelengths, dtype=np.float64)
    return np.interp(wl, _D65_ANCHORS[:, 0], _D65_ANCHORS[:, 1])


def spectrum_to_xyz_operator(wavelengths: np.ndarray) -> np.ndarray:
    """(3, N) operator from reflectance samples to XYZ under D65, scaled so
    that a flat unit reflectance has Y = 1 (summation quadrature)."""
    t = cie_xyz_cmf(wavelengths) * d65_spd(wavelengths)[None, :]
    return t / t[1].sum()


def srgb_matrices(wavelengths: np.ndarray):
    """(M_xyz2rgb, T_rgb): T_rgb = M_xyz2rgb @ T_xyz maps reflectance samples
    to linear sRGB, with M built from the sRGB primaries and the white point
    of this module's colorimetry, so that T_rgb @ ones == (1, 1, 1)."""
    t_xyz = spectrum_to_xyz_operator(wavelengths)
    white = t_xyz.sum(axis=1)  # XYZ of the flat unit reflectance (Y == 1)
    xy = SRGB_PRIMARIES
    # columns: the XYZ direction of each primary at Y = 1
    p = np.stack([xy[:, 0] / xy[:, 1], np.ones(3), (1.0 - xy[:, 0] - xy[:, 1]) / xy[:, 1]], axis=0)
    scale = np.linalg.solve(p, white)
    m_xyz2rgb = np.linalg.inv(p * scale[None, :])
    return m_xyz2rgb, m_xyz2rgb @ t_xyz
