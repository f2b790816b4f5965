"""The port's host tables against the JAX package's, bit for bit.

Every table the non-UV kernels and species read (colour matrices, Gaussian
taps, kernel sizes, reflect-101 indices, channel mixes, streak and S-cone
tables, resize and warp matrices, the species table) is NumPy on both
sides, so they must be identical arrays."""

import jax  # noqa: F401  (JAX on the CPU backend, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch  # noqa: F401

from animal_vision_tpu.core import blur as jblur
from animal_vision_tpu.core import color as jcolor
from animal_vision_tpu.core import geometry as jgeom
from animal_vision_tpu.ops import fused_nonuv as jfused
from animal_vision_tpu.species.nonuv import NONUV_SPECS as J_SPECS
from animal_vision_tpu_torch.core import blur as tblur
from animal_vision_tpu_torch.core import color as tcolor
from animal_vision_tpu_torch.core import effects as teffects
from animal_vision_tpu_torch.core import geometry as tgeom
from animal_vision_tpu_torch.ops import fused_nonuv as tfused
from animal_vision_tpu_torch.species.nonuv import NONUV_SPECS as T_SPECS
from animal_vision_tpu_torch.species.nonuv import specs_from_plain

STREAK = sorted(n for n, s in J_SPECS.items() if any(e.kind == "streak" and e.enabled for e in s.effects))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_lms_constants():
    _same(tcolor.M_RGB_TO_LMS, jcolor.M_RGB_TO_LMS)
    _same(tcolor.M_LMS_TO_RGB, jcolor.M_LMS_TO_RGB)


@pytest.mark.parametrize("name", sorted(J_SPECS))
def test_collapse_lms_matrix(name):
    s = J_SPECS[name]
    _same(tcolor.collapse_lms_matrix(s.alpha, s.s_scale), jcolor.collapse_lms_matrix(s.alpha, s.s_scale))


def test_cv2_auto_ksize():
    for sigma in np.concatenate([np.linspace(0.05, 8.0, 160), [0.4, 0.5, 1.3, 3.5]]):
        for u8 in (False, True):
            assert tblur.cv2_auto_ksize(float(sigma), u8) == jblur.cv2_auto_ksize(float(sigma), u8)


@pytest.mark.parametrize("sigma", [0.4, 0.7, 1.0, 1.2, 2.6, 3.5])
def test_gaussian_kernel_1d(sigma):
    k = jblur.cv2_auto_ksize(sigma)
    _same(tblur.gaussian_kernel_1d(k, sigma), jblur.gaussian_kernel_1d(k, sigma))
    _same(tblur.gaussian_kernel_1d(7, 0.0), jblur.gaussian_kernel_1d(7, 0.0))


def test_reflect101_index():
    p = np.arange(-40, 80)
    for n in (1, 2, 3, 7, 50):
        _same(tblur.reflect101_index(p, n), jblur.reflect101_index(p, n))


def test_channel_mix_matrix():
    for sigma in (0.4, 0.9, 1.3, 2.2):
        k = jblur.cv2_auto_ksize(sigma)
        _same(tblur._channel_mix_matrix(k, sigma), jblur._channel_mix_matrix(k, sigma))


def test_streak_sigma_map_and_row_tables():
    for h in (1, 64, 721):
        sx_t, sy_t = tblur.streak_sigma_map(h, 0.5, 0.8, 2.6, 8.0)
        sx_j, sy_j = jblur.streak_sigma_map(h, 0.5, 0.8, 2.6, 8.0)
        _same(sx_t, sx_j)
        _same(sy_t, sy_j)
        tab_t, k_t = tblur._row_kernel_table(sx_t)
        tab_j, k_j = jblur._row_kernel_table(sx_j)
        assert k_t == k_j
        _same(tab_t, tab_j)


@pytest.mark.parametrize("name", STREAK)
@pytest.mark.parametrize("h", [64, 721])
def test_streak_tables(name, h):
    s = J_SPECS[name]
    params = s.effects[0].params
    tab_t, mix_t, r_t = tfused.streak_tables(h, params, s.alpha, s.s_scale)
    tab_j, mix_j, r_j = jfused.streak_tables(h, params, s.alpha, s.s_scale)
    assert r_t == r_j
    _same(tab_t, tab_j)
    _same(mix_t, mix_j)
    assert tfused.streak_fixed_radius(params) == jfused.streak_fixed_radius(params)


@pytest.mark.parametrize("h", [1, 64, 1080])
def test_scone_gain(h):
    scone = J_SPECS["rat"].effects[0].params
    _same(tfused.scone_gain(h, scone), jfused.scone_gain(h, scone))
    _same(teffects.s_cone_gain_ramp(h, *scone), jfused.scone_gain(h, scone).reshape(-1))


@pytest.mark.parametrize("src,dst", [(48, 64), (74, 96), (65, 85), (831, 1080), (1477, 1920), (3, 1)])
def test_resize_matrix(src, dst):
    _same(tgeom.resize_matrix(src, dst), jgeom.resize_matrix(src, dst))


@pytest.mark.parametrize("w", [50, 85, 96, 1283])
def test_binocular_warp_matrices(w):
    args = (w, w, 100.0, 105.0, 40.0)
    for t, j in zip(tgeom.binocular_warp_matrices(*args), jgeom.binocular_warp_matrices(*args)):
        _same(t, j)
    assert tgeom.zoom_scale_from_fov_ratio(100.0, 105.0, 1.3) == jgeom.zoom_scale_from_fov_ratio(
        100.0, 105.0, 1.3
    )


def test_specs_from_plain_matches_jax():
    rows = {
        name: (
            np.float64(s.alpha),
            s.s_scale,
            tuple((e.kind, np.asarray(e.params), e.enabled) for e in s.effects),
        )
        for name, s in J_SPECS.items()
    }
    assert specs_from_plain(rows) == T_SPECS
    assert list(T_SPECS) == list(J_SPECS)
