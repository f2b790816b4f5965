"""The port's library functions that no species calls, against the JAX
package on the CPU: band integrals, ``map_uv_purple_yellow``, the general
Gaussian blur, ``tapetum_bloom``, ``rod_vision``, ``unsharp_mask``,
``dog_bandpass``, ``remap_bilinear``, ``center_zoom``, the binocular warp
and the LMS helpers; the cv2 oracles of ``tests/test_effects_mappers.py``
and ``tests/test_core_geometry.py`` beside them.

The port's maps carry a trailing channel axis: a JAX (H, W) map is an
(H, W, 1) tensor here. Each function runs on a single frame and on a batch
(each frame of it against the JAX function of that frame). Bar: 1e-5 max
abs (3e-5 against cv2's remap, as the JAX package's own test)."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal_vision_tpu.core import blur as jblur
from animal_vision_tpu.core import color as jcolor
from animal_vision_tpu.core import effects as jeffects
from animal_vision_tpu.core import geometry as jgeometry
from animal_vision_tpu.spectral import bands as jbands
from animal_vision_tpu.spectral import mappers as jmappers
from animal_vision_tpu_torch.core import blur, color, effects, geometry
from animal_vision_tpu_torch.ops import _build
from animal_vision_tpu_torch.spectral import bands, mappers

TOL = 1e-5
SHAPES = [(64, 96), (50, 70)]
BATCH = 3


def _rand(shape, seed):
    return np.random.default_rng(seed).uniform(0.0, 1.0, size=shape).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol)


def _per_frame(fn_t, fn_j, x, tol=TOL, map_in=False, map_out=False):
    """``fn_t`` on the (N, ...) batch ``x`` against ``fn_j`` on each frame;
    ``map_in`` / ``map_out``: the JAX side takes / gives (H, W) maps."""
    got = fn_t(torch.from_numpy(x)).numpy()
    for i in range(x.shape[0]):
        want = np.asarray(fn_j(jnp.asarray(x[i, ..., 0] if map_in else x[i])))
        _close(got[i, ..., 0] if map_out else got[i], want, tol)


@pytest.mark.parametrize("hw", SHAPES)
def test_integrate_band_and_uv(hw):
    lam = np.linspace(300.0, 700.0, 81, dtype=np.float32)
    hsi = _rand((BATCH, *hw, 81), seed=1)
    for lo, hi in ((320.0, 400.0), (500.0, 570.0), (900.0, 950.0)):
        for fn_t, fn_j in ((bands.integrate_band, jbands.integrate_band), (bands.integrate_uv, jbands.integrate_uv)):
            _per_frame(lambda x: fn_t(x, lam, lo, hi), lambda x: fn_j(x, lam, lo, hi), hsi, map_out=True)
            _close(fn_t(torch.from_numpy(hsi[0]), lam, lo, hi)[..., 0], fn_j(jnp.asarray(hsi[0]), lam, lo, hi))


@pytest.mark.parametrize("hw", SHAPES)
def test_map_uv_purple_yellow(hw, img_f32):
    u = _rand((BATCH, *hw, 1), seed=2) ** 2
    _per_frame(mappers.map_uv_purple_yellow, jmappers.map_uv_purple_yellow, u, map_in=True)
    # the cv2-free oracle of tests/test_effects_mappers.py
    v = img_f32[..., 0] * img_f32[..., 1]
    un = np.clip(v / max(float(np.percentile(v, 99.0)), 1e-8), 0, 1) ** 0.85
    s2l = lambda c: np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4).astype(np.float32)  # noqa: E731
    c0, c1 = s2l(np.array([128, 0, 150], np.float32) / 255), s2l(np.array([255, 225, 60], np.float32) / 255)
    want = np.clip((1 - un[..., None]) * c0 + un[..., None] * c1, 0, 1)
    _close(mappers.map_uv_purple_yellow(torch.from_numpy(v[..., None])), want)


@pytest.mark.parametrize("hw", SHAPES)
def test_gaussian_blur_general(hw):
    x = _rand((BATCH, *hw, 3), seed=3)
    for sx, sy, ksize in ((1.3, None, None), (0.8, 2.1, None), (1.0, 0.0, (5, 9)), (2.0, 1.5, (0, 7))):
        _per_frame(lambda t: blur.gaussian_blur(t, sx, sy, ksize), lambda j: jblur.gaussian_blur(j, sx, sy, ksize), x)
        want = cv2.GaussianBlur(x[0], ksize or (0, 0), sigmaX=sx, sigmaY=sy or 0.0, borderType=cv2.BORDER_REFLECT_101)
        _close(blur.gaussian_blur(torch.from_numpy(x[0]), sx, sy, ksize), want)
    maps = x[..., 0]
    for sigma in (0.7, 2.5):
        _per_frame(lambda t: blur.gaussian_blur_hw(t, sigma), lambda j: jblur.gaussian_blur_hw(j, sigma), maps)
        _close(blur.gaussian_blur(torch.from_numpy(maps), sigma, axes=(-1, -2)), blur.gaussian_blur_hw(
            torch.from_numpy(maps), sigma))
        _close(blur.gaussian_blur_hw(torch.from_numpy(maps[0]), sigma), cv2.GaussianBlur(maps[0], (0, 0), sigma))


@pytest.mark.parametrize("hw", SHAPES)
def test_tapetum_bloom_and_rod_vision(hw, img_f32):
    x = _rand((BATCH, *hw, 3), seed=4) * 1.2 - 0.1
    _per_frame(effects.tapetum_bloom, jeffects.tapetum_bloom, x)
    _per_frame(lambda t: effects.tapetum_bloom(t, 0.3, 1.7), lambda j: jeffects.tapetum_bloom(j, 0.3, 1.7), x)
    _per_frame(effects.rod_vision, jeffects.rod_vision, x)
    _per_frame(lambda t: effects.rod_vision(t, 0.2, 1.1, 1.3), lambda j: jeffects.rod_vision(j, 0.2, 1.1, 1.3), x)
    # the cv2 oracles of tests/test_effects_mappers.py
    c = np.clip(img_f32, 0, 1)
    mask = np.clip((0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2] - 0.4) / 0.6, 0, 1)
    mask = cv2.GaussianBlur(mask, (0, 0), sigmaX=3.0, sigmaY=3.0)[..., None]
    screen = 1.0 - (1.0 - c) * (1.0 - cv2.GaussianBlur(c, (0, 0), sigmaX=3.0, sigmaY=3.0))
    _close(effects.tapetum_bloom(torch.from_numpy(img_f32), 0.12, 3.0), np.clip(c + 0.12 * mask * (screen - c), 0, 1))
    lum = cv2.GaussianBlur(0.1 * c[..., 0] + 0.8 * c[..., 1] + 0.1 * c[..., 2], (0, 0), sigmaX=1.2, sigmaY=1.2)
    want = np.clip((lum[..., None] * (1 - 0.08) + c * 0.08) * 1.4, 0, 1) ** 0.8
    _close(effects.rod_vision(torch.from_numpy(img_f32)), want)


@pytest.mark.parametrize("hw", SHAPES)
def test_unsharp_mask_and_dog_bandpass(hw):
    x = _rand((BATCH, *hw, 3), seed=5)
    before = _build.LAUNCHES["blur_uv"]
    for sigma, amount in ((1.0, 0.3), (2.2, 1.5)):
        _per_frame(lambda t: effects.unsharp_mask(t, sigma, amount),
                   lambda j: jeffects.unsharp_mask(j, sigma, amount), x)
        _per_frame(lambda t: effects.unsharp_mask(t, sigma, amount),
                   lambda j: jeffects.unsharp_mask(j, sigma, amount), x[..., :1], map_in=True, map_out=True)
    amount = _rand((*hw, 1), seed=6)
    _per_frame(lambda t: effects.unsharp_mask(t, 1.0, torch.from_numpy(amount)),
               lambda j: jeffects.unsharp_mask(j, 1.0, jnp.asarray(amount)), x)
    for lo, hi in ((0.8, 2.5), (1.5, 4.0)):
        _per_frame(lambda t: effects.dog_bandpass(t, lo, hi), lambda j: jeffects.dog_bandpass(j, lo, hi),
                   x[..., :1], map_in=True, map_out=True)
        frame = torch.from_numpy(x[0, ..., :1])
        assert torch.equal(effects.dog_bandpass(frame, lo, hi), effects.dog_bandpass(frame, lo, hi, plain=True))
    assert _build.LAUNCHES["blur_uv"] == before  # on the CPU the wrappers take their plain versions


@pytest.mark.parametrize("hw", SHAPES)
def test_remap_bilinear(hw):
    h, w = hw
    x = _rand((BATCH, h, w, 3), seed=7)
    rng = np.random.default_rng(8)
    map_x = rng.uniform(-5, w + 5, size=(h + 3, w - 4)).astype(np.float32)
    map_y = rng.uniform(-5, h + 5, size=(h + 3, w - 4)).astype(np.float32)
    for border in (0.0, 0.25):
        _per_frame(lambda t: geometry.remap_bilinear(t, map_x, map_y, border),
                   lambda j: jgeometry.remap_bilinear(j, map_x, map_y, border), x)
        _per_frame(lambda t: geometry.remap_bilinear(t, map_x, map_y, border),
                   lambda j: jgeometry.remap_bilinear(j, map_x, map_y, border), x[..., :1], map_in=True, map_out=True)
    want = cv2.remap(x[0], map_x, map_y, interpolation=cv2.INTER_LINEAR, borderMode=cv2.BORDER_CONSTANT,
                     borderValue=0)
    _close(geometry.remap_bilinear(torch.from_numpy(x[0]), map_x, map_y), want, tol=3e-5)


@pytest.mark.parametrize("hw", SHAPES)
def test_center_zoom(hw):
    x = _rand((BATCH, *hw, 3), seed=9)
    for scale in (1.37, 2.0, 0.9):
        _per_frame(lambda t: geometry.center_zoom(t, scale), lambda j: jgeometry.center_zoom(j, scale), x)
    frames = torch.from_numpy(x)
    assert geometry.center_zoom(frames, 0.9) is frames
    h, w = hw
    cw, ch = max(1, round(w / 1.37)), max(1, round(h / 1.37))
    crop = x[0, (h - ch) // 2 : (h - ch) // 2 + ch, (w - cw) // 2 : (w - cw) // 2 + cw]
    _close(geometry.center_zoom(torch.from_numpy(x[0]), 1.37), cv2.resize(crop, (w, h), interpolation=cv2.INTER_LINEAR),
           tol=2e-5)


@pytest.mark.parametrize("hw", SHAPES)
def test_binocular_warp(hw):
    h, w = hw
    x = _rand((BATCH, h, w, 3), seed=10)
    for args in ((100.0, 105.0, 40.0), (90.0, 60.0, 20.0)):
        got = geometry.binocular_warp_matrix(w, w, *args)
        np.testing.assert_array_equal(got, jgeometry.binocular_warp_matrix(w, w, *args))
        _per_frame(lambda t: geometry.binocular_fov_warp(t, *args), lambda j: jgeometry.binocular_fov_warp(j, *args), x)
        out_hw = (h - 7, w + 5)
        _per_frame(lambda t: geometry.binocular_fov_warp(t, *args, out_hw=out_hw),
                   lambda j: jgeometry.binocular_fov_warp(j, *args, out_hw=out_hw), x)
        # the dense column matrix gives the same warp (its rows map is the identity)
        dense = torch.clamp(torch.einsum("hwc,wo->hoc", torch.from_numpy(x[0]), torch.from_numpy(got)), 0, 1)
        _close(dense, geometry.binocular_fov_warp(torch.from_numpy(x[0]), *args))


def test_lms_helpers():
    x = _rand((BATCH, 13, 17, 3), seed=11)
    for alpha in (0.0, 0.3, 1.0):
        _per_frame(lambda t: color.merge_l_m(t, alpha), lambda j: jcolor.merge_l_m(j, alpha), x)
    _per_frame(color.srgb_to_lms, jcolor.srgb_to_lms, x)
    _per_frame(color.lms_to_rgb, jcolor.lms_to_rgb, x)
    back = color.lms_to_rgb(color.srgb_to_lms(torch.from_numpy(x)))
    _close(back, x, tol=1e-4)
