"""The UV slice's statistics, geometry, gradients, spectral tables and
mappers against NumPy and the JAX package, on the CPU.

- ``percentile`` equals ``np.percentile`` exactly, per frame of a batch;
- host tables (band weights, lobe and band matrices, resize taps, masks)
  equal the JAX package's bit for bit;
- device functions (resize, panorama warp, structure tensor, mappers) are
  within 1e-5 of the JAX package on [0, 1] data."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal_vision_tpu.core import color as jcolor
from animal_vision_tpu.core import effects as jeffects
from animal_vision_tpu.core import geometry as jgeom
from animal_vision_tpu.core import gradients as jgrad
from animal_vision_tpu.core import stats as jstats
from animal_vision_tpu.spectral import bands as jbands
from animal_vision_tpu.spectral import classic as jclassic
from animal_vision_tpu.spectral import mappers as jmappers
from animal_vision_tpu.species.uv import honeybee as jhoneybee
from animal_vision_tpu.species.uv.common import band_weight_columns as j_band_cols
from animal_vision_tpu_torch.core import color as tcolor
from animal_vision_tpu_torch.core import effects as teffects
from animal_vision_tpu_torch.core import geometry as tgeom
from animal_vision_tpu_torch.core import gradients as tgrad
from animal_vision_tpu_torch.core import stats as tstats
from animal_vision_tpu_torch.spectral import bands as tbands
from animal_vision_tpu_torch.spectral import classic as tclassic
from animal_vision_tpu_torch.spectral import mappers as tmappers
from animal_vision_tpu_torch.species.uv import honeybee as thoneybee
from animal_vision_tpu_torch.species.uv.common import band_weight_columns as t_band_cols

TOL = 1e-5
LAM81 = tuple(float(v) for v in np.linspace(300.0, 700.0, 81, dtype=np.float32))
LAM31 = tuple(float(v) for v in np.linspace(400.0, 700.0, 31, dtype=np.float32))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _rand(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _map(x: np.ndarray) -> torch.Tensor:
    """An (H, W) NumPy map as the port's (H, W, 1) tensor."""
    return torch.from_numpy(np.ascontiguousarray(x)[..., None])


# ---------------------------------------------------------------------------
# percentile, safe_norm, luma
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("q", [0.0, 37.3, 50.0, 95.0, 98.0, 99.0, 100.0])
@pytest.mark.parametrize("kind", ["random", "ties", "tiny"])
def test_percentile_equals_numpy_per_frame(kind, q):
    rng = np.random.default_rng(11)
    if kind == "random":
        x = rng.normal(size=(3, 41, 53, 1)).astype(np.float32)
    elif kind == "ties":  # few distinct values: both order statistics often equal
        x = rng.integers(0, 4, size=(3, 29, 31, 3)).astype(np.float32) / 3
    else:
        x = rng.random((3, 1, 2, 1), dtype=np.float32)
    got = tstats.percentile(torch.from_numpy(x), q)
    assert got.shape == (3, 1, 1, 1)
    for i in range(3):
        want = np.percentile(x[i], q)
        assert want.dtype == np.float32
        assert got[i].item() == want, (i, got[i].item(), want)


def test_percentile_single_frame_shape():
    x = _rand((17, 19, 1), seed=2)
    got = tstats.percentile(torch.from_numpy(x), 95.0)
    assert got.shape == (1, 1, 1) and got.item() == np.percentile(x, 95.0)


def test_safe_norm_per_frame_and_flat_frames():
    x = _rand((3, 20, 30, 1), seed=4) * 3 - 1
    x[1] = 0.25  # a flat frame: the range is below 1e-9, the result zeros
    got = tstats.safe_norm(torch.from_numpy(x)).numpy()
    for i in range(3):
        want = np.asarray(jstats.safe_norm(jnp.asarray(x[i, ..., 0])))
        np.testing.assert_allclose(got[i, ..., 0], want, rtol=0, atol=TOL)
    assert not got[1].any()
    assert got[0].min() == 0.0 and got[0].max() == 1.0


def test_norm_by_percentile_and_luma_vs_jax():
    x = _rand((23, 29, 3), seed=5)
    np.testing.assert_allclose(
        tstats.norm_by_percentile(torch.from_numpy(x), 98.0).numpy(),
        np.asarray(jstats.norm_by_percentile(jnp.asarray(x), 98.0)), rtol=0, atol=TOL)
    np.testing.assert_allclose(
        tstats.luminance709(torch.from_numpy(x)).numpy()[..., 0],
        np.asarray(jstats.luminance709(jnp.asarray(x))), rtol=0, atol=TOL)


def test_to_float01_per_frame():
    rng = np.random.default_rng(6)
    a = rng.random((5, 6, 3), dtype=np.float32) * 255  # max > 1.001: divided
    b = rng.random((5, 6, 3), dtype=np.float32)  # max <= 1: as it is
    batch = tcolor.to_float01(torch.from_numpy(np.stack([a, b]))).numpy()
    for i, f in enumerate((a, b)):
        np.testing.assert_array_equal(batch[i], np.asarray(jcolor.to_float01(jnp.asarray(f))))
    u8 = rng.integers(0, 256, (4, 5, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tcolor.to_float01(torch.from_numpy(u8)).numpy(),
                                  np.asarray(jcolor.to_float01(jnp.asarray(u8))))
    x = rng.random((4, 5, 3), dtype=np.float32) * 1.2 - 0.1
    np.testing.assert_array_equal(tcolor.from_float01(torch.from_numpy(x), torch.uint8).numpy(),
                                  np.asarray(jcolor.from_float01(jnp.asarray(x), np.uint8)))


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("interp, src, dst", [
    ("area", (64, 96), (16, 24)),  # the spectral speed path's 0.25
    ("area", (37, 53), (9, 13)),  # non-integer area factors
    ("linear", (16, 24), (64, 96)),
    ("linear", (9, 13), (37, 53)),
    ("cubic", (20, 31), (20, 45)),
    ("area", (9, 13), (20, 31)),  # area when upscaling: modified linear
    ("nearest", (20, 31), (11, 47)),
])
@pytest.mark.parametrize("channels", [0, 3])
def test_resize_vs_jax(interp, src, dst, channels):
    shape = src if channels == 0 else (*src, channels)
    x = _rand(shape, seed=sum(src))
    want = np.asarray(jgeom.resize(jnp.asarray(x), dst, interp))
    t = torch.from_numpy(x) if channels else _map(x)
    got = tgeom.resize(t, dst, interp).numpy()
    got = got if channels else got[..., 0]
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("scale", [1.10, 1.3, 1.45])
def test_panorama_warp_vs_jax(scale):
    x = _rand((2, 24, 57, 3), seed=9)
    got = tgeom.panorama_warp(torch.from_numpy(x), scale).numpy()
    for i in range(2):
        want = np.asarray(jgeom.panorama_warp(jnp.asarray(x[i]), scale))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=TOL)


@pytest.mark.parametrize("src, dst", [(64, 16), (37, 9), (16, 64), (9, 37), (20, 45), (1920, 480)])
def test_resize_tables_bit_equal(src, dst):
    _same(tgeom._cubic_taps(src, dst)[0], jgeom._cubic_taps(src, dst)[0])
    _same(tgeom._cubic_taps(src, dst)[1], jgeom._cubic_taps(src, dst)[1])
    _same(tgeom._area_upscale_taps(src, dst)[1], jgeom._area_upscale_taps(src, dst)[1])
    if dst <= src:
        _same(tgeom._area_matrix(src, dst), jgeom._area_matrix(src, dst))
    for interp in ("linear", "cubic", "area", "nearest"):
        _same(tgeom.dense_axis_matrix(src, dst, interp), jgeom.dense_axis_matrix(src, dst, interp))


def test_area_taps_equal_the_dense_matrix():
    m = tgeom._area_matrix(37, 9)
    idx, w = tgeom._dense_to_taps(m)
    _same(tgeom._taps_to_dense(idx, w, 37).T, m)


# ---------------------------------------------------------------------------
# gradients, effects
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sigma", [1.2, 3.0])
def test_structure_tensor_vs_jax(sigma):
    x = _rand((31, 45), seed=12)
    got = tgrad.structure_tensor(_map(x), sigma)
    want = jgrad.structure_tensor(jnp.asarray(x), sigma)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy()[..., 0], np.asarray(w), rtol=0, atol=TOL)
    np.testing.assert_allclose(tgrad.sobel_x(_map(x)).numpy()[..., 0],
                               np.asarray(jgrad.sobel_x(jnp.asarray(x))), rtol=0, atol=TOL)
    np.testing.assert_allclose(tgrad.sobel_y(_map(x)).numpy()[..., 0],
                               np.asarray(jgrad.sobel_y(jnp.asarray(x))), rtol=0, atol=TOL)


def test_uv_effects_vs_jax():
    x = _rand((27, 38, 3), seed=13) * 1.1
    t = torch.from_numpy(x)
    pairs = [
        (teffects.scatter_and_blue_bias(t, 1.2, 0.08), jeffects.scatter_and_blue_bias(jnp.asarray(x), 1.2, 0.08)),
        (teffects.snow_glare_tone_compress(t, 0.55), jeffects.snow_glare_tone_compress(jnp.asarray(x), 0.55)),
        (teffects.peripheral_blur(t, 1.8, 0.65, 6.0), jeffects.peripheral_blur(jnp.asarray(x), 1.8, 0.65, 6.0)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    _same(teffects.radial_sigmoid_mask((27, 38), 0.82, 7.0), jeffects.radial_sigmoid_mask((27, 38), 0.82, 7.0))


# ---------------------------------------------------------------------------
# spectral tables, upsampler, von Kries, mappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lo, hi", [(300.0, 410.0), (320.0, 400.0), (420.0, 680.0), (600.0, 680.0), (800.0, 900.0)])
def test_bandpass_weights_bit_equal(lo, hi):
    _same(tbands.bandpass_weights(LAM81, lo, hi), jbands.bandpass_weights(LAM81, lo, hi))


def test_spectral_tables_bit_equal():
    _same(tclassic.lobe_matrix(LAM81), jclassic.lobe_matrix(LAM81))
    _same(tclassic.lobe_matrix(LAM31, False), jclassic.lobe_matrix(LAM31, False))
    _same(tbands.d65_like(np.asarray(LAM31)), jbands.d65_like(np.asarray(LAM31)))
    specs = [(320.0, 400.0), (430.0, 500.0), (500.0, 570.0), (600.0, 680.0)]
    cols = t_band_cols(np.asarray(LAM81, np.float32), specs)
    _same(cols, j_band_cols(np.asarray(LAM81, np.float32), specs))
    lam = np.asarray(LAM81, np.float32)
    _same(tclassic.fused_band_matrix(lam, cols), jclassic.fused_band_matrix(lam, cols))
    lam31 = np.asarray(LAM31)
    for t, j in zip(thoneybee.honeybee_cone_curves(lam31), jhoneybee.honeybee_cone_curves(lam31)):
        _same(t, j)
    _same(thoneybee.HoneyBee("cpu")._catch_columns(), jhoneybee.HoneyBee()._catch_columns())
    assert tclassic.check_uniform(lam) == jclassic.check_uniform(lam)
    with pytest.raises(ValueError):
        tclassic.check_uniform(np.array([1.0, 2.0, 4.0]))


def test_classic_rgb_to_hsi_vs_jax():
    x = _rand((13, 17, 3), seed=14)
    got = tclassic.classic_rgb_to_hsi(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jclassic.classic_rgb_to_hsi(jnp.asarray(x))), rtol=0, atol=TOL)
    got = tclassic.classic_rgb_to_hsi(torch.from_numpy(x), mode="mallett").numpy()
    want = np.asarray(jclassic.classic_rgb_to_hsi(jnp.asarray(x), mode="mallett"))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_von_kries_per_frame():
    maps = [_rand((2, 11, 13, 1), seed=s) for s in (20, 21, 22)]
    for fn_t, fn_j in ((tbands.von_kries_white_patch, jbands.von_kries_white_patch),
                       (tbands.von_kries_gray_world, jbands.von_kries_gray_world)):
        got = fn_t(*(torch.from_numpy(m) for m in maps))
        for i in range(2):
            want = fn_j(*(jnp.asarray(m[i, ..., 0]) for m in maps))
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy()[i, ..., 0], np.asarray(w), rtol=0, atol=1e-6)


def _ubg(seed):
    return [_rand((19, 23), seed=seed + k) for k in range(3)]


@pytest.mark.parametrize("mode", ["falsecolor", "custom_matrix", "opponent", "uv_purple_yellow_soft",
                                  "falsecolor_uv_mixed", "hsv"])
def test_mappers_vs_jax(mode):
    u, b, g = _ubg(30)
    tu, tb, tg = _map(u), _map(b), _map(g)
    ju, jb, jg = jnp.asarray(u), jnp.asarray(b), jnp.asarray(g)
    if mode == "custom_matrix":
        m = np.array([[0.2, 0.5, 0.3], [0.1, 0.7, 0.2], [0.6, 0.1, 0.3]], np.float32)
        got, want = tmappers.map_linear_matrix(tu, tb, tg, m), jmappers.map_linear_matrix(ju, jb, jg, m)
    elif mode == "uv_purple_yellow_soft":
        got, want = tmappers.map_uv_purple_yellow_soft(tu), jmappers.map_uv_purple_yellow_soft(ju)
    elif mode == "hsv":
        hsv = np.stack([u, b, g], axis=-1)
        got, want = tmappers.hsv_to_rgb(torch.from_numpy(hsv)), jmappers.hsv_to_rgb(jnp.asarray(hsv))
    else:
        got = getattr(tmappers, f"map_{mode}")(tu, tb, tg)
        want = getattr(jmappers, f"map_{mode}")(ju, jb, jg)
    assert got.shape == (19, 23, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
