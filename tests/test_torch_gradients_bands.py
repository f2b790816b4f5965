"""Three library functions of the port against the JAX package on the CPU:
``core/gradients.py`` ``orientation`` and ``coherence_energy``, and
``species/uv/common.py`` ``compute_band_maps`` (also against the
cube-then-integrate oracle, as ``tests/test_species_uv.py`` holds the JAX
one). Maps carry a trailing channel axis in the port; a batch equals its
frames.

Bars: Sobel gradients within 1e-5 of their max; the angle modulo pi (atan2
is defined up to the gradient's sign convention only there) within 1e-5
where the gradient's magnitude exceeds 1e-3; coherence (in [0, 1]) within
1e-5 and energy within 1e-5 of its max; band maps within 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles_uv
from animal_vision_tpu.core import gradients as jgradients
from animal_vision_tpu.species.uv import common as jcommon
from animal_vision_tpu_torch.core import gradients
from animal_vision_tpu_torch.species.uv import common

SHAPES = [(64, 96), (50, 70), (9, 13)]
BATCH = 2
TOL = 1e-5


def _maps(hw, seed):
    return np.random.default_rng(seed).random((BATCH, *hw, 1), dtype=np.float32)


@pytest.mark.parametrize("hw", SHAPES)
def test_orientation_vs_jax(hw):
    x = _maps(hw, seed=1)
    gx, gy, theta = (t.numpy()[..., 0] for t in gradients.orientation(torch.from_numpy(x)))
    for i in range(BATCH):
        jgx, jgy, jtheta = (np.asarray(a) for a in jgradients.orientation(jnp.asarray(x[i, ..., 0])))
        scale = max(np.abs(jgx).max(), np.abs(jgy).max())
        assert np.abs(gx[i] - jgx).max() <= TOL * scale
        assert np.abs(gy[i] - jgy).max() <= TOL * scale
        strong = np.hypot(jgx, jgy) > 1e-3
        assert strong.mean() > 0.9
        mod_pi = np.abs(np.angle(np.exp(2j * (theta[i].astype(np.float64) - jtheta)))) / 2
        assert mod_pi[strong].max() <= TOL


@pytest.mark.parametrize("sigma", [1.0, 2.5])
@pytest.mark.parametrize("hw", SHAPES)
def test_coherence_energy_vs_jax(hw, sigma):
    x = _maps(hw, seed=2)
    coherence, energy = (t.numpy()[..., 0] for t in gradients.coherence_energy(torch.from_numpy(x), sigma))
    for i in range(BATCH):
        jc, je = (np.asarray(a) for a in jgradients.coherence_energy(jnp.asarray(x[i, ..., 0]), sigma))
        assert np.abs(coherence[i] - jc).max() <= TOL
        assert np.abs(energy[i] - je).max() <= TOL * np.abs(je).max()


@pytest.mark.parametrize("hsi_scale", [0.0, 0.25, 0.55])
@pytest.mark.parametrize("hw", SHAPES)
def test_compute_band_maps_vs_jax(hw, hsi_scale):
    lam = np.linspace(300.0, 700.0, 81, dtype=np.float32)
    cols = jcommon.band_weight_columns(lam, [(320.0, 400.0), (500.0, 570.0), (600.0, 680.0)])
    frames = np.random.default_rng(3).random((BATCH, *hw, 3), dtype=np.float32)
    got = common.compute_band_maps(torch.from_numpy(frames), lam, cols, hsi_scale).numpy()
    assert got.shape == (BATCH, *hw, 3)
    for i in range(BATCH):
        want = np.asarray(jcommon.compute_band_maps(jnp.asarray(frames[i]), lam, cols, hsi_scale))
        np.testing.assert_allclose(got[i], want, rtol=0, atol=TOL)


def test_compute_band_maps_equals_cube_then_integrate(img_f32):
    lam = np.linspace(300.0, 700.0, 81, dtype=np.float32)
    specs = [(320.0, 400.0), (500.0, 570.0)]
    maps = common.compute_band_maps(torch.from_numpy(img_f32), lam, common.band_weight_columns(lam, specs), 0.0)
    hsi = oracles_uv.classic_rgb_to_hsi(img_f32, lam)
    for i, (lo, hi) in enumerate(specs):
        np.testing.assert_allclose(maps[..., i].numpy(), oracles_uv.integrate_band(hsi, lam, lo, hi), atol=TOL)
