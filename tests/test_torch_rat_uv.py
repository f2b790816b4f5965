"""The port's rat_uv against the JAX package and the NumPy/cv2 oracle
``oracles_uv.rat_uv_pipeline`` on the CPU, in modes auto, day and night at
two sizes (the bars of ``tests/torch_uv_checks.py``: >= 40 dB, baselines
within 1 LSB), the night frame darkened to ``img * 0.05`` as the JAX
package's ``tests/test_species_uv.py`` does; its 129-band maps against the
JAX planar branch; a batch of a day frame and a night frame equal to its
frames bit for bit; the plain program equal to the kernel program."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracles_uv
import torch_uv_checks as checks
from animal_vision_tpu.species.uv import common as jcommon
from animal_vision_tpu.species.uv.rat_uv import RatUV as JRatUV
from animal_vision_tpu_torch.species import get_animal
from animal_vision_tpu_torch.species.uv import common
from animal_vision_tpu_torch.species.uv.rat_uv import RatUV
from animal_vision_tpu_torch.spectral import classic
from torch_uv_checks import one_torch_thread  # noqa: F401  (the module-wide fixture)

SHAPES = [None, (50, 70)]


def _dark(frame):
    return (frame * 0.05).astype(np.uint8)


def _pair(mode):
    t, j = RatUV("cpu"), JRatUV()
    t.mode = j.mode = mode
    return t, j


@pytest.mark.parametrize("dark", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_auto_vs_jax_and_oracle(shape, dark, img_u8, psnr_fn):
    frame = checks.frame_of(shape, img_u8)
    frame = _dark(frame) if dark else frame
    night = bool(RatUV.is_night(torch.from_numpy(frame)).item())
    assert night == dark
    checks.vs_jax_and_oracle("rat_uv", frame, psnr_fn)


@pytest.mark.parametrize("mode", ["day", "night"])
@pytest.mark.parametrize("shape", SHAPES)
def test_forced_mode_vs_jax_and_oracle(shape, mode, img_u8, psnr_fn):
    t, j = _pair(mode)
    for frame in (checks.frame_of(shape, img_u8), _dark(checks.frame_of(shape, img_u8))):
        got = t.visualize(frame)
        checks.check(got, j.visualize(frame), psnr_fn, f"rat_uv {mode} {frame.shape} vs JAX")
        checks.check(got, oracles_uv.rat_uv_pipeline(frame, mode=mode), psnr_fn, f"rat_uv {mode} vs oracle")


def test_float_frames_vs_jax(img_f32):
    checks.float_frames_vs_jax("rat_uv", img_f32)


@pytest.mark.parametrize("shape", [(33, 58), (50, 70)])
def test_129_band_maps_vs_jax_planar(shape):
    """The two products of ``_integrate_maps`` against the JAX planar
    branch (``nb > 100``) on rat_uv's bands: within 1e-5 of max |map|."""
    lam = RatUV.lambdas
    g = classic.lobe_matrix(tuple(float(v) for v in lam))
    cols = common.band_weight_columns(lam, RatUV("cpu")._band_specs())
    assert g.shape == (3, 129)
    lin = np.random.default_rng(sum(shape)).uniform(-0.05, 1.0, (*shape, 3)).astype(np.float32)
    got = common._integrate_maps(torch.from_numpy(lin), torch.from_numpy(g), torch.from_numpy(cols)).numpy()
    want = np.asarray(jcommon._integrate_maps(jnp.asarray(lin), g, cols))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("mode", ["auto", "day", "night"])
def test_mixed_batch_equals_frames(mode, img_u8):
    """A batch of a day frame and a night frame (and a flipped day frame):
    each frame of the batch output equals the frame run alone."""
    frames = np.stack([img_u8, _dark(img_u8[::-1]), img_u8[:, ::-1]])
    assert RatUV.is_night(torch.from_numpy(frames)).flatten().tolist() == [False, True, False]
    animal = get_animal("rat_uv", device="cpu") if mode == "auto" else _pair(mode)[0]
    base_b, out_b = animal.visualize_batch(frames)
    for i in range(len(frames)):
        base_i, out_i = animal.visualize(frames[i])
        np.testing.assert_array_equal(out_b[i], out_i)
        np.testing.assert_array_equal(base_b[i], base_i)
    dev_base, dev_out = animal.visualize_batch_device(torch.from_numpy(frames))
    np.testing.assert_array_equal(dev_out.numpy(), out_b)
    np.testing.assert_array_equal(dev_base.numpy(), base_b)


def test_plain_transform_matches_kernel_path(img_u8):
    frames = np.stack([img_u8, _dark(img_u8)])
    animal = get_animal("rat_uv", device="cpu")
    x = torch.from_numpy(frames)
    for got, want in zip(animal.transform(img_u8.shape)(x), animal.plain_transform(img_u8.shape)(x)):
        assert torch.equal(got, want)
