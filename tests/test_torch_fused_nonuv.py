"""Each fused non-UV kernel's plain PyTorch version against the JAX fused
function (Pallas in interpret mode on the CPU), <= 1 uint8 LSB.

On the CPU the port's wrappers take their plain versions, so these tests
hold the arithmetic every CUDA kernel is compared with on the card. Frames:
the 64x96 ``img_u8`` fixture and a frame of 0/1 values (the per-frame
``scale = 1`` branch)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal_vision_tpu.ops import fused_nonuv as jfused
from animal_vision_tpu.species.nonuv import NONUV_SPECS, Cat
from animal_vision_tpu_torch.ops import fused_nonuv as tfused


@pytest.fixture(params=["img_u8", "binary"])
def frame(request, img_u8):
    if request.param == "img_u8":
        return img_u8
    return np.random.default_rng(7).integers(0, 2, size=(64, 96, 3), dtype=np.uint8)


def _lsb(a, b):
    return int(np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max())


def _port(fn, frame, *args, **kwargs):
    out = fn(torch.from_numpy(frame), *args, **kwargs)
    assert out.dtype == torch.uint8 and tuple(out.shape) == frame.shape
    return out.numpy()


@pytest.mark.parametrize("name", ["dog", "lion"])
def test_iso_plain_vs_jax(name, frame):
    s = NONUV_SPECS[name]
    sigma = s.effects[0].params[0]
    want = jfused.fused_iso_u8(jnp.asarray(frame), s.alpha, s.s_scale, sigma)
    got = _port(tfused.fused_iso_u8, frame, s.alpha, s.s_scale, sigma)
    assert _lsb(got, want) <= 1


def test_matrix_blur_assume01_plain_vs_jax(frame):
    srgb01 = frame.astype(np.float32) / 255.0
    merge = Cat._merge_matrix()
    want = jfused.fused_matrix_blur(jnp.asarray(srgb01), tuple(map(tuple, merge)), 1.0, assume01=True)
    got = _port(tfused.fused_matrix_blur, srgb01, merge, 1.0, assume01=True)
    assert _lsb(got, want) <= 1


@pytest.mark.parametrize("name", ["deer", "horse", "rabbit", "panda"])
def test_streak_plain_vs_jax(name, frame):
    s = NONUV_SPECS[name]
    active = [e for e in s.effects if e.enabled]
    chroma = active[1].params[0] if len(active) == 2 else None
    params = active[0].params
    want = jfused.fused_streak_u8(jnp.asarray(frame), s.alpha, s.s_scale, params, chroma=chroma)
    got = _port(tfused.fused_streak_u8, frame, s.alpha, s.s_scale, params, chroma=chroma)
    assert _lsb(got, want) <= 1


@pytest.mark.parametrize("name", ["pig", "rat"])
def test_pointwise_plain_vs_jax(name, frame):
    s = NONUV_SPECS[name]
    scone = s.effects[0].params if name == "rat" else None
    want = jfused.fused_pointwise_u8(jnp.asarray(frame), s.alpha, s.s_scale, scone=scone)
    got = _port(tfused.fused_pointwise_u8, frame, s.alpha, s.s_scale, scone=scone)
    assert _lsb(got, want) <= 1


def test_scale_of_is_per_frame(img_u8):
    binary = (img_u8 > 127).astype(np.uint8)
    scale = tfused.scale_of(torch.from_numpy(np.stack([img_u8, binary, img_u8])))
    assert scale.dtype == torch.float32
    np.testing.assert_array_equal(scale.numpy(), np.float32([1 / 255, 1.0, 1 / 255]))


def test_wrappers_batch_equals_frames(img_u8):
    """A batch through a wrapper equals its frames one at a time."""
    s = NONUV_SPECS["rabbit"]
    batch = torch.from_numpy(np.stack([img_u8, img_u8[::-1].copy()]))
    tab, mix, _ = tfused.streak_tables(64, s.effects[0].params, s.alpha, s.s_scale)
    tab, mix = torch.from_numpy(tab), torch.from_numpy(mix)
    got = tfused.streak_u8(batch, tfused.scale_of(batch), tab, mix, 0.06)
    for i in range(2):
        one = tfused.streak_u8(batch[i], tfused.scale_of(batch[i]), tab, mix, 0.06)
        assert torch.equal(got[i], one)


def test_wrappers_reject_bad_operands(img_u8):
    x = torch.from_numpy(img_u8)
    scale = tfused.scale_of(x)
    mat9 = torch.ones(9)
    with pytest.raises(TypeError):
        tfused.pointwise_u8(x.float(), scale, mat9)
    with pytest.raises(ValueError):
        tfused.pointwise_u8(x, scale, mat9, torch.ones(63))
    with pytest.raises(ValueError):
        tfused.pointwise_u8(x, scale, mat9.double())
    with pytest.raises(ValueError):
        tfused.streak_u8(x, scale, torch.ones(63, 3), torch.ones(63, 9))
    with pytest.raises(ValueError):
        tfused.iso_u8(x.to("meta"), scale.to("meta"), torch.ones(12, device="meta"))
    with pytest.raises(ValueError):
        tfused.iso_u8(x[None].expand(2, -1, -1, -1), scale, torch.ones(12))
