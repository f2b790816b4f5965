"""The port's non-UV slice as a whole against the JAX package.

``get_animal(name, device="cpu").visualize`` against the JAX
``get_animal(name).visualize`` (CPU backend, Pallas in interpret mode):
uint8 frames within 1 LSB for all 19 spec species and both cat outputs,
float frames within 1e-4."""

import jax  # noqa: F401  (JAX on the CPU backend, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

from animal_vision_tpu.species import NON_UV_NAMES as J_NAMES
from animal_vision_tpu.species import get_animal as jax_animal
from animal_vision_tpu.species.nonuv import NONUV_SPECS
from animal_vision_tpu_torch.species import NON_UV_NAMES, display_name, get_animal


def _lsb(a, b):
    return int(np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max())


@pytest.mark.parametrize("name", sorted(NONUV_SPECS))
def test_species_uint8_vs_jax(name, img_u8):
    base_j, out_j = jax_animal(name).visualize(img_u8)
    base_t, out_t = get_animal(name, device="cpu").visualize(img_u8)
    assert out_t.dtype == np.uint8 and out_t.shape == img_u8.shape
    np.testing.assert_array_equal(base_t, base_j)
    assert _lsb(out_t, out_j) <= 1, name


def test_cat_uint8_vs_jax(img_u8):
    human_j, cat_j = jax_animal("cat").visualize(img_u8)
    human_t, cat_t = get_animal("cat", device="cpu").visualize(img_u8)
    assert human_t.dtype == np.uint8 and cat_t.dtype == np.uint8
    assert _lsb(human_t, human_j) <= 1
    assert _lsb(cat_t, cat_j) <= 1


@pytest.mark.parametrize("name", ["dog", "horse", "rat", "pig"])
def test_species_float_vs_jax(name, img_f32):
    _, out_j = jax_animal(name).visualize(img_f32)
    _, out_t = get_animal(name, device="cpu").visualize(img_f32)
    assert out_t.dtype == np.float32
    np.testing.assert_allclose(out_t, out_j, atol=1e-4)


def test_cat_float_vs_jax(img_f32):
    human_j, cat_j = jax_animal("cat").visualize(img_f32)
    human_t, cat_t = get_animal("cat", device="cpu").visualize(img_f32)
    np.testing.assert_allclose(human_t, human_j, atol=1e-4)
    np.testing.assert_allclose(cat_t, cat_j, atol=1e-4)


@pytest.mark.parametrize("name", ["dog", "deer", "rabbit", "rat", "cat"])
def test_visualize_batch_equals_frames(name, img_u8):
    animal = get_animal(name, device="cpu")
    binary = (img_u8 > 127).astype(np.uint8)  # scale = 1 beside scale = 1/255
    batch = np.stack([img_u8, binary, img_u8[::-1].copy()])
    base_b, out_b = animal.visualize_batch(batch)
    for i in range(3):
        base_i, out_i = animal.visualize(batch[i])
        np.testing.assert_array_equal(out_b[i], out_i)
        np.testing.assert_array_equal(base_b[i], base_i)
    dev_base, dev_out = animal.visualize_batch_device(torch.from_numpy(batch))
    assert isinstance(dev_out, torch.Tensor) and dev_out.device.type == "cpu"
    np.testing.assert_array_equal(dev_out.numpy(), out_b)


def test_plain_transform_matches_kernel_path(img_u8):
    """The composed chain and the fused path agree (the on-card check of
    chip_smoke.py, here with the plain versions)."""
    frame = torch.from_numpy(img_u8)
    for name in NON_UV_NAMES:
        animal = get_animal(name, device="cpu")
        _, fused = animal.transform(img_u8.shape)(frame)
        _, plain = animal.plain_transform(img_u8.shape)(frame)
        assert _lsb(fused, plain) <= 1, name


def test_registry():
    assert NON_UV_NAMES == J_NAMES
    assert len(NON_UV_NAMES) == 20
    for n in NON_UV_NAMES:
        a = get_animal(n, device="cpu")
        assert a is get_animal(n.upper(), device="cpu")
        assert a.device == torch.device("cpu")
    assert get_animal("dog", "cpu") is not get_animal("dog", "meta")
    assert display_name("dog") == "Dog"
    with pytest.raises(KeyError):
        get_animal("unicorn", device="cpu")


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_animal("dog")


def test_baseline_is_a_copy_of_the_input(img_u8):
    base, _ = get_animal("dog", device="cpu").visualize(img_u8)
    np.testing.assert_array_equal(base, img_u8)
    assert not np.shares_memory(base, img_u8)
    batch = img_u8[None].copy()
    base_b, _ = get_animal("dog", device="cpu").visualize_batch(batch)
    assert not np.shares_memory(base_b, batch)


def test_visualize_rejects_bad_input(img_u8):
    animal = get_animal("dog", device="cpu")
    with pytest.raises(TypeError):
        animal.visualize(torch.from_numpy(img_u8))
    with pytest.raises(ValueError):
        animal.visualize(img_u8[..., :2])
    with pytest.raises(ValueError):
        animal.visualize_batch(img_u8)
