"""The port's UV classic slice as a whole against the JAX package and the
NumPy/cv2 oracles (``tests/oracles_uv.py``), on the CPU.

``get_animal(name, device="cpu").visualize`` against the JAX
``get_animal(name).visualize``: >= 40 dB PSNR on the uint8 output (the
repo's UV contract), baseline within 1 LSB; float frames within 1e-4. A
batch equals its frames bit for bit."""

import jax  # noqa: F401  (JAX on the CPU backend, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

import oracles_uv
from animal_vision_tpu.species import UNIQUE_UV_NAMES as J_UNIQUE
from animal_vision_tpu.species import UV_NAMES as J_UV
from animal_vision_tpu.species import display_name as j_display
from animal_vision_tpu.species import get_animal as jax_animal
from animal_vision_tpu.species.uv.honeybee import HoneyBee as JHoneyBee
from animal_vision_tpu_torch.species import (
    NON_UV_NAMES,
    PORTED_UV_NAMES,
    UNIQUE_UV_NAMES,
    UV_NAMES,
    animal_names,
    display_name,
    get_animal,
)
from animal_vision_tpu_torch.species.uv.honeybee import HoneyBee

MIN_DB = 40.0
#: the four species of the UV classic slice; the others have their own files
#: (``tests/test_torch_uv_species_{fish,butterflies,unique}.py``)
NAMES = ["honeybee", "reindeer", "goldfish", "kestrel"]
CUSTOM = np.array([[0.2, 0.5, 0.3], [0.1, 0.7, 0.2], [0.6, 0.1, 0.3]], np.float32)


def _lsb(a, b):
    return int(np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max())


def _check(got, want, psnr_fn, what):
    base_t, out_t = got
    base_w, out_w = want
    assert out_t.dtype == np.uint8 and out_t.shape == np.asarray(out_w).shape
    db = psnr_fn(out_t / 255.0, np.asarray(out_w) / 255.0)
    assert db >= MIN_DB, f"{what}: {db:.2f} dB"
    assert _lsb(base_t, base_w) <= 1, what


@pytest.mark.parametrize("name", NAMES)
def test_species_vs_jax_and_oracle(name, img_u8, psnr_fn):
    got = get_animal(name, device="cpu").visualize(img_u8)
    _check(got, jax_animal(name).visualize(img_u8), psnr_fn, f"{name} vs JAX")
    _check(got, getattr(oracles_uv, f"{name}_pipeline")(img_u8), psnr_fn, f"{name} vs oracle")


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", [(50, 70), (9, 13)])
def test_odd_shapes_vs_jax(name, shape, psnr_fn):
    frame = np.random.default_rng(sum(shape)).integers(0, 256, size=(*shape, 3), dtype=np.uint8)
    _check(get_animal(name, device="cpu").visualize(frame), jax_animal(name).visualize(frame), psnr_fn,
           f"{name} {shape}")


@pytest.mark.parametrize("mode", ["falsecolor", "custom_matrix", "uv_purple_yellow", "falsecolor_uv_mixed"])
def test_honeybee_modes(mode, img_u8, psnr_fn):
    kw = {"mapping_mode": mode, "custom_matrix": CUSTOM if mode == "custom_matrix" else None}
    got = HoneyBee("cpu", **kw).visualize(img_u8)
    _check(got, JHoneyBee(**kw).visualize(img_u8), psnr_fn, f"honeybee[{mode}] vs JAX")
    if mode != "custom_matrix":  # the oracle has no custom matrix
        _check(got, oracles_uv.honeybee_pipeline(img_u8, mapping_mode=mode), psnr_fn, f"honeybee[{mode}]")


@pytest.mark.parametrize("kw", [{"adaptation": "gray_world"}, {"adaptation": None},
                                {"hsi_downsample": True, "hsi_scale": 0.25}])
def test_honeybee_options(kw, img_u8, psnr_fn):
    _check(HoneyBee("cpu", **kw).visualize(img_u8), JHoneyBee(**kw).visualize(img_u8), psnr_fn, str(kw))


@pytest.mark.parametrize("name", NAMES)
def test_float_frames_vs_jax(name, img_f32):
    base_t, out_t = get_animal(name, device="cpu").visualize(img_f32)
    base_j, out_j = jax_animal(name).visualize(img_f32)
    assert out_t.dtype == np.float32 and base_t.dtype == np.float32
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(base_t, base_j, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("name", NAMES)
def test_visualize_batch_equals_frames(name, dtype, img_u8):
    """Three frames; as float32, the second has max <= 1, so to_float01
    divides the other two by 255 and leaves it as it is."""
    if dtype == "uint8":
        frames = [img_u8, (img_u8 > 127).astype(np.uint8), img_u8[::-1]]
    else:
        frames = [img_u8.astype(np.float32), img_u8[::-1] / np.float32(255), (img_u8 > 127) * np.float32(200)]
    batch = np.stack(frames)
    animal = get_animal(name, device="cpu")
    base_b, out_b = animal.visualize_batch(batch)
    for i in range(3):
        base_i, out_i = animal.visualize(batch[i])
        np.testing.assert_array_equal(out_b[i], out_i)
        np.testing.assert_array_equal(base_b[i], base_i)
    dev_base, dev_out = animal.visualize_batch_device(torch.from_numpy(batch))
    assert isinstance(dev_out, torch.Tensor) and dev_out.device.type == "cpu"
    np.testing.assert_array_equal(dev_out.numpy(), out_b)
    np.testing.assert_array_equal(np.asarray(dev_base), base_b)


@pytest.mark.parametrize("name", NAMES)
def test_plain_transform_matches_kernel_path(name, img_u8):
    """On the CPU both take the plain blur: the same chain, the same bits
    (chip_smoke.py holds the two apart on the card)."""
    animal = get_animal(name, device="cpu")
    frame = torch.from_numpy(img_u8)
    for got, want in zip(animal.transform(img_u8.shape)(frame), animal.plain_transform(img_u8.shape)(frame)):
        assert torch.equal(got, want)


def test_registry_lists_only_ported_uv_species():
    assert PORTED_UV_NAMES == UV_NAMES + UNIQUE_UV_NAMES
    assert UV_NAMES == [n for n in J_UV if n in PORTED_UV_NAMES]
    assert UNIQUE_UV_NAMES == [n for n in J_UNIQUE if n in PORTED_UV_NAMES]
    assert UV_NAMES == [n for n in J_UV if n != "rat_uv"] and UNIQUE_UV_NAMES == J_UNIQUE
    assert animal_names() == sorted(NON_UV_NAMES + PORTED_UV_NAMES)
    for n in PORTED_UV_NAMES:
        assert display_name(n) == j_display(n)
        assert get_animal(n, device="cpu").device == torch.device("cpu")


def test_uv_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_animal("kestrel")


def test_use_hsi_provider_swaps_the_provider():
    """A UV animal starts on the analytic upsampler; ``use_hsi_provider``
    swaps in a provider and its band grid and clears the built programs
    (``tests/test_torch_mst_*.py`` hold MST++ and MST-L as that provider
    against the JAX package)."""
    animal = get_animal("goldfish", device="cpu").__class__("cpu")
    assert animal.hsi_provider is None
    animal.transform((8, 8, 3))
    assert animal._programs
    lambdas = np.linspace(400.0, 700.0, 31, dtype=np.float32)

    def provider(frames, plain=False):
        return frames[..., :1].expand(*frames.shape[:-1], 31)

    assert animal.use_hsi_provider(provider, lambdas=lambdas) is animal
    assert animal.hsi_provider is provider and not animal._programs
    np.testing.assert_array_equal(animal.lambdas, lambdas)
    assert HoneyBee("cpu", hsi_provider=provider).hsi_provider is provider
