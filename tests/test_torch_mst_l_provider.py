"""MST-L as the UV species' HSI provider (``models/providers.py``
``attach_model(animal, "mst")``) against the JAX package, on the CPU.

The port's ``attach_model`` draws MST-L's weights from
``torch.Generator().manual_seed(0)``; the JAX side runs the same weights,
read from the port's state dict by the JAX ``convert_torch_state`` (the
seeded up-conv biases are 0, so the reference's one bias per channel holds
them), through ``make_mst_hsi_provider`` and ``use_hsi_provider``: what
the JAX ``attach_model(animal, "mst")`` does with its own weights. Kestrel
and mantis shrimp (BASELINE.json config #4's species) run the model on the
0.25-scale frame (16x24 for the 64x96 ``img_u8``). Bar: >= 40 dB PSNR on
the uint8 output (the repo's UV contract), baseline within 1 LSB."""

import jax  # noqa: F401  (JAX on the CPU backend, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

from animal_vision_tpu.models import providers as jproviders
from animal_vision_tpu.models.mst import MSTModel as JMSTModel
from animal_vision_tpu.models.mst import convert_torch_state
from animal_vision_tpu.species.uv.kestrel import Kestrel as JKestrel
from animal_vision_tpu.species.uv.mantis_shrimp import MantisShrimp as JMantisShrimp
from animal_vision_tpu_torch.core import color
from animal_vision_tpu_torch.models import zoo
from animal_vision_tpu_torch.models.mst import MSTModel
from animal_vision_tpu_torch.models.providers import MST_LAMBDAS, attach_model, make_mst_hsi_provider
from animal_vision_tpu_torch.ops import _build
from animal_vision_tpu_torch.species.uv.kestrel import Kestrel
from animal_vision_tpu_torch.species.uv.mantis_shrimp import MantisShrimp

MIN_DB = 40.0
SPECIES = {"kestrel": (Kestrel, JKestrel), "mantis_shrimp": (MantisShrimp, JMantisShrimp)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_provider():
    sd = zoo.model_generator("mst", device="cpu", seed=0).state_dict()
    for k, v in sd.items():
        if k.startswith("decoder_layers.") and k.endswith(".0.bias"):
            assert torch.equal(v, torch.zeros_like(v))
            sd[k] = v[:, 0, 0]
    variables = convert_torch_state({k: v.numpy() for k, v in sd.items()})
    return jproviders.make_mst_hsi_provider(JMSTModel(dim=31, stage=2, num_blocks=(4, 7, 5)), variables)


@pytest.mark.parametrize("name", sorted(SPECIES))
def test_attach_model_mst_vs_jax(name, img_u8, psnr_fn, jax_provider):
    cls, jcls = SPECIES[name]
    animal = attach_model(cls("cpu"), "mst")
    assert np.array_equal(animal.lambdas, MST_LAMBDAS)
    base_t, out_t = animal.visualize(img_u8)
    base_w, out_w = jcls().use_hsi_provider(jax_provider, lambdas=jproviders.MST_LAMBDAS).visualize(img_u8)
    assert out_t.dtype == np.uint8 and out_t.shape == np.asarray(out_w).shape
    db = psnr_fn(out_t / 255.0, np.asarray(out_w) / 255.0)
    assert db >= MIN_DB, f"{name}: {db:.2f} dB"
    assert np.abs(base_t.astype(int) - np.asarray(base_w).astype(int)).max() <= 1
    # the provider's cube is not the analytic one
    assert not np.array_equal(out_t, cls("cpu").visualize(img_u8)[1])


def test_batch_equals_frames(img_u8):
    """MST-L takes one frame per forward, so a batch equals its frames bit
    for bit although the model's own batch takes frame 0's mask."""
    animal = attach_model(MantisShrimp("cpu"), "mst")
    batch = np.stack([img_u8, img_u8[::-1], (img_u8 > 127).astype(np.uint8) * 200])
    base_b, out_b = animal.visualize_batch(batch)
    for i in range(3):
        base_i, out_i = animal.visualize(batch[i])
        np.testing.assert_array_equal(out_b[i], out_i)
        np.testing.assert_array_equal(base_b[i], base_i)


def test_provider_runs_one_frame_per_forward():
    model = zoo.model_generator("mst", device="cpu")
    provider = make_mst_hsi_provider(model)
    frames = torch.from_numpy(np.random.default_rng(2).random((2, 1, 8, 16, 3), dtype=np.float32))
    cube = provider(frames)
    assert cube.shape == (2, 1, 8, 16, 31) and cube.min().item() >= 0.0
    with torch.no_grad():
        for i in range(2):
            assert torch.equal(cube[i], model(frames[i]).clamp(min=0.0))
        assert not torch.equal(cube[1, 0], model(frames[:, 0])[1].clamp(min=0.0))


def test_plain_transform_matches_kernel_path(img_u8):
    """On the CPU both programs take the FFN's plain version: the same bits,
    and no launch is counted."""
    animal = attach_model(Kestrel("cpu"), "mst")
    frame = torch.from_numpy(img_u8)
    _build.reset_launches()
    for got, want in zip(animal.transform(img_u8.shape)(frame), animal.plain_transform(img_u8.shape)(frame)):
        assert torch.equal(got, want)
    assert _build.LAUNCHES["ffn"] == 0


def test_attach_model_takes_either_method(tmp_path):
    """``attach_model`` builds the zoo's method on the animal's device;
    with a checkpoint it loads it and re-encodes the linear frame to sRGB."""
    src = zoo.model_generator("mst", device="cpu", seed=5)
    path = tmp_path / "mst.pth"
    torch.save(src.state_dict(), path)
    frames = torch.from_numpy(np.random.default_rng(4).random((1, 8, 8, 3), dtype=np.float32))
    for method in ("mst", "mst_plus_plus"):
        animal = attach_model(Kestrel("cpu"), method)
        assert np.array_equal(animal.lambdas, MST_LAMBDAS) and animal.hsi_provider(frames).shape == (1, 8, 8, 31)
    with torch.no_grad():
        got = attach_model(Kestrel("cpu"), "mst", pretrained_path=path).hsi_provider(frames)
        assert torch.equal(got, src(color.linear_to_srgb(frames)).clamp(min=0.0))
    assert isinstance(src, MSTModel)
