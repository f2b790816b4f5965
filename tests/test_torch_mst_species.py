"""MST++ as the UV species' HSI provider (``models/providers.py``) against
the JAX package's ``attach_mst`` / ``hsi_provider``, on the CPU.

Both sides run the shipped ``synth_v1`` weights on the ``img_u8`` fixture
(64x96): kestrel and goldfish run the model on the 0.25-scale frame
(16x24), honeybee on the full frame. Bar: >= 40 dB PSNR on the uint8
output (the repo's UV contract), baseline within 1 LSB."""

import jax  # noqa: F401  (JAX on the CPU backend, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

from animal_vision_tpu.models import providers as jproviders
from animal_vision_tpu.models import quality
from animal_vision_tpu.species.uv.goldfish import Goldfish as JGoldfish
from animal_vision_tpu.species.uv.honeybee import HoneyBee as JHoneyBee
from animal_vision_tpu.species.uv.kestrel import Kestrel as JKestrel
from animal_vision_tpu_torch.core import color
from animal_vision_tpu_torch.models.mst_plus_plus import SHIPPED, load_shipped
from animal_vision_tpu_torch.models.providers import MST_LAMBDAS, attach_mst, make_mst_hsi_provider
from animal_vision_tpu_torch.species.uv.goldfish import Goldfish
from animal_vision_tpu_torch.species.uv.honeybee import HoneyBee
from animal_vision_tpu_torch.species.uv.kestrel import Kestrel

MIN_DB = 40.0
SPECIES = {"kestrel": (Kestrel, JKestrel), "goldfish": (Goldfish, JGoldfish)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for this file's CPU forwards: the test workers
    share the machine's cores, and oversubscribed thread pools made these
    forwards 20-50x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_mst():
    return quality.load_pretrained()


@pytest.fixture(scope="module")
def model():
    return load_shipped("cpu")


def _check(got, want, psnr_fn, what):
    (base_t, out_t), (base_w, out_w) = got, want
    assert out_t.dtype == np.uint8 and out_t.shape == np.asarray(out_w).shape
    db = psnr_fn(out_t / 255.0, np.asarray(out_w) / 255.0)
    assert db >= MIN_DB, f"{what}: {db:.2f} dB"
    assert np.abs(base_t.astype(int) - np.asarray(base_w).astype(int)).max() <= 1, what


@pytest.mark.parametrize("name", sorted(SPECIES))
def test_attach_mst_vs_jax(name, img_u8, psnr_fn, jax_mst, model):
    cls, jcls = SPECIES[name]
    animal = attach_mst(cls("cpu"), model)
    assert np.array_equal(animal.lambdas, MST_LAMBDAS)
    got = animal.visualize(img_u8)
    _check(got, jproviders.attach_mst(jcls(), *jax_mst).visualize(img_u8), psnr_fn, name)
    # the provider's cube is not the analytic one
    assert not np.array_equal(got[1], cls("cpu").visualize(img_u8)[1])


def test_honeybee_provider_vs_jax(img_u8, psnr_fn, jax_mst, model):
    got = HoneyBee("cpu", hsi_provider=make_mst_hsi_provider(model)).visualize(img_u8)
    want = JHoneyBee(hsi_provider=jproviders.make_mst_hsi_provider(*jax_mst)).visualize(img_u8)
    _check(got, want, psnr_fn, "honeybee")


@pytest.mark.parametrize("name", ["kestrel", "honeybee"])
def test_batch_equals_frames(name, img_u8, model):
    provider = make_mst_hsi_provider(model)
    animal = attach_mst(Kestrel("cpu"), model) if name == "kestrel" else HoneyBee("cpu", hsi_provider=provider)
    batch = np.stack([img_u8, img_u8[::-1], (img_u8 > 127).astype(np.uint8) * 200])
    base_b, out_b = animal.visualize_batch(batch)
    for i in range(3):
        base_i, out_i = animal.visualize(batch[i])
        np.testing.assert_array_equal(out_b[i], out_i)
        np.testing.assert_array_equal(base_b[i], base_i)


def test_plain_transform_matches_kernel_path(img_u8, model):
    """On the CPU both programs take the plain versions: the same bits."""
    animal = attach_mst(Goldfish("cpu"), model)
    frame = torch.from_numpy(img_u8)
    for got, want in zip(animal.transform(img_u8.shape)(frame), animal.plain_transform(img_u8.shape)(frame)):
        assert torch.equal(got, want)


def test_provider_encoding_rules(model):
    """Input clipped to [0, 1]; with a ``pretrained_path`` the linear frame
    is re-encoded to sRGB before the model, otherwise it goes in as it is;
    the cube is clamped at >= 0; leading axes pass through one forward."""
    frames = torch.from_numpy(np.random.default_rng(3).uniform(-0.2, 1.2, (2, 3, 8, 16, 3)).astype(np.float32))
    clipped = frames.clamp(0.0, 1.0).reshape(6, 8, 16, 3)
    with torch.no_grad():
        linear = make_mst_hsi_provider(model)(frames)
        srgb = make_mst_hsi_provider(pretrained_path=SHIPPED, device="cpu")(frames)
        assert linear.shape == (2, 3, 8, 16, 31)
        assert torch.equal(linear.reshape(6, 8, 16, 31), model(clipped).clamp(min=0.0))
        assert torch.equal(srgb.reshape(6, 8, 16, 31), model(color.linear_to_srgb(clipped)).clamp(min=0.0))
    assert linear.min().item() >= 0.0
    with pytest.raises(ValueError, match="input_encoding"):
        make_mst_hsi_provider(model, input_encoding="log")
