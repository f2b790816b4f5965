"""The zoo's nine convolutional methods as kestrel's HSI provider
(``models/providers.py``) against the JAX package, on the CPU.

Each network at the reduced depth of ``tests/torch_zoo_checks.py``, with
the same weights on both sides (the port's seeded state dict through the
JAX ``convert_torch_state``): the port's ``make_mst_hsi_provider(module)``
and ``use_hsi_provider`` against the JAX ``make_mst_hsi_provider(module,
variables)``, which the JAX ``attach_model`` runs. Kestrel runs its
provider on the 0.25-scale frame (16x24 for the 64x96 ``img_u8``). Bar:
>= 40 dB PSNR on the uint8 output (the repo's UV contract), baseline within
1 LSB. Then ``attach_model(Kestrel("cpu"), method)`` with the registry's
full configuration: a batch equals its frames."""

import numpy as np
import pytest

from animal_vision_tpu.models import providers as j_providers
from animal_vision_tpu.species.uv.kestrel import Kestrel as JKestrel
from animal_vision_tpu_torch.models.providers import MST_LAMBDAS, attach_model, make_mst_hsi_provider
from animal_vision_tpu_torch.species.uv.kestrel import Kestrel
from torch_zoo_checks import CASES, numpy_state, one_torch_thread, seeded

MIN_DB = 40.0
NINE = sorted(CASES)
_ = one_torch_thread


@pytest.mark.parametrize("method", NINE)
def test_kestrel_provider_vs_jax(method, img_u8, psnr_fn):
    model = seeded(method)
    _, _, jax_module, convert = CASES[method]
    animal = Kestrel("cpu").use_hsi_provider(make_mst_hsi_provider(model), lambdas=MST_LAMBDAS)
    base_t, out_t = animal.visualize(img_u8)
    jprov = j_providers.make_mst_hsi_provider(jax_module(), convert(numpy_state(model)))
    base_w, out_w = JKestrel().use_hsi_provider(jprov, lambdas=j_providers.MST_LAMBDAS).visualize(img_u8)
    assert out_t.dtype == np.uint8 and out_t.shape == np.asarray(out_w).shape
    db = psnr_fn(out_t / 255.0, np.asarray(out_w) / 255.0)
    assert db >= MIN_DB, f"{method}: {db:.2f} dB"
    assert np.abs(base_t.astype(int) - np.asarray(base_w).astype(int)).max() <= 1
    assert not np.array_equal(out_t, Kestrel("cpu").visualize(img_u8)[1])


@pytest.mark.parametrize("method", NINE)
def test_attach_model_batch_equals_frames(method, img_u8):
    """The registry configuration through ``attach_model``; the provider
    runs the frames as one batch, within 1 LSB of each frame alone."""
    animal = attach_model(Kestrel("cpu"), method)
    assert np.array_equal(animal.lambdas, MST_LAMBDAS)
    batch = np.stack([img_u8, img_u8[::-1]])
    base_b, out_b = animal.visualize_batch(batch)
    for i in range(2):
        base_i, out_i = animal.visualize(batch[i])
        np.testing.assert_array_equal(base_b[i], base_i)
        assert np.abs(out_b[i].astype(int) - out_i.astype(int)).max() <= 1
    assert out_b.shape == (2, *img_u8.shape)
