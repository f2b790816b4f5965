"""The port's shipped MST++ weights (``models/pretrained/synth_v1.pt``)
against the JAX package's shipped checkpoint, on the CPU.

The file is ``from_jax_params`` of the Orbax checkpoint
``animal_vision_tpu/models/pretrained/synth_v1``, bit for bit, with each
decoder up-convolution's four (dy, dx) bias copies kept apart. Regenerate it
(this needs the JAX package and orbax) with

    python tests/test_torch_mst_weights.py
"""

import sys
from pathlib import Path

if __name__ == "__main__":  # run as a script: import both packages from this checkout
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402  (on the CPU backend, as tests/conftest.py sets it)
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from animal_vision_tpu.models import quality  # noqa: E402
from animal_vision_tpu_torch.models.mst_plus_plus import (  # noqa: E402
    SHIPPED,
    MSTPlusPlus,
    from_jax_params,
    load_shipped,
)


@pytest.fixture(scope="module")
def jax_params():
    return quality.load_pretrained()[1]["params"]


def test_shipped_file_is_the_checkpoint_bit_for_bit(jax_params):
    want = from_jax_params(jax_params)
    got = torch.load(SHIPPED, map_location="cpu", weights_only=True)
    assert type(got) is dict and sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], v), k
    assert sum(v.numel() for v in got.values()) == 1_620_462
    assert sorted(got) == sorted(MSTPlusPlus().state_dict())


@pytest.mark.parametrize("stage", [0, 1, 2])
@pytest.mark.parametrize("level", [0, 1])
def test_up_conv_bias_copies_stay_apart(jax_params, stage, level):
    """The checkpoint's four per-(dy, dx) copies of each up-conv bias have
    diverged (0.0135-0.0194 from their mean); collapsing them (as a
    ConvTranspose2d's one bias per channel would) fails here."""
    bias = load_shipped("cpu").state_dict()[f"body.{stage}.decoder_layers.{level}.0.bias"]
    half = bias.shape[0]
    assert tuple(bias.shape) == (half, 2, 2)
    flax = np.asarray(jax_params[f"body_{stage}"][f"dec_up_{level}"]["bias"]).reshape(2, 2, half)
    np.testing.assert_array_equal(bias.numpy(), flax.transpose(2, 0, 1))
    spread = (bias - bias.mean(dim=(1, 2), keepdim=True)).abs().max().item()
    assert spread >= 0.01


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    SHIPPED.parent.mkdir(parents=True, exist_ok=True)
    torch.save(from_jax_params(quality.load_pretrained()[1]["params"]), SHIPPED)
    print(f"wrote {SHIPPED}")
