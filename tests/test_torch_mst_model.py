"""The port's MST++ (``models/mst_plus_plus.py``) against the JAX module's
XLA path, on the CPU.

Weights: ``PRNGKey(0)`` initial weights and the shipped ``synth_v1``
checkpoint, both carried across by ``from_jax_params``. Frames from
``np.random.default_rng``; (2, 21, 37, 3) exercises the reflect pad to
multiples of 8. Bar: < 5e-4 max abs, the JAX package's own bar for MST++
against its torch reference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal_vision_tpu.models import quality
from animal_vision_tpu.models.mst_plus_plus import MSTPlusPlus as JMSTPlusPlus
from animal_vision_tpu.models.mst_plus_plus import export_torch_state
from animal_vision_tpu_torch.models.mst_plus_plus import MSTPlusPlus, from_jax_params, load_shipped
from animal_vision_tpu_torch.ops import _build

SHAPES = [(1, 24, 40, 3), (2, 21, 37, 3)]
TOL = 5e-4


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
def jax_apply():
    return jax.jit(JMSTPlusPlus().apply)


@pytest.fixture(scope="module")
def weights():
    """{name: JAX variables}: PRNGKey(0) init (the param tree only, which
    equals the full init's) and the shipped checkpoint."""
    init = JMSTPlusPlus().init(jax.random.PRNGKey(0), None, weights_only=True)
    return {"prng0": init, "synth_v1": quality.load_pretrained()[1]}


def _port(variables) -> MSTPlusPlus:
    model = MSTPlusPlus()
    model.load_state_dict(from_jax_params(variables["params"]))
    return model.requires_grad_(False)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("which", ["prng0", "synth_v1"])
def test_model_vs_jax_xla(jax_apply, weights, which, shape):
    x = np.random.default_rng(sum(shape)).random(shape, dtype=np.float32)
    want = np.asarray(jax_apply(weights[which], jnp.asarray(x)))
    got = _port(weights[which])(torch.from_numpy(x))
    assert got.shape == want.shape == (*shape[:3], 31)
    assert np.abs(got.numpy() - want).max() < TOL


def test_shipped_model_equals_its_carry_over(weights):
    a, b = load_shipped("cpu"), _port(weights["synth_v1"])
    x = torch.from_numpy(np.random.default_rng(5).random((1, 16, 24, 3), dtype=np.float32))
    assert torch.equal(a(x), b(x))


def test_reference_layout_state_loads(weights):
    """A reference-layout state dict (the JAX ``export_torch_state`` of a
    fresh init, whose four bias copies are equal and collapse to one bias
    per channel) loads by broadcasting and gives the same output."""
    ref = export_torch_state(weights["prng0"], strict=True)
    assert ref["body.0.decoder_layers.0.0.bias"].shape == (62,)
    a = MSTPlusPlus()
    a.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in ref.items()})
    b = _port(weights["prng0"])
    for k, v in b.state_dict().items():
        assert torch.equal(a.state_dict()[k], v), k
    x = torch.from_numpy(np.random.default_rng(4).random((1, 16, 24, 3), dtype=np.float32))
    with torch.no_grad():
        assert torch.equal(a(x), b(x))


def test_batch_equals_frames():
    model = load_shipped("cpu")
    x = torch.from_numpy(np.random.default_rng(6).random((3, 16, 21, 3), dtype=np.float32))
    batch = model(x)
    for i in range(3):
        assert torch.equal(batch[i], model(x[i:i + 1])[0])


def test_plain_and_kernel_paths_agree_on_the_cpu():
    """On the CPU the wrappers take their plain versions: the two paths are
    one chain, and no kernel is counted."""
    model = load_shipped("cpu")
    x = torch.from_numpy(np.random.default_rng(8).random((1, 8, 8, 3), dtype=np.float32))
    _build.reset_launches()
    assert torch.equal(model(x), model(x, plain=True))
    assert set(_build.LAUNCHES.values()) == {0}


def test_param_count_and_names():
    model = MSTPlusPlus()
    sd = model.state_dict()
    assert sum(v.numel() for v in sd.values()) == 1_620_462
    assert tuple(sd["body.2.decoder_layers.1.0.bias"].shape) == (31, 2, 2)
    assert tuple(sd["body.0.encoder_layers.1.0.blocks.0.0.rescale"].shape) == (2, 1, 1)
    assert tuple(sd["body.1.bottleneck.blocks.0.1.fn.net.2.weight"].shape) == (496, 1, 3, 3)


def test_load_shipped_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_shipped()
