"""The port's MST-L (``models/mst.py``) and zoo (``models/zoo.py``) against
the JAX package, on the CPU.

Weights: the JAX ``MSTModel(num_blocks=(4, 7, 5))`` ``PRNGKey(0)`` init
(the params of the JAX ``model_generator("mst")``, which do not depend on
the probe shape), carried across by ``from_jax_params``. Frames from
``np.random.default_rng``; (1, 21, 37, 3) exercises the reflect pad to
multiples of 8. Bar: 5e-4 of max |y|: the random-init output reaches about
230, so the JAX package's 5e-4 absolute bar for MST++ is taken relative to
the output's size (measured: 4.0e-4 absolute, 1.7e-6 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal_vision_tpu.models import zoo as jzoo
from animal_vision_tpu.models.mst import MSTModel as JMSTModel
from animal_vision_tpu.models.mst import convert_torch_state
from animal_vision_tpu_torch.models import zoo
from animal_vision_tpu_torch.models.mst import MSTModel, from_jax_params
from animal_vision_tpu_torch.models.mst_plus_plus import MSTPlusPlus
from animal_vision_tpu_torch.ops import fused_mst as K

SHAPES = [(2, 24, 40, 3), (1, 21, 37, 3)]
REL_TOL = 5e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_model():
    module = JMSTModel(dim=31, stage=2, num_blocks=(4, 7, 5))
    return module, module.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3)))


@pytest.fixture(scope="module")
def port(jax_model):
    model = MSTModel()
    model.load_state_dict(from_jax_params(jax_model[1]["params"]))
    return model.requires_grad_(False)


def _x(shape, seed=None):
    return np.random.default_rng(sum(shape) if seed is None else seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_model_vs_jax(jax_model, port, shape):
    """Frame 1 of the batch runs with frame 0's mask on both sides."""
    module, variables = jax_model
    x = _x(shape)
    want = np.asarray(jax.jit(module.apply)(variables, jnp.asarray(x)))
    got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (*shape[:3], 31)
    assert np.abs(got - want).max() <= REL_TOL * max(1.0, np.abs(want).max())


def test_batch_uses_the_first_frames_mask(port):
    """Every frame of a batch takes frame 0's mask: frame 1's output
    changes with frame 0 and differs from frame 1 alone; frame 0's does
    not depend on frame 1."""
    x0, x1, x2 = (torch.from_numpy(_x((1, 16, 24, 3), seed=s)) for s in (1, 2, 3))
    a = port(torch.cat([x0, x1]))
    b = port(torch.cat([x2, x1]))
    alone = port(x1)[0]
    scale = alone.abs().max().item()
    assert (a[1] - b[1]).abs().max().item() > 1e-3 * scale
    assert (a[1] - alone).abs().max().item() > 1e-3 * scale
    assert torch.allclose(a[0], port(x0)[0], rtol=0, atol=1e-5 * scale)


def test_plain_and_kernel_paths_agree_on_the_cpu(port):
    """On the CPU the FFN wrapper takes its plain version: one chain, no
    launch counted."""
    x = torch.from_numpy(_x((1, 8, 8, 3)))
    K.reset_launches()
    assert torch.equal(port(x), port(x, plain=True))
    assert K.LAUNCHES == {"ffn": 0}


def test_param_count_and_reference_layout(jax_model, port):
    """The same parameters as the JAX tree; the reference ``MST.py`` names,
    which the JAX ``convert_torch_state`` reads back to the JAX tree
    exactly (the fresh init's four up-conv bias copies are equal, so the
    reference's one bias per channel holds them)."""
    jparams = jax_model[1]["params"]
    sd = port.state_dict()
    assert sum(v.numel() for v in sd.values()) == sum(np.size(a) for a in jax.tree_util.tree_leaves(jparams))
    assert tuple(sd["decoder_layers.1.0.bias"].shape) == (31, 2, 2)
    assert tuple(sd["bottleneck.blocks.4.0.mm.depth_conv.weight"].shape) == (124, 1, 5, 5)
    assert tuple(sd["encoder_layers.1.2.weight"].shape) == (124, 62, 4, 4)
    ref = {k: (v[:, 0, 0] if k.endswith(".0.bias") and k.startswith("decoder") else v).numpy() for k, v in sd.items()}
    back = convert_torch_state(ref)["params"]
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jparams), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))
    loaded = MSTModel()
    loaded.load_state_dict({k: torch.from_numpy(v) for k, v in ref.items()})
    for k, v in sd.items():
        assert torch.equal(loaded.state_dict()[k], v), k


def test_zoo_lists_the_ported_methods():
    """Every method of the JAX registry is ported."""
    assert zoo.available_models() == jzoo.available_models()
    with pytest.raises(ValueError, match="unknown method"):
        zoo.model_generator("unet", device="cpu")


@pytest.mark.parametrize("method,cls", [("mst", MSTModel), ("mst_plus_plus", MSTPlusPlus)])
def test_model_generator_seeded(method, cls):
    """Weights from an explicit generator: the same seed gives the same
    weights, another seed others; kernels of about unit gain, biases 0,
    LayerNorm scales and attention rescales 1."""
    a = zoo.model_generator(method, device="cpu", seed=0)
    b = zoo.model_generator(method, device="cpu", seed=0)
    c = zoo.model_generator(method, device="cpu", seed=1)
    assert isinstance(a, cls) and not a.training
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not all(torch.equal(sa[k], sc[k]) for k in sa)
    rescale = [v for k, v in sa.items() if k.endswith("rescale")]
    assert rescale and all(torch.equal(v, torch.ones_like(v)) for v in rescale)
    assert all(torch.equal(v, torch.zeros_like(v)) for k, v in sa.items() if k.endswith("bias"))
    w = sa["mapping.weight"] if method == "mst" else sa["conv_out.weight"]
    assert 0.5 < w.std().item() * np.sqrt(w[0].numel()) < 1.5


def test_model_generator_loads_a_checkpoint(tmp_path):
    """A reference checkpoint wrapped as ``{"state_dict": ...}`` with
    DataParallel's ``module.`` prefixes loads through ``find_state_dict``."""
    src = zoo.model_generator("mst", device="cpu", seed=3)
    path = tmp_path / "mst.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in src.state_dict().items()}}, path)
    got = zoo.model_generator("mst", path, device="cpu")
    assert all(torch.equal(got.state_dict()[k], v) for k, v in src.state_dict().items())
    assert zoo.find_state_dict({"model": {"module.a": 1}}) == {"a": 1}


def test_model_generator_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zoo.model_generator("mst")
