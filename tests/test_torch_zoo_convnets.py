"""The zoo's convolution stacks (HSCNN+, EDSR, HDNet, SGN) in the port
against the JAX modules, on the CPU; see ``tests/torch_zoo_checks.py`` for
the weights, sizes and bars."""

import pytest
import torch

from animal_vision_tpu_torch.models import sgn
from torch_zoo_checks import (SHAPES, check_batch_equals_frames, check_round_trip, check_vs_jax, one_torch_thread,
                              seeded)

METHODS = ["hscnn_plus", "edsr", "hdnet", "hrnet"]
_ = one_torch_thread


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("method", METHODS)
def test_forward_vs_jax(method, shape):
    check_vs_jax(method, shape)


@pytest.mark.parametrize("method", METHODS)
def test_from_jax_params_round_trip(method):
    check_round_trip(method)


@pytest.mark.parametrize("method", METHODS)
def test_batch_equals_frames(method):
    check_batch_equals_frames(method)


def test_hdnet_batchnorm_uses_running_statistics():
    """Inference BatchNorm whatever the mode: ``train()`` changes nothing,
    and the seeded running statistics are not the identity's."""
    model = seeded("hdnet")
    bn = model.body[33].subspaces[0].bn_dws
    assert not torch.equal(bn.running_var, torch.ones_like(bn.running_var))
    x = torch.rand(1, 16, 24, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model(x)
        got = model.train()(x)
    assert torch.equal(got, want)
    assert torch.equal(bn.running_mean, seeded("hdnet").body[33].subspaces[0].bn_dws.running_mean)


def test_sgn_drops_the_dead_gate_weights_and_lrelus_its_output():
    """A reference state dict's GlobalBlock ``fc`` entries (the overwritten
    squeeze-excite gate) load and are dropped; the output is LeakyReLU'd,
    so it is never below 0.2 times its most negative pre-activation."""
    model = seeded("hrnet")
    sd = dict(model.state_dict())
    sd["top22.fc.0.weight"] = torch.ones(64, 512)
    sd["main35.fc.2.weight"] = torch.ones(64, 8)
    fresh = sgn.SGN()
    fresh.load_state_dict(sd)
    assert all(torch.equal(fresh.state_dict()[k], v) for k, v in model.state_dict().items())
    x = torch.rand(1, 16, 24, 3, generator=torch.Generator().manual_seed(2))
    pre = []
    hook = model.main4.conv2d.register_forward_hook(lambda m, i, o: pre.append(o))
    with torch.no_grad():
        y = model(x)
    hook.remove()
    pre = pre[0].permute(0, 2, 3, 1)
    assert (pre < 0).any()
    assert torch.equal(y, torch.nn.functional.leaky_relu(pre, 0.2))


def test_sgn_runs_a_batch_frame_by_frame():
    """SGN's batch is its frames run one at a time (cuDNN's FFT path made a
    batch of four 272x480 frames slower on the card than the four alone):
    bit-equal to the frames, and one forward per frame."""
    model = seeded("hrnet")
    x = torch.rand(3, 16, 24, 3, generator=torch.Generator().manual_seed(3))
    calls = []
    hook = model.top1.register_forward_hook(lambda m, i, o: calls.append(i[0].shape[0]))
    with torch.no_grad():
        both = model(x)
        alone = torch.cat([model(x[i:i + 1]) for i in range(3)])
    hook.remove()
    assert calls == [1] * 6
    assert torch.equal(both, alone)
