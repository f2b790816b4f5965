"""The zoo's U-shaped networks (HINet, MPRNet, MIRNet) in the port against
the JAX modules, on the CPU; see ``tests/torch_zoo_checks.py`` for the
weights, sizes and bars. The odd frame size runs their reflect pad (to 16
for HINet, 8 for the others) and crop."""

import numpy as np
import pytest
import torch
from torch import nn

from animal_vision_tpu.models import hinet as j_hinet
from animal_vision_tpu.models import mirnet as j_mirnet
from animal_vision_tpu.models import mprnet as j_mprnet
from animal_vision_tpu_torch.models import hinet, mirnet, mprnet
from torch_zoo_checks import (SHAPES, check_batch_equals_frames, check_round_trip, check_vs_jax, numpy_state,
                              one_torch_thread, seeded)

METHODS = ["hinet", "mprnet", "mirnet"]
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


@pytest.mark.parametrize("method,n_sites", [("mprnet", 2 * 6 + 2 * 8 + 3 * 2 + 3), ("mirnet", 9)])
def test_one_prelu_for_all_sites(method, n_sites):
    """MPRNet's CABs and MIRNet's DAUs share one PReLU, named under every
    site of the state dict as the reference names it; from_jax_params
    raises when the JAX copies differ."""
    model = seeded(method)
    sites = [k for k, _ in model.named_parameters(remove_duplicate=False)
             if k.endswith(".body.1.weight") and (method == "mprnet" or ".blocks." in k)]
    assert len(sites) == n_sites
    assert len({id(model.get_parameter(k)) for k in sites}) == 1
    sd = numpy_state(model)
    sd[sites[-1]] = sd[sites[-1]] + 0.5
    convert = {"mprnet": lambda s: j_mprnet.convert_torch_state(s, num_cab=2), "mirnet": j_mirnet.convert_torch_state}
    from_jax = {"mprnet": mprnet.from_jax_params, "mirnet": mirnet.from_jax_params}
    with pytest.raises(ValueError, match="shares one module"):
        from_jax[method](convert[method](sd)["params"])


def test_hinet_up_bias_copies_must_agree():
    """The JAX up-convolution holds a bias per (dy, dx, out); the reference
    one per channel, so copies that differ cannot be carried across."""
    params = j_hinet.convert_torch_state(numpy_state(seeded("hinet")))["params"]
    bias = np.array(params["up1_0"]["bias"])
    bias[-1] += 1.0
    params["up1_0"] = {**params["up1_0"], "bias": bias}
    with pytest.raises(ValueError, match="bias copies differ"):
        hinet.from_jax_params(params)


def test_mirnet_loads_the_reference_mesh_resamplers():
    """A reference state dict also holds the mesh columns' resamplers
    (``down.31_4``, ``up.*``), which a width-1 MSRB never runs: they load
    and are dropped. The idle SKFFs of rows 1 and 2 are held (the JAX
    converter reads them) and listed by ``idle_keys``."""
    model = seeded("mirnet")
    sd = dict(model.state_dict())
    sd["body.0.body.0.down.31_4.body.0.top.0.weight"] = torch.ones(31, 31, 1, 1)
    sd["body.0.body.0.up.124_2.body.0.bot.1.weight"] = torch.ones(62, 124, 1, 1)
    fresh = mirnet.MIRNet()
    fresh.load_state_dict(sd)
    assert all(torch.equal(fresh.state_dict()[k], v) for k, v in model.state_dict().items())
    idle = model.idle_keys()
    assert idle and all(".selective_kernel.1." in k or ".selective_kernel.2." in k for k in idle)
    assert isinstance(model.body[0].body[0].blocks[0][0].body[1], nn.PReLU)
