"""Checks shared by the port's zoo model test files: each network of
``animal_vision_tpu_torch/models`` against its JAX module, on the CPU.

Both sides hold the same weights: the port's network is seeded by
``zoo.init_weights`` (``torch.Generator().manual_seed(0)``), its state dict
goes as NumPy through the JAX ``convert_torch_state`` into the JAX module.
Sizes: published widths at the JAX tests' reduced depths
(``tests/test_models_mst.py:166-400``), on (1, 32, 40, 3) and on
(1, 33, 41, 3), where the networks that pad crop back. Frames from
``np.random.default_rng``. The JAX side runs eagerly (no jit).

Bars (``BARS``, absolute): 1e-4, the JAX tests' own bar, except EDSR's
2e-3 (the JAX test's bar for the 32-block stack at full depth). The seeded
weights have PyTorch's default gain, so the outputs stay within a few
units (measured on the CPU: max |y| 0.17 to 2.5, errors 1.2e-7 to 2.8e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal_vision_tpu.models import awan as j_awan
from animal_vision_tpu.models import hdnet as j_hdnet
from animal_vision_tpu.models import hinet as j_hinet
from animal_vision_tpu.models import mirnet as j_mirnet
from animal_vision_tpu.models import mprnet as j_mprnet
from animal_vision_tpu.models import restormer as j_restormer
from animal_vision_tpu.models import sgn as j_sgn
from animal_vision_tpu.models import simple_nets as j_simple
from animal_vision_tpu_torch.models import awan, hdnet, hinet, mirnet, mprnet, restormer, sgn, simple_nets, zoo

SHAPES = [(1, 32, 40, 3), (1, 33, 41, 3)]

#: method -> (port network, its from_jax_params, JAX module, JAX converter),
#: at the JAX tests' depths
CASES = {
    "hscnn_plus": (lambda: simple_nets.HSCNNPlus(num_blocks=4), simple_nets.hscnn_from_jax_params,
                   lambda: j_simple.HSCNNPlus(num_blocks=4), j_simple.convert_hscnn_state),
    "edsr": (simple_nets.EDSR, simple_nets.edsr_from_jax_params, j_simple.EDSR, j_simple.convert_edsr_state),
    "hinet": (lambda: hinet.HINet(depth=4), hinet.from_jax_params, lambda: j_hinet.HINet(depth=4),
              j_hinet.convert_torch_state),
    "mprnet": (lambda: mprnet.MPRNet(num_cab=2), mprnet.from_jax_params, lambda: j_mprnet.MPRNet(num_cab=2),
               lambda sd: j_mprnet.convert_torch_state(sd, num_cab=2)),
    "restormer": (lambda: restormer.Restormer(num_blocks=(1, 1, 1, 1), num_refinement=1), restormer.from_jax_params,
                  lambda: j_restormer.Restormer(num_blocks=(1, 1, 1, 1), num_refinement=1),
                  lambda sd: j_restormer.convert_torch_state(sd, num_blocks=(1, 1, 1, 1), num_refinement=1)),
    "mirnet": (mirnet.MIRNet, mirnet.from_jax_params, j_mirnet.MIRNet, j_mirnet.convert_torch_state),
    "hdnet": (hdnet.HDNet, hdnet.from_jax_params, j_hdnet.HDNet, j_hdnet.convert_torch_state),
    "hrnet": (sgn.SGN, sgn.from_jax_params, j_sgn.SGN, j_sgn.convert_torch_state),
    "awan": (lambda: awan.AWAN(n_drbs=2), awan.from_jax_params, lambda: j_awan.AWAN(n_drbs=2),
             lambda sd: j_awan.convert_torch_state(sd, n_drbs=2)),
}

#: method -> max abs error from the JAX module
BARS = {"hscnn_plus": 1e-4, "edsr": 2e-3, "hinet": 1e-4, "mprnet": 1e-4, "restormer": 1e-4, "mirnet": 1e-4,
        "hdnet": 1e-4, "hrnet": 1e-4, "awan": 1e-4}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores.
    Imported by each zoo test file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded(method: str, seed: int = 0) -> torch.nn.Module:
    """The port's network of ``CASES[method]`` with seeded weights."""
    return zoo.init_weights(CASES[method][0](), torch.Generator().manual_seed(seed)).requires_grad_(False).eval()


def numpy_state(model: torch.nn.Module) -> dict:
    return {k: v.numpy() for k, v in model.state_dict().items()}


def frames(shape, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def check_vs_jax(method: str, shape) -> tuple[float, float]:
    model = seeded(method)
    _, _, jax_module, convert = CASES[method]
    variables = convert(numpy_state(model))
    x = frames(shape)
    want = np.asarray(jax_module().apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (*shape[:3], 31)
    assert np.isfinite(got).all()
    err = float(np.abs(got - want).max())
    assert err <= BARS[method], f"{method} {shape}: {err} from JAX (bar {BARS[method]}, max |y| {np.abs(want).max()})"
    return err, float(np.abs(want).max())


def check_round_trip(method: str) -> None:
    """``from_jax_params(convert_torch_state(sd)) == sd`` bit for bit, and
    the result loads strictly."""
    model = seeded(method)
    sd = model.state_dict()
    _, from_jax, _, convert = CASES[method]
    back = from_jax(convert(numpy_state(model))["params"])
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    CASES[method][0]().load_state_dict(back)


def check_batch_equals_frames(method: str) -> None:
    """Each frame's output depends on that frame alone, which the providers
    rely on to batch (within float32 noise: a batch may take other
    convolution algorithms)."""
    model = seeded(method)
    x = torch.from_numpy(frames((2, 16, 24, 3), seed=5))
    with torch.no_grad():
        both = model(x)
        alone = torch.cat([model(x[:1]), model(x[1:])])
    assert torch.allclose(both, alone, rtol=0, atol=1e-5 * max(1.0, alone.abs().max().item()))
