"""Model registry: method name -> the port's ``nn.Module``.

Counterpart of ``animal_vision_tpu/models/zoo.py``, all eleven methods with
the JAX constructors' arguments (``animal_vision_tpu/models/zoo.py:137-161``):
``"mst_plus_plus"`` (MST++, ``models/mst_plus_plus.py``), ``"mst"`` (MST-L,
``models/mst.py``), ``"hscnn_plus"`` and ``"edsr"``
(``models/simple_nets.py``), ``"hinet"``, ``"mprnet"``, ``"restormer"``,
``"mirnet"``, ``"hdnet"``, ``"hrnet"`` (SGN, ``models/sgn.py``) and
``"awan"``. The nine methods beside MST++ and MST-L are plain PyTorch: the
JAX package runs them in XLA outside any Pallas kernel.

``model_generator`` loads a checkpoint in the reference layout when given
one, and otherwise draws the weights from an explicit
``torch.Generator(seed)``, like the JAX ``model_generator`` without a path
(whose numbers differ: ``jax.random`` is another generator).
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

from animal_vision_tpu_torch.models.awan import AWAN
from animal_vision_tpu_torch.models.common import ZooNet
from animal_vision_tpu_torch.models.hdnet import HDNet
from animal_vision_tpu_torch.models.hinet import HINet
from animal_vision_tpu_torch.models.mirnet import MIRNet
from animal_vision_tpu_torch.models.mprnet import MPRNet
from animal_vision_tpu_torch.models.mst import MSTModel
from animal_vision_tpu_torch.models.mst_plus_plus import MSTPlusPlus, UpConv
from animal_vision_tpu_torch.models.restormer import Restormer
from animal_vision_tpu_torch.models.sgn import SGN
from animal_vision_tpu_torch.models.simple_nets import EDSR, HSCNNPlus
from animal_vision_tpu_torch.species import resolve_device

_REGISTRY = {
    "mst_plus_plus": MSTPlusPlus,
    # 'hinet' config parity: HINet(depth=4)
    "hinet": lambda: HINet(depth=4),
    "awan": lambda: AWAN(n_drbs=8),
    "restormer": Restormer,
    # 'mprnet' config parity: MPRNet(num_cab=4)
    "mprnet": lambda: MPRNet(num_cab=4),
    "hdnet": HDNet,
    # 'mirnet' config parity: MIRNet(n_RRG=3, n_MSRB=1, height=3, width=1)
    "mirnet": lambda: MIRNet(n_rrg=3, n_msrb=1, height=3, width=1),
    # 'hrnet' config parity: SGN()
    "hrnet": SGN,
    # 'mst' config parity: MST(dim=31, stage=2, num_blocks=[4,7,5])
    "mst": MSTModel,
    "hscnn_plus": HSCNNPlus,
    "edsr": EDSR,
}


def available_models() -> list[str]:
    return sorted(_REGISTRY)


def find_state_dict(obj: Any) -> dict:
    """Unwrap common checkpoint containers and strip DataParallel's
    ``module.`` prefix."""
    sd = obj
    if isinstance(sd, dict):
        for key in ("state_dict", "model_state_dict", "net", "model", "params"):
            if key in sd and isinstance(sd[key], dict):
                sd = sd[key]
                break
    return {k.removeprefix("module."): v for k, v in sd.items()}


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights drawn from ``generator`` (on the CPU), in the spirit
    of the JAX package's initialisers: each kernel normal with standard
    deviation 1/sqrt(fan in) (MST++ and MST-L) or 1/sqrt(3 fan in), the
    gain of PyTorch's own default for convolutions (the nine networks of
    ``models/common.py:ZooNet``, whose residual stacks of up to 63 blocks
    would grow their outputs a thousandfold at unit gain), biases 0; norm
    scales (LayerNorm, InstanceNorm, BatchNorm), attention rescales and
    temperatures 1; PReLU slopes 0.25 (a shared PReLU once). BatchNorm
    running means are drawn normal with standard deviation 0.1 and running
    variances uniform on [0.5, 1.5), so that the inference normalisation is
    not the identity."""
    gain = 1.0 / math.sqrt(3.0) if isinstance(model, ZooNet) else 1.0
    with torch.no_grad():
        for name, p in model.named_parameters():
            owner_name, _, leaf = name.rpartition(".")
            owner = model.get_submodule(owner_name)
            if isinstance(owner, nn.PReLU):
                p.fill_(0.25)
            elif leaf in ("rescale", "temperature") or (leaf == "weight" and p.dim() == 1):
                p.fill_(1.0)
            elif leaf == "bias":
                p.zero_()
            else:
                # a transposed convolution's (in, out, k, k) weight: each
                # output sums over the input channels at k^2 / stride^2 taps
                if isinstance(owner, UpConv):
                    fan_in = p.shape[0]
                elif isinstance(owner, nn.ConvTranspose2d):
                    fan_in = p.shape[0] * p[0, 0].numel() / (owner.stride[0] * owner.stride[1])
                else:
                    fan_in = p[0].numel()
                p.copy_(torch.randn(p.shape, generator=generator) * (gain / math.sqrt(fan_in)))
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.copy_(0.1 * torch.randn(m.running_mean.shape, generator=generator))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=generator))
    return model


def model_generator(method: str, pretrained_model_path=None, device: str | torch.device | None = None,
                    seed: int = 0) -> nn.Module:
    """The model ``method`` for inference on ``device`` (the CUDA card when
    None; without a card that raises), with the weights of the reference
    checkpoint ``pretrained_model_path`` or, without one, weights drawn from
    ``torch.Generator().manual_seed(seed)``."""
    if method not in _REGISTRY:
        raise ValueError(f"unknown method {method!r}; available: {available_models()}")
    device = resolve_device(device)
    model = _REGISTRY[method]()
    if pretrained_model_path:
        ckpt = torch.load(pretrained_model_path, map_location="cpu", weights_only=True)
        model.load_state_dict(find_state_dict(ckpt))
    else:
        init_weights(model, torch.Generator().manual_seed(seed))
    return model.requires_grad_(False).eval().to(device)
