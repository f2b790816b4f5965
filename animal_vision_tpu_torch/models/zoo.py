"""Model registry: method name -> the port's ``nn.Module``.

Counterpart of ``animal_vision_tpu/models/zoo.py`` for the methods ported
so far: ``"mst_plus_plus"`` (MST++, ``models/mst_plus_plus.py``) and
``"mst"`` (MST-L, ``models/mst.py``). The JAX registry's nine other methods
raise a ``ValueError`` that names them as not yet ported.

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

from animal_vision_tpu_torch.models.mst import MSTModel
from animal_vision_tpu_torch.models.mst_plus_plus import MSTPlusPlus, UpConv

_REGISTRY = {
    "mst_plus_plus": MSTPlusPlus,
    # 'mst' config parity: MST(dim=31, stage=2, num_blocks=[4,7,5])
    "mst": MSTModel,
}
#: The JAX registry's methods that the port does not have yet.
NOT_PORTED = ("awan", "edsr", "hdnet", "hinet", "hrnet", "hscnn_plus", "mirnet", "mprnet", "restormer")


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
    deviation 1/sqrt(fan in), biases 0, LayerNorm scales and attention
    rescales 1."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            owner_name, _, leaf = name.rpartition(".")
            owner = model.get_submodule(owner_name)
            if leaf == "rescale" or (isinstance(owner, nn.LayerNorm) and leaf == "weight"):
                p.fill_(1.0)
            elif leaf == "bias":
                p.zero_()
            else:
                # an up-convolution's (in, out, 2, 2) weight: each output
                # sums over the input channels at one tap
                fan_in = p.shape[0] if isinstance(owner, UpConv) else p[0].numel()
                p.copy_(torch.randn(p.shape, generator=generator) / math.sqrt(fan_in))
    return model


def model_generator(method: str, pretrained_model_path=None, device: str | torch.device | None = None,
                    seed: int = 0) -> nn.Module:
    """The model ``method`` for inference on ``device`` (the CUDA card when
    None; without a card that raises), with the weights of the reference
    checkpoint ``pretrained_model_path`` or, without one, weights drawn from
    ``torch.Generator().manual_seed(seed)``."""
    if method in NOT_PORTED:
        raise ValueError(f"method {method!r} is not yet ported to PyTorch; ported: {available_models()}")
    if method not in _REGISTRY:
        raise ValueError(f"unknown method {method!r}; available: {available_models()}")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    model = _REGISTRY[method]()
    if pretrained_model_path:
        ckpt = torch.load(pretrained_model_path, map_location="cpu", weights_only=True)
        model.load_state_dict(find_state_dict(ckpt))
    else:
        init_weights(model, torch.Generator().manual_seed(seed))
    return model.requires_grad_(False).eval().to(device)
