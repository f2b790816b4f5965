"""MST++ as the UV species' HSI provider.

Counterpart of ``animal_vision_tpu/models/providers.py``: MST++ inference
in place of a UV species' analytic RGB -> spectrum upsampler (BASELINE.json
config #4, "MST++ RGB->31-band hyperspectral inference + kestrel/mantis-
shrimp UV rendering"). A provider is a callable ``(frames, plain=False) ->
cube`` from (..., h, w, 3) frames to the (..., h, w, 31) cube on the
``MST_LAMBDAS`` grid; ``plain`` runs the model's plain versions (what a
species' ``plain_transform`` uses).
"""

from __future__ import annotations

import numpy as np
import torch

from animal_vision_tpu_torch.core import color
from animal_vision_tpu_torch.models.mst_plus_plus import MSTPlusPlus, load_state

#: the MST++ band grid (31 bands, 400-700 nm, the ARAD_1K convention)
MST_LAMBDAS = np.linspace(400.0, 700.0, 31, dtype=np.float32)


def make_mst_hsi_provider(module: MSTPlusPlus | None = None, pretrained_path=None,
                          input_encoding: str | None = None, device: str | torch.device = "cuda"):
    """A provider running ``module`` (a new ``MSTPlusPlus`` on ``device``
    when None), with the weights of ``pretrained_path`` (a ``.pth`` in the
    reference or the port's layout) loaded into it when given.

    The input is clipped to [0, 1]. ``input_encoding`` names what the model
    expects: the UV species feed linear-light RGB, but checkpoints trained
    on ARAD see gamma-encoded RGB, so with a ``pretrained_path`` the default
    re-encodes linear -> sRGB (``"srgb"``) and otherwise keeps the input
    (``"linear"``). The cube is clamped at >= 0 (physical reflectance). The
    frames go through one forward as one batch."""
    if input_encoding is None:
        input_encoding = "srgb" if pretrained_path is not None else "linear"
    if input_encoding not in ("linear", "srgb"):
        raise ValueError(f"input_encoding must be 'linear' or 'srgb', got {input_encoding!r}")
    if module is None:
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        module = MSTPlusPlus()
        if pretrained_path is not None:
            module.load_state_dict(load_state(pretrained_path))
        module = module.requires_grad_(False).eval().to(device)
    elif pretrained_path is not None:
        module.load_state_dict(load_state(pretrained_path))

    def provider(frames: torch.Tensor, plain: bool = False) -> torch.Tensor:
        x = torch.clamp(frames.to(torch.float32), 0.0, 1.0)
        if input_encoding == "srgb":
            x = color.linear_to_srgb(x)
        with torch.no_grad():
            cube = module(x.reshape(-1, *x.shape[-3:]), plain=plain)
        return torch.clamp(cube, min=0.0).reshape(*x.shape[:-1], cube.shape[-1])

    return provider


def attach_mst(animal, module: MSTPlusPlus | None = None, pretrained_path=None):
    """Attach an MST++ provider (on the animal's device when ``module`` is
    None) and its 31-band grid to a UV animal."""
    provider = make_mst_hsi_provider(module, pretrained_path, device=animal.device)
    return animal.use_hsi_provider(provider, lambdas=MST_LAMBDAS)
