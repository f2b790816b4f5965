"""Zoo models as the UV species' HSI provider.

Counterpart of ``animal_vision_tpu/models/providers.py``: model inference
in place of a UV species' analytic RGB -> spectrum upsampler (BASELINE.json
config #4, "MST++ RGB->31-band hyperspectral inference + kestrel/mantis-
shrimp UV rendering"). A provider is a callable ``(frames, plain=False) ->
cube`` from (..., h, w, 3) frames to the (..., h, w, 31) cube on the
``MST_LAMBDAS`` grid; ``plain`` runs the model's plain versions (what a
species' ``plain_transform`` uses). Any of the zoo's eleven methods
serves (``models/zoo.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from animal_vision_tpu_torch.core import color
from animal_vision_tpu_torch.models.mst import MSTModel
from animal_vision_tpu_torch.models.mst_plus_plus import MSTPlusPlus, load_state
from animal_vision_tpu_torch.models.zoo import model_generator

#: the zoo's band grid (31 bands, 400-700 nm, the ARAD_1K convention)
MST_LAMBDAS = np.linspace(400.0, 700.0, 31, dtype=np.float32)


def make_mst_hsi_provider(module: torch.nn.Module | None = None, pretrained_path=None,
                          input_encoding: str | None = None, device: str | torch.device = "cuda",
                          method: str = "mst_plus_plus"):
    """A provider running ``module`` (when None, the zoo's ``method`` on
    ``device``: its weights from ``pretrained_path``, or seeded), with the
    weights of ``pretrained_path`` loaded into a given ``module``.

    The input is clipped to [0, 1]. ``input_encoding`` names what the model
    expects: the UV species feed linear-light RGB, but checkpoints trained
    on ARAD see gamma-encoded RGB, so with a ``pretrained_path`` the default
    re-encodes linear -> sRGB (``"srgb"``) and otherwise keeps the input
    (``"linear"``). The cube is clamped at >= 0 (physical reflectance).
    MST-L takes one frame per forward, because its mask attention comes
    from a batch's first frame. Every other method takes the frames as one
    batch: each frame's output depends on that frame alone (per-frame
    attention, instance statistics, BatchNorm from running statistics), so
    a batch equals its frames. A batch is not always faster per frame:
    cuDNN picks each convolution's algorithm by the shape, and for SGN's
    batch of four 272x480 frames it took an FFT path six times slower per
    frame, so SGN runs its batch frame by frame (``models/sgn.py``).
    ``plain`` runs the plain versions of the port's kernels in MST++ and
    MST-L; the other methods are plain PyTorch throughout."""
    if input_encoding is None:
        input_encoding = "srgb" if pretrained_path is not None else "linear"
    if input_encoding not in ("linear", "srgb"):
        raise ValueError(f"input_encoding must be 'linear' or 'srgb', got {input_encoding!r}")
    if module is None:
        module = model_generator(method, pretrained_path, device)
    elif pretrained_path is not None:
        module.load_state_dict(load_state(pretrained_path))
    per_frame = isinstance(module, MSTModel)

    def provider(frames: torch.Tensor, plain: bool = False) -> torch.Tensor:
        x = torch.clamp(frames.to(torch.float32), 0.0, 1.0)
        if input_encoding == "srgb":
            x = color.linear_to_srgb(x)
        x = x.reshape(-1, *x.shape[-3:])
        with torch.no_grad():
            if per_frame:
                cube = torch.cat([module(x[i:i + 1], plain=plain) for i in range(x.shape[0])])
            else:
                cube = module(x, plain=plain)
        return torch.clamp(cube, min=0.0).reshape(*frames.shape[:-1], cube.shape[-1])

    return provider


def attach_mst(animal, module: MSTPlusPlus | None = None, pretrained_path=None):
    """Attach an MST++ provider (on the animal's device when ``module`` is
    None) and its 31-band grid to a UV animal."""
    provider = make_mst_hsi_provider(module, pretrained_path, device=animal.device)
    return animal.use_hsi_provider(provider, lambdas=MST_LAMBDAS)


def attach_model(animal, method: str, pretrained_path=None):
    """Attach the zoo's ``method`` (any of ``zoo.available_models()``) on
    the animal's device as its HSI provider, with its 31-band grid: the
    weights of ``pretrained_path``, or seeded ones without it (the
    repository ships trained weights for MST++ alone)."""
    provider = make_mst_hsi_provider(pretrained_path=pretrained_path, device=animal.device, method=method)
    return animal.use_hsi_provider(provider, lambdas=MST_LAMBDAS)
