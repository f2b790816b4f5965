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

from dataclasses import dataclass

import numpy as np
import torch

from animal_vision_tpu_torch.core import color
from animal_vision_tpu_torch.models.mst import MSTModel
from animal_vision_tpu_torch.models.mst_plus_plus import MSTPlusPlus, load_state
from animal_vision_tpu_torch.models.zoo import model_generator
from animal_vision_tpu_torch.ops import _build
from animal_vision_tpu_torch.utils.profiling import span

#: the zoo's band grid (31 bands, 400-700 nm, the ARAD_1K convention)
MST_LAMBDAS = np.linspace(400.0, 700.0, 31, dtype=np.float32)
#: the zoo's method names of the two MST models, for the ``model.forward``
#: span (any other module is named by its class)
_METHODS = {MSTModel: "mst", MSTPlusPlus: "mst_plus_plus"}


@dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    x: torch.Tensor
    y: torch.Tensor
    weights: dict  # the prepared weights the graph reads, kept alive with it
    launches: dict  # the launches one replay makes, per key of ``_build.LAUNCHES``


class _FrameGraphs:
    """MST-L's forward of one frame on the card, replayed from a CUDA graph
    per frame shape. A forward is about 1500 host operations (27 blocks of
    mask branch, stats, matrix, masked pos and FFN launches), so dispatch
    took longer than the card's work; a replay launches the same kernels
    in one call. The first frame of a shape runs the module (which builds
    and loads the kernels, prepares the weights and lets cuDNN pick its
    algorithms), then the forward is captured; the capture runs nothing,
    and each replay adds the captured launches to the counters. A change
    of the prepared weights (``load_state_dict``, a move) captures anew."""

    def __init__(self, module: MSTModel):
        self.module = module
        self.graphs: dict = {}

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        fw = self.module.weights(x.device)
        key = (tuple(x.shape), x.dtype, x.device)
        g = self.graphs.get(key)
        if g is None or g.weights is not fw:
            y = self.module(x)
            self.graphs[key] = self._capture(x, fw)
            return y
        g.x.copy_(x)
        g.graph.replay()
        for k, v in g.launches.items():
            _build.LAUNCHES[k] += v
        return g.y.clone()

    def _capture(self, x: torch.Tensor, fw: dict) -> _Graph:
        before = dict(_build.LAUNCHES)
        static_x = x.clone()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            static_y = self.module(static_x)
        launches = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
        _build.LAUNCHES.update(before)
        return _Graph(graph, static_x, static_y, fw, launches)


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
    MST-L; the other methods are plain PyTorch throughout. On the card
    (not ``plain``), MST-L replays a CUDA graph per frame shape
    (``_FrameGraphs``). Each forward of the module is a ``model.forward``
    span (method, frames, h, w): one per frame for MST-L, one per batch
    for the others."""
    if input_encoding is None:
        input_encoding = "srgb" if pretrained_path is not None else "linear"
    if input_encoding not in ("linear", "srgb"):
        raise ValueError(f"input_encoding must be 'linear' or 'srgb', got {input_encoding!r}")
    if module is None:
        module = model_generator(method, pretrained_path, device)
    elif pretrained_path is not None:
        module.load_state_dict(load_state(pretrained_path))
    per_frame = isinstance(module, MSTModel)
    graphs = _FrameGraphs(module) if per_frame else None
    name = _METHODS.get(type(module), type(module).__name__)

    def forward(x: torch.Tensor, plain: bool) -> torch.Tensor:
        with span("model.forward", method=name, frames=x.shape[0], h=x.shape[1], w=x.shape[2]):
            if graphs is not None and x.is_cuda and not plain:
                return graphs(x)
            return module(x, plain=plain)

    def provider(frames: torch.Tensor, plain: bool = False) -> torch.Tensor:
        x = torch.clamp(frames.to(torch.float32), 0.0, 1.0)
        if input_encoding == "srgb":
            x = color.linear_to_srgb(x)
        x = x.reshape(-1, *x.shape[-3:])
        with torch.no_grad():
            if per_frame:
                cube = torch.cat([forward(x[i:i + 1], plain) for i in range(x.shape[0])])
            else:
                cube = forward(x, plain)
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
