"""SGN, the self-guided network (the registry's ``"hrnet"``).

Counterpart of ``animal_vision_tpu/models/sgn.py``: ``SGN()`` with the
defaults, 64 start channels. Three pixel-unshuffled guidance branches (x8,
x4, x2) each feed the next finer one through a pixel shuffle, down to the
full-resolution main stream; residual dense blocks (five dense
convolutions, residual scaled by 0.1); LeakyReLU(0.2) after every
convolution. The frame is reflect-padded to multiples of 8 and the output
cropped.

Reference quirks kept (``sgn.py:7-12``):
- ``GlobalBlock`` computes a squeeze-excite gate and then overwrites it
  with ``conv2(x)``, so it returns ``residual + 0.1 conv2(conv1(x))`` and
  its ``fc`` weights are dead: the port holds none, drops a reference
  state dict's ``fc`` entries on load, and the JAX converter skips them
  (``sgn.py:74-85``, ``:136-147``);
- the last convolution (``main4``) is LeakyReLU'd too, so the output
  cannot go below 0.2 times its most negative pre-activation
  (``sgn.py:132``).
State layout: the reference names the JAX ``convert_torch_state`` reads
(``top1.conv2d``, ``top21.conv1.conv2d``, ...).

A batch runs one frame at a time (``forward_nchw``): for a batch of four
272x480 frames cuDNN takes its FFT path for these convolutions, and
kestrel with SGN ran 5.40 fps batched against 32.91 fps one frame per
call (NVIDIA H100 80GB HBM3 at 700 W, ``chip_smoke.py`` ``zoo_phase``).
A frame's output depends on that frame alone, so the result is the same.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from animal_vision_tpu_torch.models.common import ZooNet, conv, jax_conv_into

_LAYERS = ("top1", "top3", "mid1", "mid2", "mid4", "bot1", "bot2", "bot4", "main1", "main2", "main4")
_RDBS = ("top21", "mid31", "bot31", "bot32", "main31", "main32", "main33", "main34")
_GLOBALS = ("top22", "mid32", "bot33", "main35")


class ConvLayer(nn.Module):
    """Conv2dLayer: a zero-padded convolution with bias, then
    LeakyReLU(0.2)."""

    def __init__(self, cin: int, cout: int, k: int = 3):
        super().__init__()
        self.conv2d = conv(cin, cout, k, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(self.conv2d(x), 0.2)


class RDB5C(nn.Module):
    def __init__(self, cin: int, latent: int):
        super().__init__()
        for i in range(4):
            setattr(self, f"conv{i + 1}", ConvLayer(cin + i * latent, latent))
        self.conv5 = ConvLayer(cin + 4 * latent, cin)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        for i in range(4):
            feats.append(getattr(self, f"conv{i + 1}")(torch.cat(feats, dim=1)))
        return 0.1 * self.conv5(torch.cat(feats, dim=1)) + x


class GlobalBlock(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.conv1 = ConvLayer(cin, cin)
        self.conv2 = ConvLayer(cin, cin)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for key in [k for k in state_dict if k.startswith(prefix + "fc.")]:
            del state_dict[key]  # the overwritten squeeze-excite gate's weights
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return 0.1 * self.conv2(self.conv1(x)) + x


class SGN(ZooNet):
    PAD = 8

    def __init__(self, in_channels: int = 3, out_channels: int = 31, start_channels: int = 64):
        super().__init__()
        s, c = start_channels, in_channels
        self.top1 = ConvLayer(c * 64, s * 8)
        self.top21 = RDB5C(s * 8, s * 4)
        self.top22 = GlobalBlock(s * 8)
        self.top3 = ConvLayer(s * 8, s * 8, 1)
        self.mid1 = ConvLayer(c * 16, s * 4)
        self.mid2 = ConvLayer(s * 4 + s * 2, s * 4)
        self.mid31 = RDB5C(s * 4, s * 2)
        self.mid32 = GlobalBlock(s * 4)
        self.mid4 = ConvLayer(s * 4, s * 4)
        self.bot1 = ConvLayer(c * 4, s * 2)
        self.bot2 = ConvLayer(s * 2 + s, s * 2)
        self.bot31 = RDB5C(s * 2, s)
        self.bot32 = RDB5C(s * 2, s)
        self.bot33 = GlobalBlock(s * 2)
        self.bot4 = ConvLayer(s * 2, s * 2)
        self.main1 = ConvLayer(c, s)
        self.main2 = ConvLayer(s + s // 2, s)
        for i in range(1, 5):
            setattr(self, f"main3{i}", RDB5C(s, s // 2))
        self.main35 = GlobalBlock(s)
        self.main4 = ConvLayer(s, out_channels)

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.forward_frame(x[i:i + 1]) for i in range(x.shape[0])])

    def forward_frame(self, x: torch.Tensor) -> torch.Tensor:
        x3 = self.top3(self.top22(self.top21(self.top1(F.pixel_unshuffle(x, 8)))))
        x2 = self.mid1(F.pixel_unshuffle(x, 4))
        x2 = self.mid2(torch.cat([x2, F.pixel_shuffle(x3, 2)], dim=1))
        x2 = self.mid4(self.mid32(self.mid31(x2)))
        x1 = self.bot1(F.pixel_unshuffle(x, 2))
        x1 = self.bot2(torch.cat([x1, F.pixel_shuffle(x2, 2)], dim=1))
        x1 = self.bot4(self.bot33(self.bot32(self.bot31(x1))))
        y = self.main2(torch.cat([self.main1(x), F.pixel_shuffle(x1, 2)], dim=1))
        for i in range(1, 5):
            y = getattr(self, f"main3{i}")(y)
        return self.main4(self.main35(y))


def from_jax_params(params) -> dict[str, torch.Tensor]:
    """The inverse of the JAX ``convert_torch_state``."""
    sd: dict[str, torch.Tensor] = {}
    for name in _LAYERS:
        jax_conv_into(sd, f"{name}.conv2d", params[name]["conv2d"])
    for name in _RDBS:
        for i in range(1, 6):
            jax_conv_into(sd, f"{name}.conv{i}.conv2d", params[name][f"conv{i}"]["conv2d"])
    for name in _GLOBALS:
        for i in (1, 2):
            jax_conv_into(sd, f"{name}.conv{i}.conv2d", params[name][f"conv{i}"]["conv2d"])
    return sd
