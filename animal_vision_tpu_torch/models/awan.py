"""AWAN, the adaptive weighted attention network.

Counterpart of ``animal_vision_tpu/models/awan.py``, the registry's
``"awan"``: ``AWAN(n_drbs=8)``, 96 channels. Reflection-padded
convolutions without bias, scalar PReLUs, 8 dual residual attention blocks
(DRAB: a 3x3 pair, a 5x5 up-convolution with a running residual, AWCA
attention: a softmax pixel mask pools the channels into a squeeze-excite
gate) and the PSNL tail: a second-order non-local block run on each
quadrant of the frame apart (``awan.py:88-124``). On a quadrant of n
pixels the non-local block forms an n x n score matrix, the pixels' 3
projected channels minus their mean against themselves, and softmaxes it
over the last axis: at 4 frames of 272x480 that is 4 x 32640^2 floats,
17 GB per quadrant, and its softmax as much again; at 1080p it would be
1.07 TB, so full-HD frames go through ``models/tiling.py:predict_tiled``.
No padding: any frame size of at least 2x2 pixels per quadrant runs.
State layout: the reference names the JAX ``convert_torch_state`` reads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from animal_vision_tpu_torch.models.common import ZooNet, jax_conv_into, jax_dense_into, jax_vec_into

_DRAB_CONVS = ("conv1", "conv2", "up_conv", "down_conv")
_DRAB_PRELUS = ("relu1", "relu2", "up_relu", "down_relu")


class RefConv(nn.Module):
    """A convolution after torch's ReflectionPad2d (reflect-101)."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.pad = k // 2
        self.conv2d = nn.Conv2d(cin, cout, k, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.pad
        return self.conv2d(F.pad(x, (p, p, p, p), mode="reflect") if p else x)


class AWCA(nn.Module):
    def __init__(self, channel: int, reduction: int = 16):
        super().__init__()
        self.conv = nn.Conv2d(channel, 1, 1, bias=False)
        self.fc = nn.Sequential(nn.Linear(channel, channel // reduction, bias=False), nn.PReLU(),
                                nn.Linear(channel // reduction, channel, bias=False), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        mask = torch.softmax(self.conv(x).reshape(b, h * w, 1), dim=1)
        y = torch.matmul(x.reshape(b, c, h * w), mask).reshape(b, c)
        return x * self.fc(y).reshape(b, c, 1, 1)


class DRAB(nn.Module):
    def __init__(self, dim: int, res_dim: int, k1: int = 5, k2: int = 3):
        super().__init__()
        self.conv1 = RefConv(dim, dim, 3)
        self.relu1 = nn.PReLU()
        self.conv2 = RefConv(dim, dim, 3)
        self.relu2 = nn.PReLU()
        self.up_conv = RefConv(dim, res_dim, k1)
        self.up_relu = nn.PReLU()
        self.se = AWCA(res_dim)
        self.down_conv = RefConv(res_dim, dim, k2)
        self.down_relu = nn.PReLU()

    def forward(self, x: torch.Tensor, res: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x_r = x
        x = self.relu2(self.conv2(self.relu1(self.conv1(x))) + x_r)
        res = self.up_relu(self.up_conv(x) + res)
        x = self.down_relu(self.down_conv(self.se(res)) + x_r)
        return x, res


class NonLocal(nn.Module):
    """NONLocalBlock2D with second-order (covariance) attention."""

    def __init__(self, cin: int, reduction: int = 8):
        super().__init__()
        inter = cin // reduction
        self.g = nn.Conv2d(cin, inter, 1, bias=False)
        self.theta = nn.Conv2d(cin, inter, 1, bias=False)
        self.W = nn.Conv2d(inter, cin, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        g = self.g(x).flatten(2).transpose(1, 2)  # (b, n, inter)
        theta = self.theta(x).flatten(2).transpose(1, 2)  # (b, n, inter)
        m = theta.shape[-1]
        # count_cov_second: (theta - its mean over the channels) theta^T / inter
        f = torch.matmul(theta - theta.mean(dim=2, keepdim=True), theta.transpose(1, 2)) / m
        f = torch.softmax(f, dim=-1)
        y = torch.matmul(f, g).transpose(1, 2).reshape(b, m, h, w)
        return self.W(y) + x


class PSNL(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.non_local = NonLocal(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h1, w1 = x.shape[2] // 2, x.shape[3] // 2
        nl = self.non_local
        top = torch.cat([nl(x[:, :, :h1, :w1]), nl(x[:, :, :h1, w1:])], dim=3)
        bot = torch.cat([nl(x[:, :, h1:, :w1]), nl(x[:, :, h1:, w1:])], dim=3)
        return torch.cat([top, bot], dim=2)


class AWAN(ZooNet):
    def __init__(self, inplanes: int = 3, planes: int = 31, channels: int = 96, n_drbs: int = 8):
        super().__init__()
        self.input_conv2D = RefConv(inplanes, channels, 3)
        self.input_prelu2D = nn.PReLU()
        self.head_conv2D = RefConv(channels, channels, 3)
        self.backbone = nn.ModuleList(DRAB(channels, channels) for _ in range(n_drbs))
        self.tail_conv2D = RefConv(channels, channels, 3)
        self.output_prelu2D = nn.PReLU()
        self.output_conv2D = RefConv(channels, planes, 3)
        self.tail_nonlocal = PSNL(planes)

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        out = self.head_conv2D(self.input_prelu2D(self.input_conv2D(x)))
        residual = res = out
        for drab in self.backbone:
            out, res = drab(out, res)
        out = self.tail_conv2D(out) + residual
        return self.tail_nonlocal(self.output_conv2D(self.output_prelu2D(out)))


def from_jax_params(params) -> dict[str, torch.Tensor]:
    """The inverse of the JAX ``convert_torch_state``."""
    sd: dict[str, torch.Tensor] = {}
    for name in ("input_conv2D", "head_conv2D", "tail_conv2D", "output_conv2D"):
        jax_conv_into(sd, f"{name}.conv2d", params[name]["conv2d"])
    for name in ("input_prelu2D", "output_prelu2D"):
        jax_vec_into(sd, f"{name}.weight", params[name]["weight"])
    i = 0
    while f"backbone_{i}" in params:
        q, key = params[f"backbone_{i}"], f"backbone.{i}"
        for name in _DRAB_CONVS:
            jax_conv_into(sd, f"{key}.{name}.conv2d", q[name]["conv2d"])
        for name in _DRAB_PRELUS:
            jax_vec_into(sd, f"{key}.{name}.weight", q[name]["weight"])
        jax_conv_into(sd, f"{key}.se.conv", q["se"]["conv"])
        jax_dense_into(sd, f"{key}.se.fc.0", q["se"]["fc_0"])
        jax_vec_into(sd, f"{key}.se.fc.1.weight", q["se"]["fc_prelu"]["weight"])
        jax_dense_into(sd, f"{key}.se.fc.2", q["se"]["fc_2"])
        i += 1
    for name in ("g", "theta", "W"):
        jax_conv_into(sd, f"tail_nonlocal.non_local.{name}", params["tail_nonlocal"]["non_local"][name])
    return sd
