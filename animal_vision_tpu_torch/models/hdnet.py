"""HDNet: a residual body around spatial-spectral attention and a
frequency-guided split.

Counterpart of ``animal_vision_tpu/models/hdnet.py``, the registry's
``"hdnet"``: ``HDNet()`` with the defaults, 48 features. A 3x3 head, 32
residual blocks, the SDL attention (a spectral mask from the global mean
of one projection over the pixels of another, plus a spatial channel gate,
summed), the EFF block (four channel groups, each through a depthwise 1x1
convolution with BatchNorm, a 3x3 max pool, a 1x1 collapse to one channel
with BatchNorm and a softmax gate over the pixels), 31 more residual
blocks, a body-end convolution with the global residual, and a 3x3 tail
to 31 channels. No padding: any frame size runs.

Reference quirk kept: the BatchNorms run in inference mode from their
running statistics (``InferenceBN``, ``hdnet.py:23``); the port's modules
are ``nn.BatchNorm2d`` (the reference's names, ``running_mean``,
``running_var`` and ``num_batches_tracked`` included), and ``forward``
normalises with the running statistics whatever ``training`` says. State
layout: the reference names the JAX ``convert_torch_state`` reads
(``body.32`` the SDL attention, ``body.33.subspaces.i`` the EFF groups).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from animal_vision_tpu_torch.models.common import ZooNet, conv, jax_conv_into, jax_vec_into
from animal_vision_tpu_torch.models.mst_plus_plus import _jax_t

_SDL = ("conv_q_right", "conv_v_right", "conv_up", "conv_q_left", "conv_v_left")


def _bn(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Inference BatchNorm: the running statistics, in any mode."""
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0, bn.eps)


class ResBlock(nn.Module):
    def __init__(self, n_feat: int):
        super().__init__()
        self.body = nn.Sequential(conv(n_feat, n_feat, 3, bias=True), nn.ReLU(), conv(n_feat, n_feat, 3, bias=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x) + x


class DSC(nn.Module):
    """One EFF group: depthwise 1x1 + BN + ReLU, 3x3 max pool, 1x1 to one
    channel + BN + ReLU, a softmax over the pixels, then x * gate + x."""

    def __init__(self, nin: int):
        super().__init__()
        self.conv_dws = conv(nin, nin, 1, bias=True, groups=nin)
        self.bn_dws = nn.BatchNorm2d(nin)
        self.conv_point = conv(nin, 1, 1, bias=True)
        self.bn_point = nn.BatchNorm2d(1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, h, w = x.shape
        out = F.relu(_bn(self.conv_dws(x), self.bn_dws))
        out = F.max_pool2d(out, 3, 1, 1)
        out = F.relu(_bn(self.conv_point(out), self.bn_point))
        gate = torch.softmax(out.reshape(b, 1, h * w), dim=-1).reshape(b, 1, h, w)
        return gate * x + x


class EFF(nn.Module):
    def __init__(self, nin: int, num_splits: int = 4):
        super().__init__()
        self.subspaces = nn.ModuleList(DSC(nin // num_splits) for _ in range(num_splits))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        parts = x.chunk(len(self.subspaces), dim=1)
        return torch.cat([sub(p) for sub, p in zip(self.subspaces, parts)], dim=1)


class SDL(nn.Module):
    def __init__(self, planes: int):
        super().__init__()
        inter = planes // 2
        self.conv_q_right = conv(planes, 1, 1)
        self.conv_v_right = conv(planes, inter, 1)
        self.conv_up = conv(inter, planes, 1)
        self.conv_q_left = conv(planes, inter, 1)
        self.conv_v_left = conv(planes, inter, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        # spectral: the mean of q_left over the pixels against v_left per pixel
        avg = self.conv_q_left(x).mean(dim=(2, 3))  # (b, inter)
        theta = self.conv_v_left(x).flatten(2)  # (b, inter, hw)
        ctx = torch.matmul(avg.unsqueeze(1), theta)  # (b, 1, hw)
        spectral = x * torch.sigmoid(torch.softmax(ctx, dim=-1)).reshape(b, 1, h, w)
        # spatial: a softmax pixel mask pools v_right into a channel gate
        v = self.conv_v_right(x).flatten(2)  # (b, inter, hw)
        q = torch.softmax(self.conv_q_right(x).flatten(2), dim=-1)  # (b, 1, hw)
        ctx_ch = torch.matmul(v, q.transpose(1, 2)).unsqueeze(-1)  # (b, inter, 1, 1)
        return x * torch.sigmoid(self.conv_up(ctx_ch)) + spectral


class HDNet(ZooNet):
    def __init__(self, in_ch: int = 3, out_ch: int = 31, n_feats: int = 48, n_resblocks: int = 32):
        super().__init__()
        self.head = nn.Sequential(conv(in_ch, n_feats, 3, bias=True))
        self.body = nn.Sequential(*(ResBlock(n_feats) for _ in range(n_resblocks)), SDL(n_feats), EFF(n_feats),
                                  *(ResBlock(n_feats) for _ in range(n_resblocks - 1)),
                                  conv(n_feats, n_feats, 3, bias=True))
        self.tail = nn.Sequential(conv(n_feats, out_ch, 3, bias=True))

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        x = self.head(x)
        return self.tail(self.body(x) + x)


def from_jax_params(params) -> dict[str, torch.Tensor]:
    """The inverse of the JAX ``convert_torch_state``; each BatchNorm's
    ``num_batches_tracked`` is 0 (the JAX tree does not hold it)."""
    sd: dict[str, torch.Tensor] = {}
    n = sum(1 for k in params if k.startswith("body_") and k != "body_tail")
    n_res = (n + 1) // 2
    jax_conv_into(sd, "head.0", params["head"])
    for i in range(n):
        key = f"body.{i if i < n_res else i + 2}"
        jax_conv_into(sd, f"{key}.body.0", params[f"body_{i}"]["conv0"])
        jax_conv_into(sd, f"{key}.body.2", params[f"body_{i}"]["conv1"])
    for name in _SDL:
        jax_conv_into(sd, f"body.{n_res}.{name}", params["sdl"][name])
    for i in range(4):
        q, key = params["eff"][f"sub_{i}"], f"body.{n_res + 1}.subspaces.{i}"
        sd[f"{key}.conv_dws.weight"] = _jax_t(q["conv_dws"]["kernel"]).reshape(-1, 1, 1, 1)
        jax_vec_into(sd, f"{key}.conv_dws.bias", q["conv_dws"]["bias"])
        jax_conv_into(sd, f"{key}.conv_point", q["conv_point"])
        for bn in ("bn_dws", "bn_point"):
            jax_vec_into(sd, f"{key}.{bn}.weight", q[bn]["scale"])
            jax_vec_into(sd, f"{key}.{bn}.bias", q[bn]["bias"])
            jax_vec_into(sd, f"{key}.{bn}.running_mean", q[bn]["mean"])
            jax_vec_into(sd, f"{key}.{bn}.running_var", q[bn]["var"])
            sd[f"{key}.{bn}.num_batches_tracked"] = torch.tensor(0)
    jax_conv_into(sd, f"body.{n + 2}", params["body_tail"])
    jax_conv_into(sd, "tail.0", params["tail"])
    return sd
