"""HSCNN+ and EDSR, the zoo's plain convolution stacks.

Counterparts of ``animal_vision_tpu/models/simple_nets.py``: ``HSCNNPlus``
(the registry's ``"hscnn_plus"``: 30 densely fused ``dfus`` blocks, each
appending 32 channels to the features, no biases) and ``EDSR``
(``"edsr"``: 32 residual blocks of 64 features, biases). State layout: the
reference names the JAX ``convert_hscnn_state`` and ``convert_edsr_state``
read (``ddfn.dfus_blocks.i.conv1``, ``body.i.body.0``, ...);
``hscnn_from_jax_params`` and ``edsr_from_jax_params`` are their inverses.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from animal_vision_tpu_torch.models.common import ZooNet, conv, jax_conv_into

_DFUS = ("conv1", "conv_up1", "conv_up2", "conv_down1", "conv_down2", "conv_fution")


class DfusBlock(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.conv1 = conv(cin, 128, 1)
        self.conv_up1 = conv(128, 32, 3)
        self.conv_up2 = conv(32, 16, 1)
        self.conv_down1 = conv(128, 32, 3)
        self.conv_down2 = conv(32, 16, 1)
        self.conv_fution = conv(96, 32, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = F.relu(self.conv1(x))
        up1 = F.relu(self.conv_up1(feat))
        up2 = F.relu(self.conv_up2(up1))
        dn1 = F.relu(self.conv_down1(feat))
        dn2 = F.relu(self.conv_down2(dn1))
        fus = F.relu(self.conv_fution(torch.cat([up1, up2, dn1, dn2], dim=1)))
        return torch.cat([x, fus], dim=1)


class DDFN(nn.Module):
    def __init__(self, cin: int, num_blocks: int):
        super().__init__()
        self.conv_up1 = conv(cin, 32, 3)
        self.conv_up2 = conv(32, 32, 1)
        self.conv_down1 = conv(cin, 32, 3)
        self.conv_down2 = conv(32, 32, 1)
        self.dfus_blocks = nn.ModuleList(DfusBlock(128 + 32 * i) for i in range(num_blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up1 = F.relu(self.conv_up1(x))
        up2 = F.relu(self.conv_up2(up1))
        dn1 = F.relu(self.conv_down1(x))
        dn2 = F.relu(self.conv_down2(dn1))
        fea = torch.cat([up1, up2, dn1, dn2], dim=1)
        for blk in self.dfus_blocks:
            fea = blk(fea)
        return fea


class HSCNNPlus(ZooNet):
    def __init__(self, in_channels: int = 3, out_channels: int = 31, num_blocks: int = 30):
        super().__init__()
        self.ddfn = DDFN(in_channels, num_blocks)
        self.conv_out = conv(128 + 32 * num_blocks, out_channels, 1)

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_out(self.ddfn(x))


class ResBlock(nn.Module):
    def __init__(self, n_feats: int):
        super().__init__()
        self.body = nn.Sequential(conv(n_feats, n_feats, 3, bias=True), nn.ReLU(), conv(n_feats, n_feats, 3, bias=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.body(x)


class EDSR(ZooNet):
    def __init__(self, n_resblocks: int = 32, n_feats: int = 64, out_channels: int = 31):
        super().__init__()
        self.head = nn.Sequential(conv(3, n_feats, 3, bias=True))
        self.body = nn.Sequential(*(ResBlock(n_feats) for _ in range(n_resblocks)),
                                  conv(n_feats, n_feats, 3, bias=True))
        self.tail = nn.Sequential(conv(n_feats, out_channels, 3, bias=True))

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        x = self.head(x)
        return self.tail(self.body(x) + x)


def hscnn_from_jax_params(params) -> dict[str, torch.Tensor]:
    """The inverse of the JAX ``convert_hscnn_state``."""
    sd: dict[str, torch.Tensor] = {}
    for name in ("conv_up1", "conv_up2", "conv_down1", "conv_down2"):
        jax_conv_into(sd, f"ddfn.{name}", params[name])
    for i in range(sum(1 for k in params if k.startswith("dfus_"))):
        for name in _DFUS:
            jax_conv_into(sd, f"ddfn.dfus_blocks.{i}.{name}", params[f"dfus_{i}"][name])
    jax_conv_into(sd, "conv_out", params["conv_out"])
    return sd


def edsr_from_jax_params(params) -> dict[str, torch.Tensor]:
    """The inverse of the JAX ``convert_edsr_state``."""
    sd: dict[str, torch.Tensor] = {}
    n = sum(1 for k in params if k.endswith("_0") and k.startswith("rb"))
    jax_conv_into(sd, "head.0", params["head"])
    for i in range(n):
        jax_conv_into(sd, f"body.{i}.body.0", params[f"rb{i}_0"])
        jax_conv_into(sd, f"body.{i}.body.2", params[f"rb{i}_1"])
    jax_conv_into(sd, f"body.{n}", params["body_tail"])
    jax_conv_into(sd, "tail.0", params["tail"])
    return sd
