"""MIRNet: multi-scale residual blocks over a 3-row pyramid.

Counterpart of ``animal_vision_tpu/models/mirnet.py``, the registry's
``"mirnet"``: ``MIRNet(n_rrg=3, n_msrb=1, height=3, width=1)``, 31
features. Each MSRB runs a dual-attention unit (DAU: spatial max/mean
gate and channel squeeze-excite) on each row of the pyramid, the rows
joined by anti-aliased downsamples (a fixed [1, 2, 1] binomial blur,
stride 2) and residual upsamples (a 3x3 stride-2 transposed convolution
beside a bilinear skip), and fuses them by selective-kernel fusion
(SKFF: a softmax over the rows). The frame is reflect-padded to multiples
of 8 and the output cropped (``mirnet.py:268-270``, ``:277``).

Reference quirks kept (``mirnet.py:7-12``):
- every DAU shares one ``nn.PReLU`` (the reference's mutable default
  argument ``act=nn.PReLU()`` is one object): here one per network, named
  under every DAU (``....body.1.weight``) as the reference's state dict
  names it; ``from_jax_params`` raises if the JAX copies differ;
- each MSRB row holds one DAU (the reference's ``[DAU] * width`` aliases one
  instance); at the registry's width 1 the mesh columns are a single chain;
- the bilinear skip has ``align_corners=False``.
State layout: the reference names the JAX ``convert_torch_state`` reads.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from animal_vision_tpu_torch.models.common import ZooNet, conv, jax_conv_into, jax_vec_into, shared_value
from animal_vision_tpu_torch.models.mst_plus_plus import _jax_t


class Downsamp(nn.Module):
    """downsamp(filt_size=3, stride=2): reflect pad 1, the depthwise
    [1, 2, 1] binomial blur (the reference's ``filt`` buffer), every second
    pixel."""

    def __init__(self, channels: int):
        super().__init__()
        a = torch.tensor([1.0, 2.0, 1.0])
        self.register_buffer("filt", (a[:, None] * a[None, :] / 16.0).repeat(channels, 1, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), self.filt, stride=2, groups=x.shape[1])


class ResidualDownSample(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.top = nn.Sequential(conv(cin, cin, 1), nn.PReLU(), conv(cin, cin, 3), nn.PReLU(), Downsamp(cin),
                                 conv(cin, cin * 2, 1))
        self.bot = nn.Sequential(Downsamp(cin), conv(cin, cin * 2, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.top(x) + self.bot(x)


class ResidualUpSample(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.top = nn.Sequential(conv(cin, cin, 1), nn.PReLU(),
                                 nn.ConvTranspose2d(cin, cin, 3, 2, 1, output_padding=1, bias=False),
                                 nn.PReLU(), conv(cin, cin // 2, 1))
        self.bot = nn.Sequential(nn.Upsample(scale_factor=2, mode="bilinear", align_corners=False),
                                 conv(cin, cin // 2, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.top(x) + self.bot(x)


class Resampler(nn.Module):
    """log2(scale) residual down- or upsamples in a chain."""

    def __init__(self, cin: int, scale: int, up: bool):
        super().__init__()
        steps = []
        for _ in range(int(math.log2(scale))):
            steps.append(ResidualUpSample(cin) if up else ResidualDownSample(cin))
            cin = cin // 2 if up else cin * 2
        self.body = nn.Sequential(*steps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x)


class SpatialAttn(nn.Module):
    def __init__(self):
        super().__init__()
        self.spatial = nn.Module()
        self.spatial.conv = conv(2, 1, 5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = torch.cat([x.amax(dim=1, keepdim=True), x.mean(dim=1, keepdim=True)], dim=1)
        return x * torch.sigmoid(self.spatial.conv(pooled))


class ChannelAttn(nn.Module):
    def __init__(self, channel: int, reduction: int = 8):
        super().__init__()
        self.conv_du = nn.Sequential(conv(channel, channel // reduction, 1), nn.ReLU(),
                                     conv(channel // reduction, channel, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.conv_du(x.mean(dim=(2, 3), keepdim=True))


class DAU(nn.Module):
    def __init__(self, n_feat: int, act: nn.PReLU):
        super().__init__()
        self.body = nn.Sequential(conv(n_feat, n_feat, 3), act, conv(n_feat, n_feat, 3))
        self.SA = SpatialAttn()
        self.CA = ChannelAttn(n_feat)
        self.conv1x1 = conv(2 * n_feat, n_feat, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = self.body(x)
        return self.conv1x1(torch.cat([self.SA(res), self.CA(res)], dim=1)) + x


class SKFF(nn.Module):
    def __init__(self, cin: int, height: int = 3, reduction: int = 8):
        super().__init__()
        d = max(cin // reduction, 4)
        self.conv_du = nn.Sequential(conv(cin, d, 1), nn.PReLU())
        self.fcs = nn.ModuleList(conv(d, cin, 1) for _ in range(height))

    def forward(self, feats: list[torch.Tensor]) -> torch.Tensor:
        stacked = torch.stack(feats, dim=1)  # (b, height, c, h, w)
        z = self.conv_du(stacked.sum(dim=1).mean(dim=(2, 3), keepdim=True))
        attn = torch.softmax(torch.stack([fc(z) for fc in self.fcs], dim=1), dim=1)
        return (stacked * attn).sum(dim=1)


class MSRB(nn.Module):
    def __init__(self, n_feat: int, height: int, width: int, act: nn.PReLU, stride: int = 2):
        super().__init__()
        if width != 1:
            raise ValueError("the port runs MIRNet's registry width 1 only (a single chain per row)")
        self.height = height
        feats = [n_feat * stride ** i for i in range(height)]
        self.blocks = nn.ModuleList(nn.ModuleList([DAU(feats[j], act)]) for j in range(height))
        self.down = nn.ModuleDict({f"{feats[j]}_2": Resampler(feats[j], 2, up=False) for j in range(height - 1)})
        self.last_up = nn.ModuleDict({str(k): Resampler(feats[k], 2 ** k, up=True) for k in range(1, height)})
        self.selective_kernel = nn.ModuleList(SKFF(feats[j], height) for j in range(height))
        self.conv_out = conv(n_feat, n_feat, 3)
        self.feats = feats

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        # the reference also builds the mesh columns' resamplers (``down.31_4``,
        # ``up.*``), which a width-1 MSRB never runs and the JAX converter skips
        for key in [k for k in state_dict if k.startswith(prefix + "up.") or (
                k.startswith(prefix + "down.") and k[len(prefix) + 5:].split(".")[0] not in self.down)]:
            del state_dict[key]
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inp, rows = x, []
        for j in range(self.height):
            if j:
                inp = self.down[f"{self.feats[j - 1]}_2"](inp)
            inp = self.blocks[j][0](inp)
            rows.append(inp)
        out = [rows[0]] + [self.last_up[str(k)](rows[k]) for k in range(1, self.height)]
        return self.conv_out(self.selective_kernel[0](out)) + x


class RRG(nn.Module):
    def __init__(self, n_feat: int, n_msrb: int, height: int, width: int, act: nn.PReLU):
        super().__init__()
        self.body = nn.Sequential(*(MSRB(n_feat, height, width, act) for _ in range(n_msrb)), conv(n_feat, n_feat, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x) + x


class MIRNet(ZooNet):
    PAD = 8

    def idle_keys(self) -> list[str]:
        """Each MSRB's SKFFs of rows 1 and 2: the reference builds one per
        row and the JAX converter reads them, but a width-1 MSRB fuses only
        through row 0's, so the JAX module never creates them."""
        return [k for k, _ in self.named_parameters() if ".selective_kernel." in k
                and ".selective_kernel.0." not in k]

    def __init__(self, in_channels: int = 3, out_channels: int = 31, n_feat: int = 31, n_rrg: int = 3,
                 n_msrb: int = 1, height: int = 3, width: int = 1):
        super().__init__()
        act = nn.PReLU()
        self.conv_in = conv(in_channels, n_feat, 3)
        self.body = nn.Sequential(*(RRG(n_feat, n_msrb, height, width, act) for _ in range(n_rrg)))
        self.conv_out = conv(n_feat, out_channels, 3)

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        return self.conv_out(self.body(x)) + x


def from_jax_params(params) -> dict[str, torch.Tensor]:
    """The inverse of the JAX ``convert_torch_state``: each transposed
    convolution's flipped HWIO kernel back to (in, out, 3, 3); every DAU's
    PReLU slope under its own key, all equal (one shared module). A tree
    made by the JAX ``init`` holds no idle SKFFs (``MIRNet.idle_keys``):
    their weights come out as zeros, which the forward never reads. The
    blur-pools' fixed ``filt`` buffers are the binomial filter."""
    sd: dict[str, torch.Tensor] = {}

    def prelu(key, q):
        jax_vec_into(sd, f"{key}.weight", q["weight"])

    def resampler(key, q, up):
        for i in range(len(q)):
            p, s = f"{key}.body.{i}", q[f"body_{i}"]
            jax_conv_into(sd, f"{p}.top.0", s["top_0"])
            prelu(f"{p}.top.1", s["top_1"])
            prelu(f"{p}.top.3", s["top_3"])
            jax_conv_into(sd, f"{p}.bot.1", s["bot_1"])
            if up:
                k = np.asarray(s["top_2"]["kernel"])  # (3, 3, in, out), flipped
                sd[f"{p}.top.2.weight"] = _jax_t(np.transpose(k, (2, 3, 0, 1))[:, :, ::-1, ::-1])
                jax_conv_into(sd, f"{p}.top.4", s["top_4"])
            else:
                jax_conv_into(sd, f"{p}.top.2", s["top_2"])
                jax_conv_into(sd, f"{p}.top.5", s["top_5"])
                filt = Downsamp(np.asarray(s["top_0"]["kernel"]).shape[-1]).filt
                sd[f"{p}.top.4.filt"] = filt
                sd[f"{p}.bot.0.filt"] = filt.clone()

    def msrb(key, q):
        jax_conv_into(sd, f"{key}.conv_out", q["conv_out"])
        height = sum(1 for k in q if k.startswith("dau_"))
        for j in range(height):
            d, p = q[f"dau_{j}"], f"{key}.blocks.{j}.0"
            jax_conv_into(sd, f"{p}.body.0", d["body_0"])
            prelu(f"{p}.body.1", d["act"])
            jax_conv_into(sd, f"{p}.body.2", d["body_2"])
            jax_conv_into(sd, f"{p}.SA.spatial.conv", d["sa"]["spatial"])
            jax_conv_into(sd, f"{p}.CA.conv_du.0", d["ca"]["du_0"])
            jax_conv_into(sd, f"{p}.CA.conv_du.2", d["ca"]["du_2"])
            jax_conv_into(sd, f"{p}.conv1x1", d["conv1x1"])
            p = f"{key}.selective_kernel.{j}"
            if f"skff_{j}" not in q:  # an idle SKFF of a tree made by the JAX init
                n_feat = np.asarray(d["body_0"]["kernel"]).shape[-1]
                sd.update({f"{p}.{k}": torch.zeros_like(v) for k, v in SKFF(n_feat, height).state_dict().items()})
                continue
            s = q[f"skff_{j}"]
            jax_conv_into(sd, f"{p}.conv_du.0", s["du_0"])
            prelu(f"{p}.conv_du.1", s["du_1"])
            for i in range(height):
                jax_conv_into(sd, f"{p}.fcs.{i}", s[f"fc_{i}"])
        for name in q:
            if name.startswith("down_"):
                resampler(f"{key}.down.{name.removeprefix('down_')}", q[name], up=False)
            elif name.startswith("last_up_"):
                resampler(f"{key}.last_up.{name.removeprefix('last_up_')}", q[name], up=True)

    jax_conv_into(sd, "conv_in", params["conv_in"])
    jax_conv_into(sd, "conv_out", params["conv_out"])
    for r in range(sum(1 for k in params if k.startswith("rrg_"))):
        q = params[f"rrg_{r}"]
        n_msrb = sum(1 for k in q if k.startswith("msrb_"))
        for m in range(n_msrb):
            msrb(f"body.{r}.body.{m}", q[f"msrb_{m}"])
        jax_conv_into(sd, f"body.{r}.body.{n_msrb}", q["conv"])
    shared_value(sd, [k for k in sd if ".blocks." in k and k.endswith(".body.1.weight")])
    return sd
