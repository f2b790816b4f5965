"""HINet: two U-Nets of half-instance-normalised blocks joined by a
supervised attention module.

Counterpart of ``animal_vision_tpu/models/hinet.py``, the registry's
``"hinet"``: ``HINet(depth=4)`` at wf = 31. ``conv_in`` takes the frame to
31 channels; each stage is a 4-level U-Net whose down blocks normalise the
first ceil(C/2) channels with an affine InstanceNorm (the HIN trick) and use
LeakyReLU(0.2); stage 2 takes the SAM feature of stage 1 and its
cross-stage skips (CSFF); the output adds the 31-channel image back. The
frame is reflect-padded to multiples of 16 and the output cropped
(``hinet.py:74-76``). State layout: the reference names the JAX
``convert_torch_state`` reads (``down_path_1.i``, ``up_path_1.i.up``,
``skip_conv_1.i``, ``sam12.conv1``, ...), the up-convolutions as
``ConvTranspose2d(k=2, s=2)`` with one bias per output channel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from animal_vision_tpu_torch.models.common import ZooNet, conv, jax_conv_into, jax_vec_into
from animal_vision_tpu_torch.models.mst_plus_plus import _jax_t


class UNetConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int, downsample: bool, relu_slope: float, use_csff: bool = False,
                 use_hin: bool = False):
        super().__init__()
        self.relu_slope = relu_slope
        self.identity = conv(cin, cout, 1, bias=True)
        self.conv_1 = conv(cin, cout, 3, bias=True)
        self.conv_2 = conv(cout, cout, 3, bias=True)
        if use_csff:
            self.csff_enc = conv(cout, cout, 3, bias=True)
            self.csff_dec = conv(cout, cout, 3, bias=True)
        self.norm = nn.InstanceNorm2d((cout + 1) // 2, affine=True) if use_hin else None
        self.downsample = nn.Conv2d(cout, cout, 4, 2, 1, bias=False) if downsample else None

    def forward(self, x: torch.Tensor, enc=None, dec=None) -> torch.Tensor:
        out = self.conv_1(x)
        if self.norm is not None:
            half = self.norm.num_features
            out = torch.cat([self.norm(out[:, :half]), out[:, half:]], dim=1)
        out = F.leaky_relu(out, self.relu_slope)
        out = F.leaky_relu(self.conv_2(out), self.relu_slope)
        out = out + self.identity(x)
        if enc is not None:
            out = out + self.csff_enc(enc) + self.csff_dec(dec)
        return out


class UNetUpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, relu_slope: float):
        super().__init__()
        self.up = nn.ConvTranspose2d(cin, cout, 2, 2, bias=True)
        self.conv_block = UNetConvBlock(2 * cout, cout, False, relu_slope)

    def forward(self, x: torch.Tensor, bridge: torch.Tensor) -> torch.Tensor:
        return self.conv_block(torch.cat([self.up(x), bridge], dim=1))


class SAM(nn.Module):
    def __init__(self, n_feat: int):
        super().__init__()
        self.conv1 = conv(n_feat, n_feat, 3, bias=True)
        self.conv2 = conv(n_feat, n_feat, 3, bias=True)
        self.conv3 = conv(n_feat, n_feat, 3, bias=True)

    def forward(self, x: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
        img = self.conv2(x) + image
        return self.conv1(x) * torch.sigmoid(self.conv3(img)) + x


class HINet(ZooNet):
    PAD = 16

    def __init__(self, in_chn: int = 31, out_chn: int = 31, wf: int = 31, depth: int = 4, relu_slope: float = 0.2):
        super().__init__()
        self.conv_in = conv(3, in_chn, 3)
        self.conv_01 = conv(in_chn, wf, 3, bias=True)
        self.conv_02 = conv(in_chn, wf, 3, bias=True)
        self.down_path_1 = nn.ModuleList()
        self.down_path_2 = nn.ModuleList()
        prev = wf
        for i in range(depth):
            down = i + 1 < depth
            self.down_path_1.append(UNetConvBlock(prev, (2 ** i) * wf, down, relu_slope, use_hin=True))
            self.down_path_2.append(UNetConvBlock(prev, (2 ** i) * wf, down, relu_slope, use_csff=down, use_hin=True))
            prev = (2 ** i) * wf
        self.up_path_1 = nn.ModuleList()
        self.up_path_2 = nn.ModuleList()
        self.skip_conv_1 = nn.ModuleList()
        self.skip_conv_2 = nn.ModuleList()
        for i in reversed(range(depth - 1)):
            out = (2 ** i) * wf
            self.up_path_1.append(UNetUpBlock(prev, out, relu_slope))
            self.up_path_2.append(UNetUpBlock(prev, out, relu_slope))
            self.skip_conv_1.append(conv(out, out, 3, bias=True))
            self.skip_conv_2.append(conv(out, out, 3, bias=True))
            prev = out
        self.sam12 = SAM(wf)
        self.cat12 = conv(2 * wf, wf, 1, bias=True)
        self.last = conv(wf, out_chn, 3, bias=True)

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        image = self.conv_in(x)
        x1 = self.conv_01(image)
        encs, decs = [], []
        for blk in self.down_path_1:
            x1 = blk(x1)
            if blk.downsample is not None:
                encs.append(x1)
                x1 = blk.downsample(x1)
        for i, up in enumerate(self.up_path_1):
            x1 = up(x1, self.skip_conv_1[i](encs[-i - 1]))
            decs.append(x1)
        sam_feature = self.sam12(x1, image)
        x2 = self.cat12(torch.cat([self.conv_02(image), sam_feature], dim=1))
        blocks = []
        for i, blk in enumerate(self.down_path_2):
            if blk.downsample is not None:
                x2 = blk(x2, encs[i], decs[-i - 1])
                blocks.append(x2)
                x2 = blk.downsample(x2)
            else:
                x2 = blk(x2)
        for i, up in enumerate(self.up_path_2):
            x2 = up(x2, self.skip_conv_2[i](blocks[-i - 1]))
        return self.last(x2) + image


def from_jax_params(params) -> dict[str, torch.Tensor]:
    """The inverse of the JAX ``convert_torch_state``: each up-convolution's
    1x1 kernel to (dy, dx, out) channels back to (in, out, 2, 2), its bias
    the one value of its four copies (raises if they differ)."""
    sd: dict[str, torch.Tensor] = {}

    def block(key, q):
        for name in ("conv_1", "conv_2", "identity", "csff_enc", "csff_dec"):
            if name in q:
                jax_conv_into(sd, f"{key}.{name}", q[name])
        if "norm_scale" in q:
            jax_vec_into(sd, f"{key}.norm.weight", q["norm_scale"])
            jax_vec_into(sd, f"{key}.norm.bias", q["norm_bias"])

    def upconv(key, q):
        k = np.asarray(q["kernel"])[0, 0]  # (in, (dy, dx, out))
        out = k.shape[1] // 4
        sd[f"{key}.weight"] = _jax_t(np.transpose(k.reshape(-1, 2, 2, out), (0, 3, 1, 2)))
        bias = np.asarray(q["bias"]).reshape(4, out)
        if not (bias == bias[0]).all():
            raise ValueError(f"{key}: the JAX tree's four bias copies differ; the reference holds one per channel")
        sd[f"{key}.bias"] = _jax_t(bias[0])

    jax_conv_into(sd, "conv_in", params["conv_in"])
    for name in ("conv_01", "conv_02", "cat12", "last"):
        jax_conv_into(sd, name, params[name])
    for j in (1, 2, 3):
        jax_conv_into(sd, f"sam12.conv{j}", params[f"sam_conv{j}"])
    depth = sum(1 for k in params if k.startswith("down1_") and not k.endswith("_ds"))
    for i in range(depth):
        for s in (1, 2):
            block(f"down_path_{s}.{i}", params[f"down{s}_{i}"])
            if i + 1 < depth:
                jax_conv_into(sd, f"down_path_{s}.{i}.downsample", params[f"down{s}_{i}_ds"])
    for idx in range(depth - 1):
        for s in (1, 2):
            upconv(f"up_path_{s}.{idx}.up", params[f"up{s}_{idx}"])
            block(f"up_path_{s}.{idx}.conv_block", params[f"up{s}_{idx}_block"])
            jax_conv_into(sd, f"skip_conv_{s}.{idx}", params[f"skip{s}_{idx}"])
    return sd
