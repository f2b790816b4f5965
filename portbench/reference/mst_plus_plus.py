"""Plain MST++ forward (Cai et al., "MST++", CVPR-W 2022), from a state
dict in the published ``MST_Plus_Plus.py`` names.

NCHW float32 with ``torch.nn.functional`` convolutions, as the published
module computes it: ``conv_in`` 3 -> 31, three U-shaped MST stages (31, 62,
124 channels; spectral-wise attention with heads of 31 channels; a
LayerNorm'd FFN with 4x expansion), ``conv_out`` and the global residual;
the frame is reflect-padded to multiples of 8 and cropped. One departure
from the published module, which the shipped weights need: each decoder
up-convolution's bias is kept per (out, dy, dx), shape (out, 2, 2), and a
(out,) bias broadcasts to it. Imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

N_FEAT = 31
STAGES = 3
LEVELS = 2


def _msab(x: torch.Tensor, sd: dict, pre: str) -> torch.Tensor:
    """One MSAB block (attention + pre-norm FFN) on (N, C, H, W)."""
    n, c, h, w = x.shape
    a, f = f"{pre}.blocks.0.0", f"{pre}.blocks.0.1"
    heads = c // N_FEAT
    t = x.permute(0, 2, 3, 1).reshape(n, h * w, c)
    q, k, v = (t @ sd[f"{a}.to_{s}.weight"].t() for s in "qkv")

    def split(z):
        return z.reshape(n, h * w, heads, N_FEAT).permute(0, 2, 3, 1)  # (n, heads, d, hw)

    qh, kh, vh = split(q), split(k), split(v)
    qh, kh = F.normalize(qh, dim=-1, p=2), F.normalize(kh, dim=-1, p=2)
    attn = torch.softmax((kh @ qh.transpose(-2, -1)) * sd[f"{a}.rescale"], dim=-1)
    o = (attn @ vh).permute(0, 3, 1, 2).reshape(n, h * w, c)
    out_c = o @ sd[f"{a}.proj.weight"].t() + sd[f"{a}.proj.bias"]
    vp = v.reshape(n, h, w, c).permute(0, 3, 1, 2)
    pos = F.conv2d(F.gelu(F.conv2d(vp, sd[f"{a}.pos_emb.0.weight"], padding=1, groups=c)),
                   sd[f"{a}.pos_emb.2.weight"], padding=1, groups=c)
    y = out_c.reshape(n, h, w, c) + pos.permute(0, 2, 3, 1) + x.permute(0, 2, 3, 1)
    z = F.layer_norm(y, (c,), sd[f"{f}.norm.weight"], sd[f"{f}.norm.bias"], eps=1e-5).permute(0, 3, 1, 2)
    z = F.gelu(F.conv2d(z, sd[f"{f}.fn.net.0.weight"]))
    z = F.gelu(F.conv2d(z, sd[f"{f}.fn.net.2.weight"], padding=1, groups=z.shape[1]))
    z = F.conv2d(z, sd[f"{f}.fn.net.4.weight"])
    return (z + y.permute(0, 3, 1, 2)).contiguous()


def _up(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 transposed convolution with a bias per (out, dy, dx)."""
    out = F.conv_transpose2d(x, weight, stride=2)
    b = bias.reshape(-1, 1, 1).expand(-1, 2, 2) if bias.dim() == 1 else bias
    return out + b.repeat(1, x.shape[2], x.shape[3])


def _stage(x: torch.Tensor, sd: dict, pre: str) -> torch.Tensor:
    fea = F.conv2d(x, sd[f"{pre}.embedding.weight"], padding=1)
    skips = []
    for i in range(LEVELS):
        fea = _msab(fea, sd, f"{pre}.encoder_layers.{i}.0")
        skips.append(fea)
        fea = F.conv2d(fea, sd[f"{pre}.encoder_layers.{i}.1.weight"], stride=2, padding=1)
    fea = _msab(fea, sd, f"{pre}.bottleneck")
    for i in range(LEVELS):
        d = f"{pre}.decoder_layers.{i}"
        fea = _up(fea, sd[f"{d}.0.weight"], sd[f"{d}.0.bias"])
        fea = F.conv2d(torch.cat([fea, skips[LEVELS - 1 - i]], dim=1), sd[f"{d}.1.weight"])
        fea = _msab(fea, sd, f"{d}.2")
    return F.conv2d(fea, sd[f"{pre}.mapping.weight"], padding=1) + x


def forward(x: torch.Tensor, sd: dict) -> torch.Tensor:
    """(N, H, W, 3) float32 -> (N, H, W, 31) with the weights ``sd`` on
    ``x``'s device."""
    n, h, w, _ = x.shape
    y = x.permute(0, 3, 1, 2)
    hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
    if (hp, wp) != (h, w):
        y = F.pad(y, (0, wp - w, 0, hp - h), mode="reflect")
    fea = F.conv2d(y, sd["conv_in.weight"], padding=1)
    body = fea
    for s in range(STAGES):
        body = _stage(body, sd, f"body.{s}")
    out = F.conv2d(body, sd["conv_out.weight"], padding=1) + fea
    return out[:, :, :h, :w].permute(0, 2, 3, 1)
