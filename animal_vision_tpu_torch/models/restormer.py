"""Restormer: a 4-level U-shaped transformer with channel attention.

Counterpart of ``animal_vision_tpu/models/restormer.py``, the registry's
``"restormer"`` with the JAX defaults: dim 48, blocks (2, 3, 3, 4), 3
refinement blocks, heads (1, 2, 4, 8), ``dual_pixel_task``
(``restormer.py:109-115``). Each block is MDTA attention (per head a C x C
matrix of the L2-normalised q and k over the pixels, times a learned
temperature, ``:41-66``) and the gated-dconv FFN (GDFN), both behind a
LayerNorm with bias over the channels; the levels change by pixel
(un)shuffle. With ``dual_pixel_task`` the output adds a 1x1 skip of the
patch embedding instead of the input. The frame is reflect-padded to
multiples of 8 and the output cropped (``:124-127``). No convolution has a
bias. State layout: the reference names the JAX ``convert_torch_state``
reads (``encoder_level1.i.attn.qkv``, ``down1_2.body.0``, ...).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from animal_vision_tpu_torch.models.common import ZooNet, conv, jax_conv_into, jax_vec_into
from animal_vision_tpu_torch.models.mst_plus_plus import _jax_conv_w

# (JAX prefix, reference name) of each run of transformer blocks
_STAGES = (("enc1", "encoder_level1"), ("enc2", "encoder_level2"), ("enc3", "encoder_level3"), ("latent", "latent"),
           ("dec3", "decoder_level3"), ("dec2", "decoder_level2"), ("dec1", "decoder_level1"),
           ("refine", "refinement"))


class LayerNorm(nn.Module):
    """WithBias_LayerNorm over the channels (eps 1e-5, biased variance)."""

    def __init__(self, dim: int):
        super().__init__()
        self.body = nn.Module()
        self.body.weight = nn.Parameter(torch.ones(dim))
        self.body.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(dim=1, keepdim=True)
        var = x.var(dim=1, keepdim=True, unbiased=False)
        return (x - mu) / torch.sqrt(var + 1e-5) * self.body.weight.view(1, -1, 1, 1) + self.body.bias.view(1, -1, 1, 1)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.temperature = nn.Parameter(torch.ones(num_heads, 1, 1))
        self.qkv = conv(dim, dim * 3, 1)
        self.qkv_dwconv = conv(dim * 3, dim * 3, 3, groups=dim * 3)
        self.project_out = conv(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        q, k, v = self.qkv_dwconv(self.qkv(x)).chunk(3, dim=1)
        q, k, v = (t.reshape(b, self.num_heads, c // self.num_heads, h * w) for t in (q, k, v))
        q, k = F.normalize(q, dim=-1), F.normalize(k, dim=-1)
        attn = torch.softmax(torch.matmul(q, k.transpose(-2, -1)) * self.temperature, dim=-1)
        return self.project_out(torch.matmul(attn, v).reshape(b, c, h, w))


class FeedForward(nn.Module):
    def __init__(self, dim: int, expansion: float = 2.66):
        super().__init__()
        hidden = int(dim * expansion)
        self.project_in = conv(dim, hidden * 2, 1)
        self.dwconv = conv(hidden * 2, hidden * 2, 3, groups=hidden * 2)
        self.project_out = conv(hidden, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.dwconv(self.project_in(x)).chunk(2, dim=1)
        return self.project_out(F.gelu(x1) * x2)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        self.ffn = FeedForward(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class Resize(nn.Module):
    """A bias-free 3x3 convolution, then a pixel (un)shuffle by 2 (the
    reference's ``Downsample``/``Upsample``, ``body.0`` the convolution)."""

    def __init__(self, cin: int, cout: int, shuffle: nn.Module):
        super().__init__()
        self.body = nn.Sequential(conv(cin, cout, 3), shuffle)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x)


class Restormer(ZooNet):
    PAD = 8

    def __init__(self, inp_channels: int = 3, out_channels: int = 31, dim: int = 48, num_blocks=(2, 3, 3, 4),
                 num_refinement: int = 3, heads=(1, 2, 4, 8), dual_pixel_task: bool = True):
        super().__init__()
        d = dim
        dims = (d, d * 2, d * 4, d * 8)

        def blocks(level, count, width=None):
            return nn.Sequential(*(TransformerBlock(width or dims[level], heads[level]) for _ in range(count)))

        self.patch_embed = nn.Module()
        self.patch_embed.proj = conv(inp_channels, d, 3)
        self.encoder_level1 = blocks(0, num_blocks[0])
        self.down1_2 = Resize(d, d // 2, nn.PixelUnshuffle(2))
        self.encoder_level2 = blocks(1, num_blocks[1])
        self.down2_3 = Resize(d * 2, d, nn.PixelUnshuffle(2))
        self.encoder_level3 = blocks(2, num_blocks[2])
        self.down3_4 = Resize(d * 4, d * 2, nn.PixelUnshuffle(2))
        self.latent = blocks(3, num_blocks[3])
        self.up4_3 = Resize(d * 8, d * 16, nn.PixelShuffle(2))
        self.reduce_chan_level3 = conv(d * 8, d * 4, 1)
        self.decoder_level3 = blocks(2, num_blocks[2])
        self.up3_2 = Resize(d * 4, d * 8, nn.PixelShuffle(2))
        self.reduce_chan_level2 = conv(d * 4, d * 2, 1)
        self.decoder_level2 = blocks(1, num_blocks[1])
        self.up2_1 = Resize(d * 2, d * 4, nn.PixelShuffle(2))
        self.decoder_level1 = blocks(0, num_blocks[0], d * 2)
        self.refinement = blocks(0, num_refinement, d * 2)
        self.dual_pixel_task = dual_pixel_task
        if dual_pixel_task:
            self.skip_conv = conv(d, d * 2, 1)
        self.output = conv(d * 2, out_channels, 3)

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        emb = self.patch_embed.proj(x)
        enc1 = self.encoder_level1(emb)
        enc2 = self.encoder_level2(self.down1_2(enc1))
        enc3 = self.encoder_level3(self.down2_3(enc2))
        latent = self.latent(self.down3_4(enc3))
        dec3 = self.decoder_level3(self.reduce_chan_level3(torch.cat([self.up4_3(latent), enc3], dim=1)))
        dec2 = self.decoder_level2(self.reduce_chan_level2(torch.cat([self.up3_2(dec3), enc2], dim=1)))
        dec1 = self.refinement(self.decoder_level1(torch.cat([self.up2_1(dec2), enc1], dim=1)))
        if self.dual_pixel_task:
            return self.output(dec1 + self.skip_conv(emb))
        return self.output(dec1) + x


def from_jax_params(params) -> dict[str, torch.Tensor]:
    """The inverse of the JAX ``convert_torch_state``."""
    sd: dict[str, torch.Tensor] = {}
    for name, key in (("patch_embed", "patch_embed.proj"), ("down1_2", "down1_2.body.0"),
                      ("down2_3", "down2_3.body.0"), ("down3_4", "down3_4.body.0"), ("up4_3", "up4_3.body.0"),
                      ("up3_2", "up3_2.body.0"), ("up2_1", "up2_1.body.0"), ("reduce3", "reduce_chan_level3"),
                      ("reduce2", "reduce_chan_level2"), ("skip_conv", "skip_conv"), ("output", "output")):
        if name in params:
            jax_conv_into(sd, key, params[name])
    for prefix, key in _STAGES:
        i = 0
        while f"{prefix}_{i}" in params:
            q, p = params[f"{prefix}_{i}"], f"{key}.{i}"
            for norm in ("norm1", "norm2"):
                jax_vec_into(sd, f"{p}.{norm}.body.weight", q[norm]["weight"])
                jax_vec_into(sd, f"{p}.{norm}.body.bias", q[norm]["bias"])
            jax_vec_into(sd, f"{p}.attn.temperature", q["attn"]["temperature"])
            for name in ("qkv", "qkv_dwconv", "project_out"):
                sd[f"{p}.attn.{name}.weight"] = _jax_conv_w(q["attn"][name]["kernel"])
            for name in ("project_in", "dwconv", "project_out"):
                sd[f"{p}.ffn.{name}.weight"] = _jax_conv_w(q["ffn"][name]["kernel"])
            i += 1
    return sd
