"""Plain MST-L forward (Cai et al., "Mask-guided Spectral-wise Transformer",
CVPR, 2022, arXiv 2111.07910) at the configuration MST++ benchmarks it at
(github.com/caiyuanhao1998/MST-plus-plus, ``predict_code/architecture``:
``MST(dim=31, stage=2, num_blocks=[4, 7, 5])``), from a state dict in the
published ``MST.py`` names.

NCHW float32 with ``torch.nn.functional``, as the published module computes
it: two 3x3 embeddings of the RGB frame, each followed by LeakyReLU(0.1),
give the features and the mask; each of the 27 blocks is mask-guided
spectral-wise attention (q, k, v by 1x1 maps; the mask branch
m = W1 mask, gate = m sigmoid(dw5x5(W2 m)) + m scales v for the product; q
and k L2-normalised over the pixels; softmax of k q^T times the head's
rescale; the projection; the positional branch dw3x3 -> GELU -> dw3x3 of
the unmasked v) plus the residual, then a LayerNorm'd FFN with 4x
expansion plus the residual; the encoder takes the features and the mask
down by their own 4x4 stride-2 convolutions, the decoder goes up by a 2x2
stride-2 transposed convolution and a 1x1 fuse of [up | skip] and takes
the masks back; the output is the 3x3 mapping of the features plus the
embedded features. Heads of 31 channels: 1, 2 and 4 at 31, 62 and 124.

Departures from the published module, each the port's own:

- the frame is reflect-padded to multiples of 8, run, and cropped;
- each decoder up-convolution's bias is kept per (out, dy, dx), shape
  (out, 2, 2), and a (out,) bias broadcasts to it (the published
  per-channel bias is a special case of this);
- the mask is taken per frame. The published module takes a batch's first
  frame's mask for every frame, which is the same thing for a single
  frame, and the program runs MST-L one frame per forward.

Imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

DIM = 31
STAGE = 2
NUM_BLOCKS = (4, 7, 5)


def _conv(x: torch.Tensor, sd: dict, name: str, **kw) -> torch.Tensor:
    return F.conv2d(x, sd[f"{name}.weight"], sd.get(f"{name}.bias"), **kw)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


def _gate(mask: torch.Tensor, sd: dict, pre: str) -> torch.Tensor:
    """The mask branch of one block on (N, C, H, W)."""
    c = mask.shape[1]
    m = _conv(mask, sd, f"{pre}.conv1")
    g = _conv(_conv(m, sd, f"{pre}.conv2"), sd, f"{pre}.depth_conv", padding=2, groups=c)
    return m * torch.sigmoid(g) + m


def _block(x: torch.Tensor, mask: torch.Tensor, sd: dict, pre: str) -> torch.Tensor:
    """One masked MSAB block (attention + residual, pre-norm FFN +
    residual) on (N, C, H, W) with the level's (N, C, H, W) mask."""
    n, c, h, w = x.shape
    a, f = f"{pre}.0", f"{pre}.1"
    heads = c // DIM
    t = x.permute(0, 2, 3, 1).reshape(n, h * w, c)
    q, k, v = (t @ sd[f"{a}.to_{s}.weight"].t() for s in "qkv")
    gate = _gate(mask, sd, f"{a}.mm").permute(0, 2, 3, 1).reshape(n, h * w, c)

    def split(z):
        return z.reshape(n, h * w, heads, DIM).permute(0, 2, 3, 1)  # (n, heads, d, hw)

    qh, kh, vh = split(q), split(k), split(v * gate)
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


def _msab(x: torch.Tensor, mask: torch.Tensor, sd: dict, pre: str, blocks: int) -> torch.Tensor:
    for i in range(blocks):
        x = _block(x, mask, sd, f"{pre}.blocks.{i}")
    return x


def _up(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 transposed convolution with a bias per (out, dy, dx)."""
    out = F.conv_transpose2d(x, weight, stride=2)
    b = bias.reshape(-1, 1, 1).expand(-1, 2, 2) if bias.dim() == 1 else bias
    return out + b.repeat(1, x.shape[2], x.shape[3])


def forward_one(x: torch.Tensor, sd: dict) -> torch.Tensor:
    """(1, 3, H, W) float32 with H and W multiples of 8 -> (1, 31, H, W)."""
    mask = _lrelu(F.conv2d(x, sd["embedding_1.weight"], padding=1))
    fea = _lrelu(F.conv2d(x, sd["embedding_2.weight"], padding=1))
    xin = fea
    skips, masks = [], []
    for i in range(STAGE):
        fea = _msab(fea, mask, sd, f"encoder_layers.{i}.0", NUM_BLOCKS[i])
        masks.append(mask)
        skips.append(fea)
        fea = F.conv2d(fea, sd[f"encoder_layers.{i}.1.weight"], stride=2, padding=1)
        mask = F.conv2d(mask, sd[f"encoder_layers.{i}.2.weight"], stride=2, padding=1)
    fea = _msab(fea, mask, sd, "bottleneck", NUM_BLOCKS[-1])
    for i in range(STAGE):
        d = f"decoder_layers.{i}"
        fea = _up(fea, sd[f"{d}.0.weight"], sd[f"{d}.0.bias"])
        fea = F.conv2d(torch.cat([fea, skips[STAGE - 1 - i]], dim=1), sd[f"{d}.1.weight"])
        fea = _msab(fea, masks[STAGE - 1 - i], sd, f"{d}.2", NUM_BLOCKS[STAGE - 1 - i])
    return F.conv2d(fea, sd["mapping.weight"], padding=1) + xin


def forward(x: torch.Tensor, sd: dict) -> torch.Tensor:
    """(N, H, W, 3) float32 -> (N, H, W, 31) with the weights ``sd`` on
    ``x``'s device, each frame with its own mask."""
    n, h, w, _ = x.shape
    y = x.permute(0, 3, 1, 2)
    hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
    if (hp, wp) != (h, w):
        y = F.pad(y, (0, wp - w, 0, hp - h), mode="reflect")
    out = torch.cat([forward_one(y[i:i + 1], sd) for i in range(n)])
    return out[:, :, :h, :w].permute(0, 2, 3, 1)
