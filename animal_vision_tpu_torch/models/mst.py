"""The zoo's mask-guided MST (MST-L): RGB -> 31-band hyperspectral
reconstruction.

Counterpart of ``animal_vision_tpu/models/mst.py`` for the registry's
``"mst"`` configuration: dim 31, 2 stages, ``num_blocks`` (4, 7, 5), heads
of 31 channels (1, 2 and 4 heads at the levels of 31, 62 and 124 channels),
27 blocks. Frames are NHWC (N, H, W, C) float32, like the JAX module.

Two 3x3 embeddings of the reflect-padded frame (each followed by
LeakyReLU(0.1)) give the features and a *mask*. Every block's spectral
attention is mask-guided: its ``MaskGuidedMechanism`` (1x1, 1x1, depthwise
5x5 with bias) turns the level's mask into m sigmoid(g) + m, which scales v
for the attention product; the positional branch reads the unmasked v. The
encoder downsamples the features and the mask with their own 4x4 stride-2
convolutions, the decoder takes the masks back in reverse, and the output
is ``mapping`` of the features plus the embedded features, cropped.

The mask attention comes from the batch's *first* frame and is broadcast
over the batch (``mask[:1]``, as in the reference ``MST.py``): every frame
of a batch uses frame 0's mask, so a batch differs from its frames.
``models/providers.py`` runs this model one frame at a time.

State layout: the reference ``MST.py`` names and shapes (what the JAX
``convert_torch_state`` reads), with each decoder up-convolution's bias per
(out, dy, dx), as ``mst_plus_plus.UpConv`` keeps it. ``from_jax_params``
carries a JAX ``MSTModel`` param tree across exactly.

The FFN of every block is ``ops/fused_mst.py:ffn`` (the ``ffn_kernel`` on
CUDA, 27 launches per forward) or, on the CPU or with ``plain=True``, its
plain version. Attention, masks, embeddings and convolutions are plain
PyTorch on the frames' device (``F.conv2d`` with TF32 off, ``torch.matmul``,
softmax), as the JAX package leaves them to XLA outside any Pallas kernel.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from animal_vision_tpu_torch.models.mst_plus_plus import (
    PreNorm,
    UpConv,
    _dense,
    _depthwise,
    _jax_conv_w,
    _jax_t,
    _reflect_index,
    _t,
    jax_msab_into,
    jax_up_into,
)
from animal_vision_tpu_torch.ops import fused_mst as K

DIM = 31
STAGE = 2
NUM_BLOCKS = (4, 7, 5)


class FfnWeights(NamedTuple):
    """One block's FFN weights in ``ops/fused_mst.py``'s layouts."""

    ln_w: torch.Tensor  # (C,)
    ln_b: torch.Tensor  # (C,)
    w0: torch.Tensor  # (C, 4C)
    dw: torch.Tensor  # (3, 3, 4C)
    w4: torch.Tensor  # (4C, C)


class MaskGuidedMechanism(nn.Module):
    def __init__(self, n_feat: int):
        super().__init__()
        self.conv1 = nn.Conv2d(n_feat, n_feat, 1, bias=True)
        self.conv2 = nn.Conv2d(n_feat, n_feat, 1, bias=True)
        self.depth_conv = nn.Conv2d(n_feat, n_feat, 5, padding=2, bias=True, groups=n_feat)

    def forward(self, mask: torch.Tensor) -> torch.Tensor:
        m = _conv(mask, self.conv1)
        g = _conv(_conv(m, self.conv2), self.depth_conv)
        return m * torch.sigmoid(g) + m


class MaskedMSMSA(nn.Module):
    """Spectral-wise multi-head self-attention guided by the mask."""

    def __init__(self, dim: int, dim_head: int, heads: int):
        super().__init__()
        inner = dim_head * heads
        self.heads, self.dim_head = heads, dim_head
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.rescale = nn.Parameter(torch.ones(heads, 1, 1))
        self.proj = nn.Linear(inner, dim, bias=True)
        self.pos_emb = nn.Sequential(
            nn.Conv2d(dim, dim, 3, 1, 1, bias=False, groups=dim),
            nn.GELU(),
            nn.Conv2d(dim, dim, 3, 1, 1, bias=False, groups=dim),
        )
        self.mm = MaskGuidedMechanism(dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x (N, H, W, C); mask (1, H, W, C), the level's mask of frame 0."""
        n, h, w, c = x.shape
        heads, d = self.heads, self.dim_head
        flat = x.reshape(n, h * w, c)
        q, k, v = F.linear(flat, self.to_q.weight), F.linear(flat, self.to_k.weight), F.linear(flat, self.to_v.weight)
        vm = v * self.mm(mask).reshape(1, h * w, c)
        # per head, attn[o, e] = softmax_e(k_o . q_e / (|k_o| |q_e|) rescale)
        # over the pixels, then out[p, o] = sum_e attn[o, e] vm[p, e]
        g = _head_blocks(_gram(k, q, n, h, w, c), heads, d)
        qn = torch.clamp(torch.sqrt((q * q).sum(dim=1)), min=1e-12).view(n, heads, 1, d)
        kn = torch.clamp(torch.sqrt((k * k).sum(dim=1)), min=1e-12).view(n, heads, d, 1)
        attn = torch.softmax(g / (kn * qn) * self.rescale.view(1, heads, 1, 1), dim=-1)
        out = torch.matmul(vm.view(n, h * w, heads, d).transpose(1, 2), attn.transpose(-1, -2))
        out_c = F.linear(out.transpose(1, 2).reshape(n, h * w, c), self.proj.weight, self.proj.bias)
        v_img = v.view(n, h, w, c)
        pos = _conv(F.gelu(_conv(v_img, self.pos_emb[0])), self.pos_emb[2])
        return out_c.view(n, h, w, c) + pos


def _gram(k: torch.Tensor, q: torch.Tensor, n: int, h: int, w: int, c: int) -> torch.Tensor:
    """(N, C, C) k^T q over each frame's pixels, as one product per image
    row summed over the rows: cuBLAS runs a single product with a
    million-long inner dimension and a 31 x 31 output on a few blocks."""
    rows = torch.bmm(k.view(n * h, w, c).transpose(1, 2), q.view(n * h, w, c))
    return rows.view(n, h, c, c).sum(dim=1)


def _head_blocks(g: torch.Tensor, heads: int, d: int) -> torch.Tensor:
    """(N, heads, d, d) diagonal blocks of an (N, C, C) Gram matrix."""
    return torch.stack([g[:, i * d:(i + 1) * d, i * d:(i + 1) * d] for i in range(heads)], dim=1)


class MaskedMSAB(nn.Module):
    """``num_blocks`` x (masked attention + residual, prenorm FFN + residual)."""

    def __init__(self, dim: int, dim_head: int, heads: int, num_blocks: int):
        super().__init__()
        self.blocks = nn.ModuleList(
            nn.ModuleList([MaskedMSMSA(dim, dim_head, heads), PreNorm(dim)]) for _ in range(num_blocks)
        )

    def ffn_weights(self) -> list[FfnWeights]:
        out = []
        for _, pre in self.blocks:
            ff = pre.fn.net
            out.append(FfnWeights(_t(pre.norm.weight), _t(pre.norm.bias), _dense(ff[0].weight[:, :, 0, 0]),
                                  _depthwise(ff[2].weight), _dense(ff[4].weight[:, :, 0, 0])))
        return out

    def run(self, x: torch.Tensor, mask: torch.Tensor, ffn_weights: list[FfnWeights], plain: bool) -> torch.Tensor:
        ffn = K.ffn_plain if plain else K.ffn
        for (attn, _), fw in zip(self.blocks, ffn_weights):
            x = attn(x, mask) + x
            x = ffn(x.contiguous(), *fw)
        return x


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` (its weight, bias, stride, padding, groups) applied to
    (N, H, W, C) frames, through their channels-last NCHW view."""
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias, conv.stride, conv.padding, groups=conv.groups)
    return y.permute(0, 2, 3, 1)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


@contextlib.contextmanager
def _full_float32():
    """Convolutions in full float32 (cuDNN's TF32 off) for the forward."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class MSTModel(nn.Module):
    """MST-L: ``forward`` takes (N, H, W, 3) float32 frames on the model's
    device and returns (N, H, W, 31); the frame is reflect-padded to
    multiples of 8, run, and cropped."""

    def __init__(self, dim: int = DIM, stage: int = STAGE, num_blocks=NUM_BLOCKS):
        super().__init__()
        self.stage = stage
        self.embedding_1 = nn.Conv2d(3, dim, 3, 1, 1, bias=False)
        self.embedding_2 = nn.Conv2d(3, dim, 3, 1, 1, bias=False)
        self.encoder_layers = nn.ModuleList()
        dim_stage = dim
        for i in range(stage):
            self.encoder_layers.append(nn.ModuleList([
                MaskedMSAB(dim_stage, dim, dim_stage // dim, num_blocks[i]),
                nn.Conv2d(dim_stage, dim_stage * 2, 4, 2, 1, bias=False),
                nn.Conv2d(dim_stage, dim_stage * 2, 4, 2, 1, bias=False),
            ]))
            dim_stage *= 2
        self.bottleneck = MaskedMSAB(dim_stage, dim, dim_stage // dim, num_blocks[-1])
        self.decoder_layers = nn.ModuleList()
        for i in range(stage):
            self.decoder_layers.append(nn.ModuleList([
                UpConv(dim_stage, dim_stage // 2),
                nn.Conv2d(dim_stage, dim_stage // 2, 1, 1, bias=False),
                MaskedMSAB(dim_stage // 2, dim, dim_stage // 2 // dim, num_blocks[stage - 1 - i]),
            ]))
            dim_stage //= 2
        self.mapping = nn.Conv2d(dim, 31, 3, 1, 1, bias=False)
        self._prepared: dict = {}

    def _apply(self, fn, *args, **kwargs):
        self._prepared = {}
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        self._prepared = {}
        return super().load_state_dict(state_dict, strict=strict, assign=assign)

    def ffn_weights(self, device: torch.device) -> dict:
        """Every block's FFN weights in the kernel's layouts, made once per
        device (again after ``load_state_dict`` or a move)."""
        key = str(device)
        if key not in self._prepared:
            msabs = [enc[0] for enc in self.encoder_layers] + [self.bottleneck] + [dec[2] for dec in self.decoder_layers]
            self._prepared[key] = {id(m): m.ffn_weights() for m in msabs}
        return self._prepared[key]

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """(N, H, W, 3) -> (N, H, W, 31). ``plain`` takes the FFN's plain
        version on any device (the CPU always does)."""
        if x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"MSTModel takes (N, H, W, 3) frames, got {tuple(x.shape)}")
        if x.device != self.mapping.weight.device:
            raise ValueError(f"frames on {x.device}, model on {self.mapping.weight.device}")
        fw = self.ffn_weights(x.device)
        n, h, w, _ = x.shape
        hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
        x = x.to(torch.float32)
        if (hp, wp) != (h, w):
            x = x.index_select(1, _reflect_index(h, hp, x.device)).index_select(2, _reflect_index(w, wp, x.device))
        with _full_float32():
            mask = _lrelu(_conv(x[:1], self.embedding_1))
            fea = _lrelu(_conv(x, self.embedding_2))
            xin = fea
            skips, masks = [], []
            for msab, down, mask_down in self.encoder_layers:
                fea = msab.run(fea, mask, fw[id(msab)], plain)
                masks.append(mask)
                skips.append(fea)
                fea = _conv(fea, down)
                mask = _conv(mask, mask_down)
            fea = self.bottleneck.run(fea, mask, fw[id(self.bottleneck)], plain)
            for i, (up, fuse, msab) in enumerate(self.decoder_layers):
                fea = _up(fea, up)
                fea = _conv(torch.cat([fea, skips[self.stage - 1 - i]], dim=-1), fuse)
                fea = msab.run(fea, masks[self.stage - 1 - i], fw[id(msab)], plain)
            out = _conv(fea, self.mapping) + xin
        return out[:, :h, :w, :]


def _up(fea: torch.Tensor, up: UpConv) -> torch.Tensor:
    """The 2x2 stride-2 transposed convolution of (N, h, w, C) frames with a
    bias per (out, dy, dx): (N, 2h, 2w, C/2)."""
    y = F.conv_transpose2d(fea.permute(0, 3, 1, 2), up.weight, stride=2)
    h, w = fea.shape[1], fea.shape[2]
    return (y + up.bias.repeat(1, h, w)).permute(0, 2, 3, 1)


def from_jax_params(params) -> dict[str, torch.Tensor]:
    """The port's state dict of a JAX ``MSTModel`` param tree (the
    ``"params"`` collection), exact: the reference names and layouts, each
    up-convolution's four bias copies kept apart as (half, 2, 2)."""
    sd: dict[str, torch.Tensor] = {}

    def msab(prefix, q):
        jax_msab_into(sd, prefix, q)
        for i in range(sum(1 for k in q if k.startswith("attn_"))):
            mm = q[f"attn_{i}"]["mm"]
            for name in ("conv1", "conv2", "depth_conv"):
                sd[f"{prefix}.blocks.{i}.0.mm.{name}.weight"] = _jax_conv_w(mm[name]["kernel"])
                sd[f"{prefix}.blocks.{i}.0.mm.{name}.bias"] = _jax_t(mm[name]["bias"])

    for name in ("embedding_1", "embedding_2", "mapping"):
        sd[f"{name}.weight"] = _jax_conv_w(params[name]["kernel"])
    stage = sum(1 for k in params if k.startswith("enc_msab_"))
    for i in range(stage):
        msab(f"encoder_layers.{i}.0", params[f"enc_msab_{i}"])
        sd[f"encoder_layers.{i}.1.weight"] = _jax_conv_w(params[f"enc_down_{i}"]["kernel"])
        sd[f"encoder_layers.{i}.2.weight"] = _jax_conv_w(params[f"enc_mask_down_{i}"]["kernel"])
    msab("bottleneck", params["bottleneck"])
    for i in range(stage):
        jax_up_into(sd, f"decoder_layers.{i}.0", params[f"dec_up_{i}"])
        sd[f"decoder_layers.{i}.1.weight"] = _jax_conv_w(params[f"dec_fuse_{i}"]["kernel"])
        msab(f"decoder_layers.{i}.2", params[f"dec_msab_{i}"])
    return sd
