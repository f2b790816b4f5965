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

Every block's attention and FFN run on the MSAB functions of
``ops/fused_msab.py``, as MST++'s do: ``attn_stats`` (pass A: q, k, the
head-diagonal Gram blocks and the norms), ``attn_matrix`` without the Wv
fold (M' = A Wproj: the gate sits between x Wv and the product), then
``msab_apply`` with the block's gate: the masked ``msab_pos`` and the FFN.
On CUDA that is 27 ``attn_stats_kernel``, 27 ``msab_masked_kernel`` and 27
``ffn`` launches per forward; on the CPU, or with ``plain=True``, their
plain versions. The mask branch (``MaskGuidedMechanism``), the embeddings,
the down- and up-convolutions and the mapping stay plain PyTorch on the
frames' device (``F.conv2d`` with TF32 off).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from animal_vision_tpu_torch.models.mst_plus_plus import (
    MSAB,
    MSMSA,
    UpConv,
    _jax_conv_w,
    _jax_t,
    _reflect_index,
    jax_msab_into,
    jax_up_into,
)
from animal_vision_tpu_torch.ops import fused_msab as K
from animal_vision_tpu_torch.ops.fused_msab import MsabWeights

DIM = 31
STAGE = 2
NUM_BLOCKS = (4, 7, 5)


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


class MaskedMSMSA(MSMSA):
    """Spectral-wise multi-head self-attention guided by the mask: MST++'s
    parameters (``MSMSA``) and the block's ``MaskGuidedMechanism``."""

    def __init__(self, dim: int, dim_head: int, heads: int):
        super().__init__(dim, dim_head, heads)
        self.mm = MaskGuidedMechanism(dim)


class MaskedMSAB(MSAB):
    """``num_blocks`` x (masked attention + residual, prenorm FFN +
    residual): MST++'s block weights (``MSAB.weights``) with each block's
    gate from the level's mask."""

    attention = MaskedMSMSA

    def run(self, x: torch.Tensor, mask: torch.Tensor, weights: list[MsabWeights], plain: bool) -> torch.Tensor:
        """The level's blocks on (N, H, W, C) ``x`` with the level's
        (1, H, W, C) mask of frame 0."""
        stats = K.attn_stats_plain if plain else K.attn_stats
        apply = K.msab_apply_plain if plain else K.msab_apply
        for (attn, _), blk in zip(self.blocks, weights):
            gate = attn.mm(mask)
            m = K.attn_matrix(*stats(x, blk.wq, blk.wk, blk.heads), blk.rescale, None, blk.wproj)
            x = apply(x, m, blk, gate)
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

    def weights(self, device: torch.device) -> dict:
        """Every block's MSAB weights in the kernels' layouts, made once per
        device (again after ``load_state_dict`` or a move)."""
        key = str(device)
        if key not in self._prepared:
            msabs = [enc[0] for enc in self.encoder_layers] + [self.bottleneck] + [dec[2] for dec in self.decoder_layers]
            self._prepared[key] = {id(m): m.weights() for m in msabs}
        return self._prepared[key]

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """(N, H, W, 3) -> (N, H, W, 31). ``plain`` takes the MSAB
        functions' plain versions on any device (the CPU always does)."""
        if x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"MSTModel takes (N, H, W, 3) frames, got {tuple(x.shape)}")
        if x.device != self.mapping.weight.device:
            raise ValueError(f"frames on {x.device}, model on {self.mapping.weight.device}")
        fw = self.weights(x.device)
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
