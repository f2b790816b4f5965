"""MST++: RGB -> 31-band hyperspectral reconstruction.

Counterpart of ``animal_vision_tpu/models/mst_plus_plus.py`` for the
published configuration: 3 stages (``MSTPlusPlus(stage=...)`` counts the
cascaded stages, as the JAX ``stage`` does), n_feat 31, ``num_blocks``
(1, 1, 1), 1.62 M parameters at 3 stages, spectral attention with heads
of 31 channels (1, 2 and 4 heads at the levels of 31, 62 and 124
channels). Frames are NHWC (N, H, W, C) float32, like the JAX module.

State layout: the reference ``MST_Plus_Plus.py`` names and tensor shapes
(what the JAX ``convert_torch_state`` reads), with one exception: each
decoder up-convolution keeps a bias per (out, dy, dx), shape (half, 2, 2),
because the JAX module's four copies of it are independent parameters (and
they differ in the shipped checkpoint). A reference state dict, whose bias
is (half,), loads by broadcasting. ``from_jax_params`` carries a JAX param
tree across exactly; ``load_shipped`` gives the model with the shipped
``synth_v1`` weights.

The modules only hold the parameters. ``MSTPlusPlus.forward`` composes
the four functions of ``ops/fused_msab.py``: on CUDA their kernels (per
MSAB block one stats launch, the plain-PyTorch glue, one apply launch), on
the CPU or with ``plain=True`` their plain versions. Two paths read the
parameters:

- for inference, the kernels' layouts, made once per device and again
  whenever a parameter's version counter or storage changed (an optimizer
  step, an in-place edit, ``load_state_dict``), outside autograd;
- whenever grad is enabled and a parameter requires grad, and while
  ``torch.export`` traces the forward, the plain versions on the live
  parameters, through which gradients flow. The CUDA kernels have no
  backward (nor do the JAX package's Pallas kernels: its trainer runs
  none, ``models/train.py:44-47``), and a trace cannot follow their
  launches, so a kernel forward on the card under grad or while traced
  raises instead of giving way to the plain versions.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn

from animal_vision_tpu_torch.ops import fused_msab as K
from animal_vision_tpu_torch.ops.fused_msab import MsabWeights

SHIPPED = Path(__file__).resolve().parent / "pretrained" / "synth_v1.pt"


class MSMSA(nn.Module):
    """Spectral-wise multi-head self-attention's parameters (names of the
    reference's ``MS_MSA``)."""

    def __init__(self, dim: int, dim_head: int, heads: int):
        super().__init__()
        inner = dim_head * heads
        self.heads = heads
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


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(
            nn.Conv2d(dim, dim * mult, 1, 1, bias=False),
            nn.GELU(),
            nn.Conv2d(dim * mult, dim * mult, 3, 1, 1, bias=False, groups=dim * mult),
            nn.GELU(),
            nn.Conv2d(dim * mult, dim, 1, 1, bias=False),
        )


class PreNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim)
        self.fn = FeedForward(dim)


class MSAB(nn.Module):
    def __init__(self, dim: int, dim_head: int, heads: int, num_blocks: int):
        super().__init__()
        self.blocks = nn.ModuleList(
            nn.ModuleList([MSMSA(dim, dim_head, heads), PreNorm(dim)]) for _ in range(num_blocks)
        )

    def weights(self, live: bool = False) -> list[MsabWeights]:
        out = []
        for attn, pre in self.blocks:
            ff = pre.fn.net
            out.append(MsabWeights(
                heads=attn.heads,
                wq=_dense(attn.to_q.weight, live), wk=_dense(attn.to_k.weight, live),
                wv=_dense(attn.to_v.weight, live), rescale=_t(attn.rescale.reshape(-1), live),
                wproj=_dense(attn.proj.weight, live), bproj=_t(attn.proj.bias, live),
                pos0=_depthwise(attn.pos_emb[0].weight, live), pos2=_depthwise(attn.pos_emb[2].weight, live),
                ln_w=_t(pre.norm.weight, live), ln_b=_t(pre.norm.bias, live),
                w0=_dense(ff[0].weight[:, :, 0, 0], live), dw=_depthwise(ff[2].weight, live),
                w4=_dense(ff[4].weight[:, :, 0, 0], live),
            ))
        return out


class UpConv(nn.Module):
    """2x2 stride-2 transposed convolution with one bias per (out, dy, dx)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        ref = nn.ConvTranspose2d(dim_in, dim_out, 2, 2)
        self.weight = nn.Parameter(ref.weight.detach().clone())  # (in, out, 2, 2)
        self.bias = nn.Parameter(ref.bias.detach().reshape(dim_out, 1, 1).repeat(1, 2, 2))

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        key = prefix + "bias"
        bias = state_dict.get(key)
        if bias is not None and bias.dim() == 1:  # the reference's one bias per output channel
            state_dict[key] = bias.reshape(-1, 1, 1).expand(-1, 2, 2).contiguous()
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class MST(nn.Module):
    """One U-shaped stage: embedding, 2 encoder levels (MSAB + 4x4 stride-2
    down), the bottleneck MSAB, 2 decoder levels (up, fuse, MSAB), mapping."""

    def __init__(self):
        super().__init__()
        dim, stage, num_blocks = 31, 2, (1, 1, 1)
        self.embedding = nn.Conv2d(dim, dim, 3, 1, 1, bias=False)
        self.encoder_layers = nn.ModuleList()
        dim_stage = dim
        for i in range(stage):
            self.encoder_layers.append(nn.ModuleList([
                MSAB(dim_stage, dim, dim_stage // dim, num_blocks[i]),
                nn.Conv2d(dim_stage, dim_stage * 2, 4, 2, 1, bias=False),
            ]))
            dim_stage *= 2
        self.bottleneck = MSAB(dim_stage, dim, dim_stage // dim, num_blocks[-1])
        self.decoder_layers = nn.ModuleList()
        for i in range(stage):
            self.decoder_layers.append(nn.ModuleList([
                UpConv(dim_stage, dim_stage // 2),
                nn.Conv2d(dim_stage, dim_stage // 2, 1, 1, bias=False),
                MSAB(dim_stage // 2, dim, dim_stage // 2 // dim, num_blocks[stage - 1 - i]),
            ]))
            dim_stage //= 2
        self.mapping = nn.Conv2d(dim, dim, 3, 1, 1, bias=False)

    def weights(self, live: bool = False) -> dict:
        """The stage's weights in the kernels' layouts; with ``live`` the
        decoder levels keep only the raw up-fuse weights (``up_fuse_raw``),
        which the plain version reads."""
        up_fuse = K.up_fuse_raw if live else K.up_fuse_weights
        return {
            "embedding": _conv(self.embedding.weight, live),
            "enc": [(msab.weights(live), _conv(down.weight, live)) for msab, down in self.encoder_layers],
            "bottleneck": self.bottleneck.weights(live),
            "dec": [
                (up_fuse(_t(up.weight.permute(0, 2, 3, 1), live), _t(up.bias.permute(1, 2, 0), live),
                         _dense(fuse.weight[:, :, 0, 0], live)), msab.weights(live))
                for up, fuse, msab in self.decoder_layers
            ],
            "mapping": _conv(self.mapping.weight, live),
        }


def _t(p: torch.Tensor, live: bool = False) -> torch.Tensor:
    """A parameter's values as a contiguous tensor: outside autograd, or,
    with ``live``, a function of the parameter that gradients flow through."""
    return (p if live else p.detach()).contiguous()


def _conv(w: torch.Tensor, live: bool = False) -> torch.Tensor:
    """(out, in, K, K) -> (K, K, in, out)."""
    return _t(w.permute(2, 3, 1, 0), live)


def _dense(w: torch.Tensor, live: bool = False) -> torch.Tensor:
    """(out, in) -> (in, out)."""
    return _t(w.t(), live)


def _depthwise(w: torch.Tensor, live: bool = False) -> torch.Tensor:
    """(C, 1, 3, 3) -> (3, 3, C)."""
    return _t(w[:, 0].permute(1, 2, 0), live)


def _msab(x: torch.Tensor, blocks: list[MsabWeights], plain: bool) -> torch.Tensor:
    stats = K.attn_stats_plain if plain else K.attn_stats
    apply = K.msab_apply_plain if plain else K.msab_apply
    for blk in blocks:
        g, sq, sk = stats(x, blk.wq, blk.wk, blk.heads)
        x = apply(x, K.attn_matrix(g, sq, sk, blk.rescale, blk.wv, blk.wproj), blk)
    return x


def _stage(x: torch.Tensor, st: dict, plain: bool) -> torch.Tensor:
    conv = K.conv_plain if plain else K.conv
    up_fuse = K.up_fuse_plain if plain else K.up_fuse
    fea = conv(x, st["embedding"])
    skips = []
    for blocks, down in st["enc"]:
        fea = _msab(fea, blocks, plain)
        skips.append(fea)
        fea = conv(fea, down)
    fea = _msab(fea, st["bottleneck"], plain)
    for (uw, blocks), skip in zip(st["dec"], reversed(skips)):
        fea = _msab(up_fuse(fea, skip, uw), blocks, plain)
    return conv(fea, st["mapping"], residual=x)


def _reflect_index(n: int, total: int, device: torch.device) -> torch.Tensor:
    """numpy's ``mode="reflect"`` indices extending n samples to ``total``
    (reflection without the edge, repeated for pads longer than n - 1)."""
    i = torch.arange(total, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    m = i % period
    return torch.where(m < n, m, period - m)


class _LayoutCache:
    """The kernels' weight layouts per device, each with the stamp of the
    parameters it was made from. An object, not a dict attribute of the
    module: ``torch.export`` replaces those with copies of fake tensors."""

    def __init__(self):
        self.layouts: dict = {}


class MSTPlusPlus(nn.Module):
    """``stage`` cascaded MST stages (3 in the published model) between
    ``conv_in`` (3 -> 31) and ``conv_out`` (31 -> 31) with a global
    residual. ``forward`` takes (N, H, W, 3) float32 frames on the model's
    device and returns (N, H, W, 31): the frame is reflect-padded to
    multiples of 8, run, and cropped."""

    def __init__(self, stage: int = 3):
        super().__init__()
        self.stage = stage
        self.conv_in = nn.Conv2d(3, 31, 3, 1, 1, bias=False)
        self.body = nn.Sequential(*[MST() for _ in range(stage)])
        self.conv_out = nn.Conv2d(31, 31, 3, 1, 1, bias=False)
        self._cache = _LayoutCache()

    def _apply(self, fn, *args, **kwargs):
        self._cache.layouts = {}
        return super()._apply(fn, *args, **kwargs)

    def _layouts(self, live: bool) -> dict:
        return {
            "conv_in": _conv(self.conv_in.weight, live),
            "conv_out": _conv(self.conv_out.weight, live),
            "stages": [st.weights(live) for st in self.body],
        }

    def weights(self, device: torch.device) -> dict:
        """The parameters in the kernels' layouts, outside autograd: made
        once per device, and again when a parameter's storage or version
        counter moved (an optimizer step, an in-place edit,
        ``load_state_dict``)."""
        key = str(device)
        stamp = tuple((p.data_ptr(), p._version) for p in self.parameters())
        cached = self._cache.layouts.get(key)
        if cached is None or cached[0] != stamp:
            with torch.no_grad():
                cached = (stamp, self._layouts(live=False))
            self._cache.layouts[key] = cached
        return cached[1]

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """(N, H, W, 3) -> (N, H, W, 31). ``plain`` composes the kernels'
        plain versions on any device (the CPU always does). Under grad, with
        a parameter that requires it, and while ``torch.export`` traces the
        forward, the plain versions run on the live parameters; on the card
        that needs ``plain=True``, since the kernels have no backward and a
        trace cannot follow their launches."""
        if x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"MSTPlusPlus takes (N, H, W, 3) frames, got {tuple(x.shape)}")
        if x.device != self.conv_in.weight.device:
            raise ValueError(f"frames on {x.device}, model on {self.conv_in.weight.device}")
        tracing = torch.compiler.is_compiling()
        grad = torch.is_grad_enabled() and any(q.requires_grad for q in self.parameters())
        live = grad or tracing
        if live and x.is_cuda and not plain:
            raise RuntimeError("MSTPlusPlus: the CUDA kernels have no backward and cannot be traced; train or "
                               "export with forward(x, plain=True), or run inference under torch.no_grad() "
                               "or after requires_grad_(False)")
        plain = plain or live
        p = self._layouts(live=True) if live else self.weights(x.device)
        n, h, w, _ = x.shape
        hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
        x = x.to(torch.float32)
        if (hp, wp) != (h, w):
            x = x.index_select(1, _reflect_index(h, hp, x.device)).index_select(2, _reflect_index(w, wp, x.device))
        conv = K.conv_plain if plain else K.conv
        feat = conv(x.contiguous(), p["conv_in"])
        body = feat
        for st in p["stages"]:
            body = _stage(body, st, plain)
        out = conv(body, p["conv_out"], residual=feat)
        return out[:, :h, :w, :]


def _jax_t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def _jax_conv_w(k) -> torch.Tensor:
    """A JAX (kh, kw, in, out) kernel as the reference's (out, in, kh, kw)."""
    return _jax_t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _jax_dense_w(k) -> torch.Tensor:
    """A JAX (in, out) kernel as the reference's (out, in)."""
    return _jax_t(np.asarray(k).T)


def jax_msab_into(sd: dict, prefix: str, q) -> None:
    """Write a JAX MSAB param tree ``q`` (``attn_i``, ``norm_i``, ``ff_i``)
    into ``sd`` under the reference names of ``prefix.blocks.i``."""
    for i in range(sum(1 for k in q if k.startswith("attn_"))):
        a, f = f"{prefix}.blocks.{i}.0", f"{prefix}.blocks.{i}.1"
        at = q[f"attn_{i}"]
        for name in ("to_q", "to_k", "to_v"):
            sd[f"{a}.{name}.weight"] = _jax_dense_w(at[name]["kernel"])
        sd[f"{a}.rescale"] = _jax_t(at["rescale"])
        sd[f"{a}.proj.weight"] = _jax_dense_w(at["proj"]["kernel"])
        sd[f"{a}.proj.bias"] = _jax_t(at["proj"]["bias"])
        sd[f"{a}.pos_emb.0.weight"] = _jax_conv_w(at["pos_emb_0"]["kernel"])
        sd[f"{a}.pos_emb.2.weight"] = _jax_conv_w(at["pos_emb_2"]["kernel"])
        sd[f"{f}.norm.weight"] = _jax_t(q[f"norm_{i}"]["scale"])
        sd[f"{f}.norm.bias"] = _jax_t(q[f"norm_{i}"]["bias"])
        for j in (0, 2, 4):
            sd[f"{f}.fn.net.{j}.weight"] = _jax_conv_w(q[f"ff_{i}"][f"net_{j}"]["kernel"])


def jax_up_into(sd: dict, prefix: str, q) -> None:
    """Write a JAX decoder up-convolution (a 1x1 kernel to (dy, dx, out)
    channels and its bias) into ``sd`` as ``prefix.weight`` (in, out, 2, 2)
    and ``prefix.bias`` (out, 2, 2), the four bias copies kept apart."""
    k = np.asarray(q["kernel"])[0, 0]  # (in, (dy, dx, out))
    half = k.shape[1] // 4
    sd[f"{prefix}.weight"] = _jax_t(np.transpose(k.reshape(-1, 2, 2, half), (0, 3, 1, 2)))
    sd[f"{prefix}.bias"] = _jax_t(np.transpose(np.asarray(q["bias"]).reshape(2, 2, half), (2, 0, 1)))


def from_jax_params(params) -> dict[str, torch.Tensor]:
    """The port's state dict of a JAX ``MSTPlusPlus`` param tree (the
    ``"params"`` collection, arrays or anything ``np.asarray`` takes), exact:
    the reference names and layouts, with each up-convolution's four bias
    copies kept apart as (half, 2, 2)."""
    sd: dict[str, torch.Tensor] = {}

    def mst(prefix, q, st=2):
        sd[f"{prefix}.embedding.weight"] = _jax_conv_w(q["embedding"]["kernel"])
        for i in range(st):
            jax_msab_into(sd, f"{prefix}.encoder_layers.{i}.0", q[f"enc_msab_{i}"])
            sd[f"{prefix}.encoder_layers.{i}.1.weight"] = _jax_conv_w(q[f"enc_down_{i}"]["kernel"])
        jax_msab_into(sd, f"{prefix}.bottleneck", q["bottleneck"])
        for i in range(st):
            jax_up_into(sd, f"{prefix}.decoder_layers.{i}.0", q[f"dec_up_{i}"])
            sd[f"{prefix}.decoder_layers.{i}.1.weight"] = _jax_conv_w(q[f"dec_fuse_{i}"]["kernel"])
            jax_msab_into(sd, f"{prefix}.decoder_layers.{i}.2", q[f"dec_msab_{i}"])
        sd[f"{prefix}.mapping.weight"] = _jax_conv_w(q["mapping"]["kernel"])

    sd["conv_in.weight"] = _jax_conv_w(params["conv_in"]["kernel"])
    sd["conv_out.weight"] = _jax_conv_w(params["conv_out"]["kernel"])
    for i in range(sum(1 for k in params if k.startswith("body_"))):
        mst(f"body.{i}", params[f"body_{i}"])
    return sd


def load_state(path) -> dict[str, torch.Tensor]:
    """A state dict from a ``.pth``/``.pt`` file in either layout (a
    ``{"state_dict": ...}`` wrapper and ``module.`` prefixes are removed)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k.removeprefix("module."): v for k, v in sd.items()}


def load_shipped(device: str | torch.device = "cuda") -> MSTPlusPlus:
    """``MSTPlusPlus`` with the shipped ``synth_v1`` weights, for inference
    on ``device`` (the CUDA card unless the caller asks for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    model = MSTPlusPlus()
    model.load_state_dict(load_state(SHIPPED))
    return model.requires_grad_(False).eval().to(device)
