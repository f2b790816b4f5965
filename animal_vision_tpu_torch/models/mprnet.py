"""MPRNet: three progressive stages over a multi-patch hierarchy.

Counterpart of ``animal_vision_tpu/models/mprnet.py``, the registry's
``"mprnet"``: ``MPRNet(num_cab=4)``, 31 features. ``conv_in`` takes the
frame to 31 channels; stage 1 runs a U-Net encoder on the four quarter
patches and its decoder on the two half patches, stage 2 the encoder (with
cross-stage fusion) on the halves and the decoder on the whole, each stage
handing on through a supervised attention module (SAM); stage 3 is the
original-resolution ORSNet. Channel-attention blocks (CAB, reduction 1)
throughout; bilinear resizes with ``align_corners=False`` and no antialias.

Reference quirks kept:
- one ``nn.PReLU`` object serves every CAB of the network (the reference
  makes one ``act`` and hands it to every block; the JAX module keeps a
  copy per site and its docstring says so, ``mprnet.py:7`` and
  ``PReLUShared`` at ``:28-30``). The state dict names it under every CAB
  (``....body.1.weight``), as the reference's does;
  ``from_jax_params`` raises if the JAX copies differ;
- the frame is reflect-padded to multiples of 8 and the output cropped
  (``mprnet.py:195-197``, ``:244``).
"""

from __future__ import annotations

import torch
from torch import nn

from animal_vision_tpu_torch.models.common import ZooNet, conv, jax_conv_into, jax_vec_into, shared_value


class CALayer(nn.Module):
    def __init__(self, channel: int, reduction: int = 1):
        super().__init__()
        self.conv_du = nn.Sequential(conv(channel, channel // reduction, 1), nn.ReLU(),
                                     conv(channel // reduction, channel, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.conv_du(x.mean(dim=(2, 3), keepdim=True))


class CAB(nn.Module):
    def __init__(self, n_feat: int, act: nn.PReLU):
        super().__init__()
        self.body = nn.Sequential(conv(n_feat, n_feat, 3), act, conv(n_feat, n_feat, 3))
        self.CA = CALayer(n_feat)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.CA(self.body(x)) + x


class SAM(nn.Module):
    def __init__(self, n_feat: int):
        super().__init__()
        self.conv1 = conv(n_feat, n_feat, 1)
        self.conv2 = conv(n_feat, 31, 1)
        self.conv3 = conv(31, n_feat, 1)

    def forward(self, x: torch.Tensor, x_img: torch.Tensor) -> torch.Tensor:
        img = self.conv2(x) + x_img
        return self.conv1(x) * torch.sigmoid(self.conv3(img)) + x


def _bilinear(scale: float) -> nn.Upsample:
    return nn.Upsample(scale_factor=scale, mode="bilinear", align_corners=False)


class DownSample(nn.Module):
    """A bilinear half-size resize, then a 1x1 convolution."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.down = nn.Sequential(_bilinear(0.5), conv(cin, cout, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(x)


class UpSample(nn.Module):
    """A bilinear double-size resize, then a 1x1 convolution."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.up = nn.Sequential(_bilinear(2.0), conv(cin, cout, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.up(x)


class Encoder(nn.Module):
    def __init__(self, n_feat: int, scale: int, act: nn.PReLU, csff: bool):
        super().__init__()
        f = (n_feat, n_feat + scale, n_feat + 2 * scale)
        for lvl in range(3):
            setattr(self, f"encoder_level{lvl + 1}", nn.Sequential(CAB(f[lvl], act), CAB(f[lvl], act)))
        self.down12 = DownSample(f[0], f[1])
        self.down23 = DownSample(f[1], f[2])
        if csff:
            for lvl in range(3):
                setattr(self, f"csff_enc{lvl + 1}", conv(f[lvl], f[lvl], 1))
                setattr(self, f"csff_dec{lvl + 1}", conv(f[lvl], f[lvl], 1))

    def forward(self, x: torch.Tensor, encoder_outs=None, decoder_outs=None) -> list[torch.Tensor]:
        outs = []
        for lvl in range(3):
            if lvl:
                x = (self.down12, self.down23)[lvl - 1](x)
            x = getattr(self, f"encoder_level{lvl + 1}")(x)
            if encoder_outs is not None:
                x = x + getattr(self, f"csff_enc{lvl + 1}")(encoder_outs[lvl]) \
                      + getattr(self, f"csff_dec{lvl + 1}")(decoder_outs[lvl])
            outs.append(x)
        return outs


class Decoder(nn.Module):
    def __init__(self, n_feat: int, scale: int, act: nn.PReLU):
        super().__init__()
        f = (n_feat, n_feat + scale, n_feat + 2 * scale)
        for lvl in range(3):
            setattr(self, f"decoder_level{lvl + 1}", nn.Sequential(CAB(f[lvl], act), CAB(f[lvl], act)))
        self.skip_attn1 = CAB(f[0], act)
        self.skip_attn2 = CAB(f[1], act)
        self.up21 = UpSample(f[1], f[0])
        self.up32 = UpSample(f[2], f[1])

    def forward(self, outs: list[torch.Tensor]) -> list[torch.Tensor]:
        enc1, enc2, enc3 = outs
        dec3 = self.decoder_level3(enc3)
        dec2 = self.decoder_level2(self.up32(dec3) + self.skip_attn2(enc2))
        dec1 = self.decoder_level1(self.up21(dec2) + self.skip_attn1(enc1))
        return [dec1, dec2, dec3]


class ORB(nn.Module):
    def __init__(self, n_feat: int, act: nn.PReLU, num_cab: int):
        super().__init__()
        self.body = nn.Sequential(*(CAB(n_feat, act) for _ in range(num_cab)), conv(n_feat, n_feat, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x) + x


class ORSNet(nn.Module):
    def __init__(self, n_feat: int, scale_ors: int, act: nn.PReLU, scale_unet: int, num_cab: int):
        super().__init__()
        fo = n_feat + scale_ors
        self.orb1, self.orb2, self.orb3 = (ORB(fo, act, num_cab) for _ in range(3))
        self.up_enc1 = UpSample(n_feat + scale_unet, n_feat)
        self.up_dec1 = UpSample(n_feat + scale_unet, n_feat)
        self.up_enc2 = nn.Sequential(UpSample(n_feat + 2 * scale_unet, n_feat + scale_unet),
                                     UpSample(n_feat + scale_unet, n_feat))
        self.up_dec2 = nn.Sequential(UpSample(n_feat + 2 * scale_unet, n_feat + scale_unet),
                                     UpSample(n_feat + scale_unet, n_feat))
        for name in ("enc1", "enc2", "enc3", "dec1", "dec2", "dec3"):
            setattr(self, f"conv_{name}", conv(n_feat, fo, 1))

    def forward(self, x: torch.Tensor, enc: list[torch.Tensor], dec: list[torch.Tensor]) -> torch.Tensor:
        x = self.orb1(x)
        x = x + self.conv_enc1(enc[0]) + self.conv_dec1(dec[0])
        x = self.orb2(x)
        x = x + self.conv_enc2(self.up_enc1(enc[1])) + self.conv_dec2(self.up_dec1(dec[1]))
        x = self.orb3(x)
        return x + self.conv_enc3(self.up_enc2(enc[2])) + self.conv_dec3(self.up_dec2(dec[2]))


class MPRNet(ZooNet):
    PAD = 8

    def __init__(self, in_c: int = 31, out_c: int = 31, n_feat: int = 31, scale_unet: int = 31,
                 scale_orsnetfeats: int = 31, num_cab: int = 4):
        super().__init__()
        act = nn.PReLU()
        self.conv_in = conv(3, in_c, 3)
        for i in (1, 2, 3):
            setattr(self, f"shallow_feat{i}", nn.Sequential(conv(in_c, n_feat, 3), CAB(n_feat, act)))
        self.stage1_encoder = Encoder(n_feat, scale_unet, act, csff=False)
        self.stage1_decoder = Decoder(n_feat, scale_unet, act)
        self.stage2_encoder = Encoder(n_feat, scale_unet, act, csff=True)
        self.stage2_decoder = Decoder(n_feat, scale_unet, act)
        self.stage3_orsnet = ORSNet(n_feat, scale_orsnetfeats, act, scale_unet, num_cab)
        self.sam12 = SAM(n_feat)
        self.sam23 = SAM(n_feat)
        self.concat12 = conv(2 * n_feat, n_feat, 3)
        self.concat23 = conv(2 * n_feat, n_feat + scale_orsnetfeats, 3)
        self.tail = conv(n_feat + scale_orsnetfeats, out_c, 3)

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        x3_img = self.conv_in(x)
        hh, ww = x3_img.shape[2], x3_img.shape[3]
        top, bot = x3_img[:, :, :hh // 2], x3_img[:, :, hh // 2:]
        quads = [top[..., :ww // 2], top[..., ww // 2:], bot[..., :ww // 2], bot[..., ww // 2:]]
        feats = [self.stage1_encoder(self.shallow_feat1(q)) for q in quads]
        feat1_top = [torch.cat([a, b], dim=3) for a, b in zip(feats[0], feats[1])]
        feat1_bot = [torch.cat([a, b], dim=3) for a, b in zip(feats[2], feats[3])]
        res1_top = self.stage1_decoder(feat1_top)
        res1_bot = self.stage1_decoder(feat1_bot)
        top_sam = self.sam12(res1_top[0], top)
        bot_sam = self.sam12(res1_bot[0], bot)
        top_cat = self.concat12(torch.cat([self.shallow_feat2(top), top_sam], dim=1))
        bot_cat = self.concat12(torch.cat([self.shallow_feat2(bot), bot_sam], dim=1))
        feat2_top = self.stage2_encoder(top_cat, feat1_top, res1_top)
        feat2_bot = self.stage2_encoder(bot_cat, feat1_bot, res1_bot)
        feat2 = [torch.cat([a, b], dim=2) for a, b in zip(feat2_top, feat2_bot)]
        res2 = self.stage2_decoder(feat2)
        x3_sam = self.sam23(res2[0], x3_img)
        x3_cat = self.concat23(torch.cat([self.shallow_feat3(x3_img), x3_sam], dim=1))
        x3_cat = self.stage3_orsnet(x3_cat, feat2, res2)
        return self.tail(x3_cat) + x3_img


def from_jax_params(params) -> dict[str, torch.Tensor]:
    """The inverse of the JAX ``convert_torch_state``. Every CAB's PReLU
    slope goes under its own key; they must all be equal (one shared
    module)."""
    sd: dict[str, torch.Tensor] = {}

    def cab(key, q):
        jax_conv_into(sd, f"{key}.body.0", q["body_0"])
        jax_vec_into(sd, f"{key}.body.1.weight", q["act"]["weight"])
        jax_conv_into(sd, f"{key}.body.2", q["body_2"])
        jax_conv_into(sd, f"{key}.CA.conv_du.0", q["ca"]["du_0"])
        jax_conv_into(sd, f"{key}.CA.conv_du.2", q["ca"]["du_2"])

    def encoder(key, q):
        for lvl in (1, 2, 3):
            for j in (0, 1):
                cab(f"{key}.encoder_level{lvl}.{j}", q[f"l{lvl}_{j}"])
            if f"csff_enc{lvl}" in q:
                jax_conv_into(sd, f"{key}.csff_enc{lvl}", q[f"csff_enc{lvl}"])
                jax_conv_into(sd, f"{key}.csff_dec{lvl}", q[f"csff_dec{lvl}"])
        jax_conv_into(sd, f"{key}.down12.down.1", q["down12"])
        jax_conv_into(sd, f"{key}.down23.down.1", q["down23"])

    def decoder(key, q):
        for lvl in (1, 2, 3):
            for j in (0, 1):
                cab(f"{key}.decoder_level{lvl}.{j}", q[f"l{lvl}_{j}"])
        cab(f"{key}.skip_attn1", q["skip_attn1"])
        cab(f"{key}.skip_attn2", q["skip_attn2"])
        jax_conv_into(sd, f"{key}.up32.up.1", q["up32"])
        jax_conv_into(sd, f"{key}.up21.up.1", q["up21"])

    def orb(key, q):
        n = sum(1 for k in q if k.startswith("cab_"))
        for i in range(n):
            cab(f"{key}.body.{i}", q[f"cab_{i}"])
        jax_conv_into(sd, f"{key}.body.{n}", q["tail"])

    for name in ("conv_in", "concat12", "concat23", "tail"):
        jax_conv_into(sd, name, params[name])
    for s in ("sam12", "sam23"):
        for j in (1, 2, 3):
            jax_conv_into(sd, f"{s}.conv{j}", params[s][f"conv{j}"])
    encoder("stage1_encoder", params["stage1_encoder"])
    encoder("stage2_encoder", params["stage2_encoder"])
    decoder("stage1_decoder", params["stage1_decoder"])
    decoder("stage2_decoder", params["stage2_decoder"])
    ors = params["stage3_orsnet"]
    for name in ("orb1", "orb2", "orb3"):
        orb(f"stage3_orsnet.{name}", ors[name])
    for name in ("enc1", "dec1"):
        jax_conv_into(sd, f"stage3_orsnet.up_{name}.up.1", ors[f"up_{name}"]["conv"])
    for name in ("enc2", "dec2"):
        for j in (0, 1):
            jax_conv_into(sd, f"stage3_orsnet.up_{name}.{j}.up.1", ors[f"up_{name}_{j}"]["conv"])
    for name in ("enc1", "enc2", "enc3", "dec1", "dec2", "dec3"):
        jax_conv_into(sd, f"stage3_orsnet.conv_{name}", ors[f"conv_{name}"])
    for i in (1, 2, 3):
        jax_conv_into(sd, f"shallow_feat{i}.0", params[f"shallow_feat{i}_conv"])
        cab(f"shallow_feat{i}.1", params[f"shallow_feat{i}_cab"])
    shared_value(sd, [k for k in sd if k.endswith(".body.1.weight")])
    return sd
