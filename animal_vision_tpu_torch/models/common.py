"""What the zoo's convolutional methods share: the frame interface and the
weight converters' inverses.

Every zoo network here takes and returns channels-last frames, (N, H, W, 3)
float32 -> (N, H, W, 31), like ``MSTModel``, and runs in PyTorch's NCHW
idiom inside. ``ZooNet.forward`` checks the frames, reflect-pads the bottom
and right edges to the network's multiple (numpy's ``mode="reflect"``, as
the JAX modules pad), runs ``forward_nchw`` on the NCHW view with cuDNN's TF32 off,
and crops. These networks run in XLA in the JAX package, outside any Pallas
kernel, so they stay ``F.conv2d``, ``torch.matmul`` and ``torch.softmax``.

The ``jax_*`` helpers write one JAX param node into a state dict under the
reference names: the inverse of the JAX converters' ``_conv_w``,
``_dense_w`` and of their bias, norm and PReLU entries.
"""

from __future__ import annotations

import torch
from torch import nn

from animal_vision_tpu_torch.models.mst import _full_float32
from animal_vision_tpu_torch.models.mst_plus_plus import _jax_conv_w, _jax_dense_w, _jax_t, _reflect_index


class ZooNet(nn.Module):
    """Base of the zoo's networks: ``forward`` (N, H, W, 3) -> (N, H, W, 31)
    around ``forward_nchw`` (N, 3, Hp, Wp) -> (N, 31, Hp, Wp), Hp and Wp the frame
    padded to multiples of ``PAD``."""

    PAD = 1

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def idle_keys(self) -> list[str]:
        """Names of parameters that the reference layout holds and the
        forward never reads (the JAX module does not create them)."""
        return []

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """(N, H, W, 3) -> (N, H, W, 31). ``plain`` is accepted as the MST
        models take it; a zoo network is plain PyTorch either way."""
        if x.dim() != 4 or x.shape[-1] != 3:
            raise ValueError(f"{type(self).__name__} takes (N, H, W, 3) frames, got {tuple(x.shape)}")
        weight = next(self.parameters())
        if x.device != weight.device:
            raise ValueError(f"frames on {x.device}, model on {weight.device}")
        n, h, w, _ = x.shape
        hp, wp = -(-h // self.PAD) * self.PAD, -(-w // self.PAD) * self.PAD
        x = x.to(torch.float32)
        if (hp, wp) != (h, w):
            x = x.index_select(1, _reflect_index(h, hp, x.device)).index_select(2, _reflect_index(w, wp, x.device))
        with _full_float32():
            y = self.forward_nchw(x.permute(0, 3, 1, 2).contiguous())
        return y[:, :, :h, :w].permute(0, 2, 3, 1).contiguous()


def conv(cin: int, cout: int, k: int, bias: bool = False, groups: int = 1) -> nn.Conv2d:
    """A k x k convolution, stride 1, zero padding k // 2."""
    return nn.Conv2d(cin, cout, k, padding=k // 2, bias=bias, groups=groups)


def jax_conv_into(sd: dict, key: str, node) -> None:
    """A JAX ``{"kernel", ["bias"]}`` node as ``key.weight`` (out, in, kh, kw)
    and ``key.bias``."""
    sd[f"{key}.weight"] = _jax_conv_w(node["kernel"])
    if "bias" in node:
        sd[f"{key}.bias"] = _jax_t(node["bias"])


def jax_dense_into(sd: dict, key: str, node) -> None:
    """A JAX Dense kernel (in, out) as ``key.weight`` (out, in)."""
    sd[f"{key}.weight"] = _jax_dense_w(node["kernel"])


def jax_vec_into(sd: dict, key: str, value) -> None:
    """A JAX vector (a PReLU slope, a norm's scale or bias) as ``key``."""
    sd[key] = _jax_t(value)


def shared_value(sd: dict, keys: list[str]) -> torch.Tensor:
    """The one value that the state dict's ``keys`` (the sites of one
    shared module) hold; raises if the sites differ, since the port's
    shared module cannot hold them apart."""
    first = sd[keys[0]]
    for k in keys[1:]:
        if not torch.equal(sd[k], first):
            raise ValueError(f"{k} differs from {keys[0]}: the reference shares one module between these sites")
    return first
