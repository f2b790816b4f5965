"""The MST++ kernels: wrappers, plain versions, launch counters.

Counterpart of ``animal_vision_tpu/ops/fused_msab.py``. Four functions
carry every convolution and MSAB block of ``models/mst_plus_plus.py`` on
(N, H, W, C) float32 frames:

- ``conv``: a K x K convolution with zero pad 1, no bias, an optional
  residual added to its output: 3x3 stride 1 (``conv_in`` 3 -> 31, the
  stage embeddings and mappings, ``conv_out``) and 4x4 stride 2 (the
  encoder's downsamples C -> 2C). It replaces the Pallas
  ``_conv3_io_kernel``, ``_conv3_kernel``, ``_conv3_res_kernel``,
  ``_conv3_stats_kernel``, ``_down4_kernel`` and ``_down4_stats_kernel``;
- ``attn_stats``: MSAB pass A, per frame q = x Wq, k = x Wk, the
  head-diagonal blocks of G = k^T q and the squared norms sum q^2, sum k^2
  over every pixel. It replaces ``_stats_kernel`` (and the stats the TPU
  producers accumulate in ``_accum_stats``);
- ``msab_apply``: MSAB pass B, pos = dw3(gelu(dw3(x Wv))),
  res1 = x M + b + pos + x, then LayerNorm and the FFN
  (1x1 C -> 4C, GELU, depthwise 3x3, GELU, 1x1 4C -> C) plus res1. It
  replaces ``_apply_kernel``;
- ``up_fuse``: the decoder's 2x2 stride-2 transposed convolution (one bias
  per (dy, dx, out)), depth-to-space and the 1x1 fuse over [up | skip]. It
  replaces ``_up_fuse_kernel`` and ``_up_fuse_stats_kernel``.

Between pass A and pass B, ``attn_matrix`` (the counterpart of the XLA
glue ``_attn_blockdiag``) folds the stats into M = Wv A Wproj with plain
PyTorch on the frames' device: normalize, rescale, softmax, block-diagonal
A. It copies nothing to the host.

On a CUDA tensor each wrapper launches its CUDA C++ kernel from
``csrc/fused_msab.cu`` or raises; on a CPU tensor it takes its plain
version. Nothing falls back. The TPU pixel packing, neighbour-pack
matrices, GELU polynomial and bf16 products are not carried over: the
kernels compute in float32 with ``erff``.

Weights are in the layouts the kernels read, made once per model by
``models/mst_plus_plus.py``: a convolution as (K, K, Cin, Cout), a 1x1
map as (in, out), a depthwise 3x3 as (3, 3, C).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from animal_vision_tpu_torch.core import linalg
from animal_vision_tpu_torch.ops import _build

#: Kernel launches, one per wrapper call (plain-version calls are not counted).
LAUNCHES = {"conv_kernel": 0, "attn_stats_kernel": 0, "msab_apply_kernel": 0, "up_fuse_kernel": 0}

#: Per-frame blocks of the stats kernel's first stage: the partial sums a
#: frame is reduced from, in a fixed order (a function of the pixel count
#: only, so a frame gets the same bits alone and in a batch).
STATS_TILE = 32
STATS_BLOCKS = 256
HEAD_DIM = 31
#: Channel counts the MSAB kernels are built for (the three MST++ levels).
MSAB_CHANNELS = (31, 62, 124)

_P = ctypes.c_void_p
_I = ctypes.c_int


class MsabWeights(NamedTuple):
    """One MSAB block's weights in kernel layouts (C channels, heads of 31)."""

    heads: int
    wq: torch.Tensor  # (C, C), in -> out
    wk: torch.Tensor  # (C, C)
    wv: torch.Tensor  # (C, C)
    rescale: torch.Tensor  # (heads,)
    wproj: torch.Tensor  # (C, C)
    bproj: torch.Tensor  # (C,)
    pos0: torch.Tensor  # (3, 3, C)
    pos2: torch.Tensor  # (3, 3, C)
    ln_w: torch.Tensor  # (C,)
    ln_b: torch.Tensor  # (C,)
    w0: torch.Tensor  # (C, 4C)
    dw: torch.Tensor  # (3, 3, 4C)
    w4: torch.Tensor  # (4C, C)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_msab")
    if lib.av_msab_conv.argtypes is None:
        lib.av_msab_conv.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        lib.av_msab_stats.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
        lib.av_msab_apply.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
        lib.av_msab_up_fuse.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
        for fn in (lib.av_msab_conv, lib.av_msab_stats, lib.av_msab_apply, lib.av_msab_up_fuse):
            fn.restype = ctypes.c_int
    return lib


def _frames(x: torch.Tensor, what: str, channels=None) -> None:
    if x.dim() != 4 or x.dtype != torch.float32:
        raise ValueError(f"{what} takes (N, H, W, C) float32 frames, got {tuple(x.shape)} {x.dtype}")
    if channels is not None and x.shape[-1] not in channels:
        raise ValueError(f"{what} takes C in {channels}, got {x.shape[-1]}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: frames on unsupported device {x.device}")


def _same_device(x: torch.Tensor, what: str, *tensors) -> None:
    for t in tensors:
        if t is not None and (t.device != x.device or t.dtype != torch.float32):
            raise ValueError(f"{what}: every operand must be float32 on {x.device}, got {t.dtype} on {t.device}")


def _ptr(t: torch.Tensor) -> int:
    """The address of a weight the kernel reads; a copy made here could be
    freed before the kernel runs, so weights must already be contiguous."""
    if not t.is_contiguous():
        raise ValueError(f"kernel operands must be contiguous, got strides {t.stride()}")
    return t.data_ptr()


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _dw3(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Depthwise 3x3 with zero pad 1 of (N, H, W, C) by (3, 3, C)."""
    h, w = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = None
    for dy in range(3):
        for dx in range(3):
            t = xp[:, dy:dy + h, dx:dx + w, :] * k[dy, dx]
            out = t if out is None else out + t
    return out


def conv_out_hw(h: int, w: int, ksize: int) -> tuple[int, int]:
    """Output size of ``conv`` for a (h, w) frame: the same for K = 3
    (stride 1), halved (floor) for K = 4 (stride 2); both pad 1."""
    stride = 1 if ksize == 3 else 2
    return (h + 2 - ksize) // stride + 1, (w + 2 - ksize) // stride + 1


def conv_plain(x: torch.Tensor, w: torch.Tensor, residual: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of ``conv``: a sum over the K x K taps of shifted
    frames times each tap's (Cin, Cout) matrix, one product per frame."""
    _check_conv(x, w, residual)
    k = int(w.shape[0])
    stride = 1 if k == 3 else 2
    ho, wo = conv_out_hw(x.shape[1], x.shape[2], k)
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    out = None
    for dy in range(k):
        for dx in range(k):
            tap = xp[:, dy:dy + stride * (ho - 1) + 1:stride, dx:dx + stride * (wo - 1) + 1:stride, :]
            t = linalg.frame_matmul(tap, w[dy, dx])
            out = t if out is None else out + t
    return out if residual is None else out + residual


def attn_stats_plain(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor, heads: int):
    """Plain version of ``attn_stats``: the full (C, C) Gram per frame, of
    which the head-diagonal blocks are returned."""
    _check_stats(x, wq, wk, heads)
    n, h, w, c = x.shape
    flat = x.reshape(n, h * w, c)
    q = torch.bmm(flat, wq.expand(n, c, c))
    k = torch.bmm(flat, wk.expand(n, c, c))
    g = torch.stack([kf.t() @ qf for kf, qf in zip(k, q)])  # per frame: the same bits alone and in a batch
    d = c // heads
    blocks = torch.stack([g[:, i * d:(i + 1) * d, i * d:(i + 1) * d] for i in range(heads)], dim=1)
    return blocks, (q * q).sum(dim=1), (k * k).sum(dim=1)


def msab_apply_plain(x: torch.Tensor, m: torch.Tensor, blk: MsabWeights) -> torch.Tensor:
    """Plain version of ``msab_apply``: its FFN is ``fused_mst.ffn_plain``."""
    from animal_vision_tpu_torch.ops import fused_mst  # it imports this module

    _check_apply(x, m, blk)
    n, h, w, c = x.shape
    pos = _dw3(F.gelu(_dw3(linalg.frame_matmul(x, blk.wv), blk.pos0)), blk.pos2)
    att = torch.bmm(x.reshape(n, h * w, c), m).reshape(x.shape)
    res1 = att + blk.bproj + pos + x
    return fused_mst.ffn_plain(res1, blk.ln_w, blk.ln_b, blk.w0, blk.dw, blk.w4)


def up_fuse_plain(fea: torch.Tensor, skip: torch.Tensor, wup: torch.Tensor, bup: torch.Tensor,
                  fuse: torch.Tensor) -> torch.Tensor:
    """Plain version of ``up_fuse``: the 1x1 map to (dy, dx, out) channels
    plus the bias, depth-to-space, then the 1x1 fuse of [up | skip]."""
    _check_up(fea, skip, wup, bup, fuse)
    n, h, w, c = fea.shape
    half = c // 2
    up = linalg.frame_matmul(fea, wup.reshape(c, 4 * half)) + bup.reshape(4 * half)
    up = up.reshape(n, h, w, 2, 2, half).permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * w, half)
    return linalg.frame_matmul(torch.cat([up, skip], dim=-1), fuse)


# ---------------------------------------------------------------------------
# The glue between pass A and pass B (plain PyTorch on every device)
# ---------------------------------------------------------------------------


def attn_matrix(g: torch.Tensor, sq: torch.Tensor, sk: torch.Tensor, rescale: torch.Tensor,
                wv: torch.Tensor, wproj: torch.Tensor) -> torch.Tensor:
    """(N, C, C) M = Wv A Wproj from the stats of ``attn_stats``: the Gram
    blocks divided by the norms (clamped at 1e-12), times each head's
    rescale, softmax over the q channels; A[h d + e, h d + o] = attn[h, o, e]."""
    n, heads, d, _ = g.shape
    qn = torch.clamp(torch.sqrt(sq), min=1e-12).reshape(n, heads, 1, d)
    kn = torch.clamp(torch.sqrt(sk), min=1e-12).reshape(n, heads, d, 1)
    attn = torch.softmax(g / (kn * qn) * rescale.reshape(1, heads, 1, 1), dim=-1)  # (n, h, o, e)
    eye = torch.eye(heads, dtype=g.dtype, device=g.device)
    a = torch.einsum("nhoe,hk->nheko", attn, eye).reshape(n, heads * d, heads * d)
    return torch.matmul(torch.matmul(wv, a), wproj)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check_conv(x, w, residual) -> None:
    _frames(x, "conv")
    if w.dim() != 4 or w.shape[0] != w.shape[1] or int(w.shape[0]) not in (3, 4) or w.shape[2] != x.shape[-1]:
        raise ValueError(f"conv takes a (K, K, Cin, Cout) weight with K 3 or 4 and Cin {x.shape[-1]}, "
                         f"got {tuple(w.shape)}")
    _same_device(x, "conv", w, residual)
    if residual is not None:
        ho, wo = conv_out_hw(x.shape[1], x.shape[2], int(w.shape[0]))
        if tuple(residual.shape) != (x.shape[0], ho, wo, w.shape[3]):
            raise ValueError(f"conv: residual {tuple(residual.shape)} is not the output's shape")


def conv(x: torch.Tensor, w: torch.Tensor, residual: torch.Tensor | None = None) -> torch.Tensor:
    """K x K convolution of (N, H, W, Cin) float32 frames by a
    (K, K, Cin, Cout) weight, zero pad 1, stride 1 (K = 3) or 2 (K = 4),
    no bias, plus ``residual`` (the output's shape) when given."""
    if x.device.type == "cpu":
        return conv_plain(x, w, residual)
    _check_conv(x, w, residual)
    n, h, wd, cin = x.shape
    k, cout = int(w.shape[0]), int(w.shape[3])
    ho, wo = conv_out_hw(h, wd, k)
    frames = x.contiguous()
    out = torch.empty((n, ho, wo, cout), dtype=torch.float32, device=x.device)
    res = None if residual is None else _ptr(residual)
    _build.launch(_lib(), "av_msab_conv", x.device, frames.data_ptr(), _ptr(w), res, out.data_ptr(),
                  n, h, wd, cin, cout, k)
    LAUNCHES["conv_kernel"] += 1
    return out


def _check_stats(x, wq, wk, heads) -> None:
    _frames(x, "attn_stats", MSAB_CHANNELS)
    c = x.shape[-1]
    if c != heads * HEAD_DIM or tuple(wq.shape) != (c, c) or tuple(wk.shape) != (c, c):
        raise ValueError(f"attn_stats: C {c} with {heads} heads of {HEAD_DIM} and (C, C) weights, "
                         f"got {tuple(wq.shape)}, {tuple(wk.shape)}")
    _same_device(x, "attn_stats", wq, wk)


def stats_blocks(npix: int) -> int:
    """First-stage blocks per frame of ``attn_stats`` for ``npix`` pixels."""
    return max(1, min(-(-npix // STATS_TILE), STATS_BLOCKS))


def attn_stats(x: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor, heads: int):
    """Per frame of (N, H, W, C) float32: the head-diagonal (31, 31) blocks
    of G = k^T q, shaped (N, heads, 31, 31) with G[o, e] = sum k_o q_e, and
    the squared norms sum q^2, sum k^2 (N, C), where q = x Wq, k = x Wk.

    The kernel sums in two fixed-order stages (per-block partials, then one
    reduction), so repeated runs give the same bits."""
    if x.device.type == "cpu":
        return attn_stats_plain(x, wq, wk, heads)
    _check_stats(x, wq, wk, heads)
    n, h, w, c = x.shape
    nblk = stats_blocks(h * w)
    size = c * HEAD_DIM + 2 * c
    part = torch.empty((n, nblk, size), dtype=torch.float32, device=x.device)
    out = torch.empty((n, size), dtype=torch.float32, device=x.device)
    frames = x.contiguous()
    _build.launch(_lib(), "av_msab_stats", x.device, frames.data_ptr(), _ptr(wq), _ptr(wk),
                  part.data_ptr(), out.data_ptr(), n, h * w, c, nblk)
    LAUNCHES["attn_stats_kernel"] += 1
    g = out[:, : c * HEAD_DIM].reshape(n, heads, HEAD_DIM, HEAD_DIM)
    return g, out[:, c * HEAD_DIM: c * HEAD_DIM + c], out[:, c * HEAD_DIM + c:]


def _check_apply(x, m, blk: MsabWeights) -> None:
    _frames(x, "msab_apply", MSAB_CHANNELS)
    n, c = x.shape[0], x.shape[-1]
    if tuple(m.shape) != (n, c, c) or tuple(blk.w0.shape) != (c, 4 * c) or tuple(blk.w4.shape) != (4 * c, c):
        raise ValueError(f"msab_apply: C {c}, M {tuple(m.shape)}, w0 {tuple(blk.w0.shape)}, "
                         f"w4 {tuple(blk.w4.shape)}")
    _same_device(x, "msab_apply", m, blk.wv, blk.bproj, blk.pos0, blk.pos2, blk.ln_w, blk.ln_b,
                 blk.w0, blk.dw, blk.w4)


def msab_apply(x: torch.Tensor, m: torch.Tensor, blk: MsabWeights) -> torch.Tensor:
    """MSAB pass B on (N, H, W, C) float32 frames with the per-frame
    (N, C, C) attention matrix ``m`` of ``attn_matrix``: res1 = x m + bproj
    + dw3(gelu(dw3(x Wv))) + x, out = W4 gelu(dw3(gelu(W0 LN(res1)))) +
    res1; every depthwise 3x3 zero-pads its own input."""
    if x.device.type == "cpu":
        return msab_apply_plain(x, m, blk)
    _check_apply(x, m, blk)
    n, h, w, c = x.shape
    frames = x.contiguous()
    out = torch.empty_like(frames)
    _build.launch(_lib(), "av_msab_apply", x.device, frames.data_ptr(), out.data_ptr(), _ptr(m),
                  _ptr(blk.wv), _ptr(blk.bproj), _ptr(blk.pos0), _ptr(blk.pos2), _ptr(blk.ln_w),
                  _ptr(blk.ln_b), _ptr(blk.w0), _ptr(blk.dw), _ptr(blk.w4), n, h, w, c)
    LAUNCHES["msab_apply_kernel"] += 1
    return out


def _check_up(fea, skip, wup, bup, fuse) -> None:
    _frames(fea, "up_fuse", (62, 124))
    n, h, w, c = fea.shape
    half = c // 2
    if (tuple(skip.shape) != (n, 2 * h, 2 * w, half) or tuple(wup.shape) != (c, 2, 2, half)
            or tuple(bup.shape) != (2, 2, half) or tuple(fuse.shape) != (2 * half, half)):
        raise ValueError(f"up_fuse: fea {tuple(fea.shape)}, skip {tuple(skip.shape)}, wup {tuple(wup.shape)}, "
                         f"bup {tuple(bup.shape)}, fuse {tuple(fuse.shape)}")
    _same_device(fea, "up_fuse", skip, wup, bup, fuse)


def up_fuse(fea: torch.Tensor, skip: torch.Tensor, wup: torch.Tensor, bup: torch.Tensor,
            fuse: torch.Tensor) -> torch.Tensor:
    """Decoder level of (N, H, W, C) ``fea`` and its (N, 2H, 2W, C/2)
    ``skip``: the 2x2 stride-2 transposed convolution with ``wup``
    (C, 2, 2, C/2) and one bias per (dy, dx, out) ``bup`` (2, 2, C/2),
    depth-to-space, then the 1x1 ``fuse`` (C, C/2) over [up | skip]."""
    if fea.device.type == "cpu":
        return up_fuse_plain(fea, skip, wup, bup, fuse)
    _check_up(fea, skip, wup, bup, fuse)
    n, h, w, c = fea.shape
    f, s = fea.contiguous(), skip.contiguous()
    out = torch.empty((n, 2 * h, 2 * w, c // 2), dtype=torch.float32, device=fea.device)
    _build.launch(_lib(), "av_msab_up_fuse", fea.device, f.data_ptr(), s.data_ptr(), out.data_ptr(),
                  _ptr(wup), _ptr(bup), _ptr(fuse), n, h, w, c)
    LAUNCHES["up_fuse_kernel"] += 1
    return out
