"""The MST++ kernels: wrappers, plain versions, launch counters.

Counterpart of ``animal_vision_tpu/ops/fused_msab.py``. Four functions
carry every convolution and MSAB block of ``models/mst_plus_plus.py`` on
(N, H, W, C) float32 frames:

- ``conv``: a K x K convolution with zero pad 1, no bias, an optional
  residual added to its output: 3x3 stride 1 (``conv_in`` 3 -> 31, the
  stage embeddings and mappings, ``conv_out``) and 4x4 stride 2 (the
  encoder's downsamples C -> 2C), as an implicit GEMM on the tensor cores
  in 3xTF32 (``csrc/mma_tf32.cuh``). It replaces the Pallas
  ``_conv3_io_kernel``, ``_conv3_kernel``, ``_conv3_res_kernel``,
  ``_conv3_stats_kernel``, ``_down4_kernel`` and ``_down4_stats_kernel``;
- ``attn_stats``: MSAB pass A, per frame q = x Wq, k = x Wk, the
  head-diagonal blocks of G = k^T q and the squared norms sum q^2, sum k^2
  over every pixel, with q, k and G on the tensor cores in 3xTF32 (one
  block per run of pixel tiles and head; ``stats_blocks`` fixes the runs
  per frame, and a second kernel adds the blocks' partial sums in a fixed
  order). It replaces ``_stats_kernel`` (and the stats the TPU producers
  accumulate in ``_accum_stats``);
- ``msab_apply``: MSAB pass B in two kernels. ``msab_pos`` computes
  res1 = x M + b + dw3(gelu(dw3(x Wv))) + x (both products in 3xTF32, one
  output tile per C, ``POS_TILES``; ``pos_tile_for`` raises where two
  blocks of it do not fit an SM), then ``fused_mst.ffn`` (the MST-L FFN
  kernel) takes LayerNorm and the FFN (1x1 C -> 4C, GELU, depthwise 3x3,
  GELU, 1x1 4C -> C) plus res1. Together they replace ``_apply_kernel``.
  Splitting costs one device-memory round trip of res1 and keeps the
  pos kernel's halo at 2 pixels;
- ``up_fuse``: the decoder's 2x2 stride-2 transposed convolution (one bias
  per (dy, dx, out)), depth-to-space and the 1x1 fuse over [up | skip], as
  one 3xTF32 product per output parity with the transposed convolution
  folded into the fuse (``UpFuseWeights``, made once per model by
  ``up_fuse_weights``; one input tile per C, ``UP_TILES``; ``up_tile_for``
  raises where two blocks of it do not fit an SM). It replaces
  ``_up_fuse_kernel`` and ``_up_fuse_stats_kernel``.

Between pass A and pass B, ``attn_matrix`` (the counterpart of the XLA
glue ``_attn_blockdiag``) folds the stats into M = Wv A Wproj with plain
PyTorch on the frames' device: normalize, rescale, softmax, block-diagonal
A. It copies nothing to the host.

On a CUDA tensor each wrapper launches its CUDA C++ kernel from
``csrc/fused_msab.cu`` or raises; on a CPU tensor it takes its plain
version. Nothing falls back. The TPU pixel packing, neighbour-pack
matrices, GELU polynomial and bf16 products are not carried over: the
kernels compute in float32 with ``erff`` (every product in 3xTF32: each
operand split into two TF32 parts, the sum in float32).

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

#: Blocks per frame and head of the stats kernel's first stage: the partial
#: sums a frame is reduced from, in a fixed order (a function of the pixel
#: count only, so a frame gets the same bits alone and in a batch): one per
#: STATS_TILE pixels, up to 1024, so that one 1080p frame fills the card.
STATS_TILE = 64
STATS_BLOCKS = 1024
HEAD_DIM = 31
#: Channel counts the MSAB kernels are built for (the three MST++ levels).
MSAB_CHANNELS = (31, 62, 124)
#: The output tile (rows, columns) of the pos kernel at each C (``PosTile``
#: in ``csrc/fused_msab.cu``): the largest of which two blocks fit an H100 SM.
POS_TILES = {31: (8, 16), 62: (8, 8), 124: (4, 8)}
#: (K, Cin, Cout) the convolution kernel is built for: conv_in, the 3x3
#: C -> C maps, the two 4x4 stride-2 downsamples.
CONV_SHAPES = ((3, 3, 31), (3, 31, 31), (4, 31, 62), (4, 62, 124))
#: The input tile (rows, columns) of the up-fuse kernel at each C (``UpTile``
#: in ``csrc/fused_msab.cu``): the largest of which two blocks fit an H100 SM.
UP_TILES = {62: (8, 8), 124: (4, 8)}
#: Rows of W' per parity in each weight slab of the up-fuse kernel.
UP_FEA_SLICE = {62: 32, 124: 16}

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


class UpFuseWeights(NamedTuple):
    """One decoder level's weights (C channels in, C/2 out): the raw ones,
    which the plain version reads, and the composed ones the kernel reads
    (None in ``up_fuse_raw``'s, which only the plain version takes)."""

    wup: torch.Tensor  # (C, 2, 2, C/2), the transposed convolution
    bup: torch.Tensor  # (2, 2, C/2), its bias per (dy, dx, out)
    fuse: torch.Tensor  # (C, C/2), the 1x1 fuse over [up | skip]
    wc: torch.Tensor | None  # (2, 2, C, C/2): wup[:, dy, dx] fuse[:C/2]
    bc: torch.Tensor | None  # (2, 2, C/2): bup[dy, dx] fuse[:C/2]
    wskip: torch.Tensor | None  # (C/2, C/2): fuse[C/2:]
    packed: torch.Tensor | None  # (4 CF + HP, NP): wc and wskip as the kernel reads them (``_pack_up``)


def _up_dims(c: int) -> tuple[int, int, int]:
    """(CF, HP, NP): C and C/2 rounded up to 32 (the kernel's fea and skip
    depths) and the output columns, C/2 rounded up to 32."""
    half = c // 2
    return -(-c // 32) * 32, -(-half // 32) * 32, -(-half // 32) * 32


def _pack_up(wc: torch.Tensor, wskip: torch.Tensor) -> torch.Tensor:
    """The up-fuse kernel's weight slabs in the order it streams them: for
    each slice of ``UP_FEA_SLICE`` rows, that slice of wc[d] for the four
    parities d = 2 dy + dx; then wskip; zero-padded to CF, HP rows and NP
    columns."""
    c, half = int(wc.shape[2]), int(wc.shape[3])
    cf, hp, np_ = _up_dims(c)
    kf = UP_FEA_SLICE[c]
    wf = torch.zeros(4, cf, np_, dtype=wc.dtype, device=wc.device)
    wf[:, :c, :half] = wc.reshape(4, c, half)
    ws = torch.zeros(hp, np_, dtype=wc.dtype, device=wc.device)
    ws[:half, :half] = wskip
    return torch.cat([wf.reshape(4, cf // kf, kf, np_).transpose(0, 1).reshape(4 * cf, np_), ws]).contiguous()


def up_fuse_weights(wup: torch.Tensor, bup: torch.Tensor, fuse: torch.Tensor) -> UpFuseWeights:
    """The decoder level's ``UpFuseWeights``: the transposed convolution
    folded into the fuse, composed in float64 (no TF32 on any device) and
    rounded once to float32, on the weights' device."""
    c, half = int(wup.shape[0]), int(wup.shape[-1])
    if (c not in UP_TILES or tuple(wup.shape) != (c, 2, 2, half) or half != c // 2 or tuple(bup.shape) != (2, 2, half)
            or tuple(fuse.shape) != (c, half)):
        raise ValueError(f"up_fuse_weights: C in {tuple(UP_TILES)}; wup {tuple(wup.shape)}, bup {tuple(bup.shape)}, "
                         f"fuse {tuple(fuse.shape)}")
    f_up = fuse[:half].double()
    wc = torch.matmul(wup.double().permute(1, 2, 0, 3), f_up).float().contiguous()
    bc = torch.matmul(bup.double(), f_up).float().contiguous()
    wskip = fuse[half:].contiguous()
    return UpFuseWeights(wup.contiguous(), bup.contiguous(), fuse.contiguous(), wc, bc, wskip, _pack_up(wc, wskip))


def up_fuse_raw(wup: torch.Tensor, bup: torch.Tensor, fuse: torch.Tensor) -> UpFuseWeights:
    """The decoder level's raw weights alone, for ``up_fuse_plain``: nothing
    is composed or copied, so gradients flow to the tensors given (the
    differentiable forward of ``models/mst_plus_plus.py``)."""
    return UpFuseWeights(wup, bup, fuse, None, None, None, None)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_msab")
    if lib.av_msab_conv.argtypes is None:
        lib.av_msab_conv.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        lib.av_msab_stats.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
        lib.av_msab_pos.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        lib.av_msab_up_fuse.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        lib.av_msab_conv_smem.argtypes = [_I, _I, _I]
        lib.av_msab_smem.argtypes = [_I, _I]
        for fn in (lib.av_msab_conv, lib.av_msab_stats, lib.av_msab_pos, lib.av_msab_up_fuse,
                   lib.av_msab_conv_smem, lib.av_msab_smem):
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


def msab_pos_plain(x: torch.Tensor, m: torch.Tensor, blk: MsabWeights) -> torch.Tensor:
    """Plain version of ``msab_pos``."""
    _check_pos(x, m, blk)
    n, h, w, c = x.shape
    pos = _dw3(F.gelu(_dw3(linalg.frame_matmul(x, blk.wv), blk.pos0)), blk.pos2)
    att = torch.bmm(x.reshape(n, h * w, c), m).reshape(x.shape)
    return att + blk.bproj + pos + x


def msab_apply_plain(x: torch.Tensor, m: torch.Tensor, blk: MsabWeights) -> torch.Tensor:
    """Plain version of ``msab_apply``: ``fused_mst.ffn_plain`` of
    ``msab_pos_plain``."""
    from animal_vision_tpu_torch.ops import fused_mst  # it imports this module

    _check_apply(x, m, blk)
    return fused_mst.ffn_plain(msab_pos_plain(x, m, blk), blk.ln_w, blk.ln_b, blk.w0, blk.dw, blk.w4)


def up_fuse_plain(fea: torch.Tensor, skip: torch.Tensor, uw: UpFuseWeights) -> torch.Tensor:
    """Plain version of ``up_fuse``, from the raw weights: the 1x1 map to
    (dy, dx, out) channels plus the bias, depth-to-space, then the 1x1 fuse
    of [up | skip] (two products, not the kernel's composed one)."""
    _check_up(fea, skip, uw, composed=False)
    n, h, w, c = fea.shape
    half = c // 2
    up = linalg.frame_matmul(fea, uw.wup.reshape(c, 4 * half)) + uw.bup.reshape(4 * half)
    up = up.reshape(n, h, w, 2, 2, half).permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * w, half)
    return linalg.frame_matmul(torch.cat([up, skip], dim=-1), uw.fuse)


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
    no bias, plus ``residual`` (the output's shape) when given. On the card
    (K, Cin, Cout) must be one of ``CONV_SHAPES``; the kernel is an implicit
    GEMM on the tensor cores in 3xTF32."""
    if x.device.type == "cpu":
        return conv_plain(x, w, residual)
    _check_conv(x, w, residual)
    n, h, wd, cin = x.shape
    k, cout = int(w.shape[0]), int(w.shape[3])
    if (k, cin, cout) not in CONV_SHAPES:
        raise ValueError(f"conv: the kernel is built for (K, Cin, Cout) in {CONV_SHAPES}, got {(k, cin, cout)}")
    if w.data_ptr() % 16:
        raise ValueError("conv: the weight must start on 16 bytes (the kernel copies its rows in 16-byte pieces)")
    ho, wo = conv_out_hw(h, wd, k)
    frames = x.contiguous()
    if frames.data_ptr() % 16:  # the kernel copies input rows in 8-byte pieces
        frames = frames.clone()
    out = torch.empty((n, ho, wo, cout), dtype=torch.float32, device=x.device)
    res = None if residual is None else _ptr(residual)
    _build.launch(_lib(), "av_msab_conv", x.device, frames.data_ptr(), _ptr(w), res, out.data_ptr(),
                  n, h, wd, cin, cout, k)
    LAUNCHES["conv_kernel"] += 1
    return out


def conv_smem_bytes(k: int, cin: int, cout: int) -> int:
    """Dynamic shared memory of one block of the convolution kernel for
    (K, Cin, Cout) in ``CONV_SHAPES``, in bytes (builds the library)."""
    if (k, cin, cout) not in CONV_SHAPES:
        raise ValueError(f"conv: the kernel is built for (K, Cin, Cout) in {CONV_SHAPES}, got {(k, cin, cout)}")
    return _lib().av_msab_conv_smem(k, cin, cout)


def _check_stats(x, wq, wk, heads) -> None:
    _frames(x, "attn_stats", MSAB_CHANNELS)
    c = x.shape[-1]
    if c != heads * HEAD_DIM or tuple(wq.shape) != (c, c) or tuple(wk.shape) != (c, c):
        raise ValueError(f"attn_stats: C {c} with {heads} heads of {HEAD_DIM} and (C, C) weights, "
                         f"got {tuple(wq.shape)}, {tuple(wk.shape)}")
    _same_device(x, "attn_stats", wq, wk)


def stats_blocks(npix: int) -> int:
    """First-stage blocks per frame and head of ``attn_stats`` for ``npix``
    pixels."""
    return max(1, min(-(-npix // STATS_TILE), STATS_BLOCKS))


def stats_tile(c: int) -> int:
    """Pixels per tile of the stats kernel at C = ``c`` (``Stats::P``)."""
    return 32 if c > 62 else 64


def stats_smem_bytes(c: int) -> int:
    """Shared memory of one block of the stats kernel at C = ``c``: two
    x tiles of ``stats_tile(c)`` pixels, the head's [q | k] over a tile and
    its [Wq | Wk] columns, at the kernel's padded pitches. Must equal
    ``Stats::SMEM_FLOATS`` in ``csrc/fused_msab.cu``."""
    cp, p = -(-c // 8) * 8, stats_tile(c)
    return 4 * (2 * p * (cp + 4) + p * 72 + cp * 72)


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
    if frames.data_ptr() % 16:  # the kernel copies pixel rows in 8- or 16-byte pieces
        frames = frames.clone()
    _build.launch(_lib(), "av_msab_stats", x.device, frames.data_ptr(), _ptr(wq), _ptr(wk),
                  part.data_ptr(), out.data_ptr(), n, h * w, c, nblk)
    LAUNCHES["attn_stats_kernel"] += 1
    g = out[:, : c * HEAD_DIM].reshape(n, heads, HEAD_DIM, HEAD_DIM)
    return g, out[:, c * HEAD_DIM: c * HEAD_DIM + c], out[:, c * HEAD_DIM + c:]


def _check_pos(x, m, blk: MsabWeights) -> None:
    _frames(x, "msab_pos", MSAB_CHANNELS)
    n, c = x.shape[0], x.shape[-1]
    shapes = tuple(tuple(t.shape) for t in (m, blk.wv, blk.bproj, blk.pos0, blk.pos2))
    if shapes != ((n, c, c), (c, c), (c,), (3, 3, c), (3, 3, c)):
        raise ValueError(f"msab_pos: C {c} takes M (N, C, C), wv (C, C), bproj (C,), pos0/pos2 (3, 3, C); "
                         f"got {shapes}")
    _same_device(x, "msab_pos", m, blk.wv, blk.bproj, blk.pos0, blk.pos2)


def _check_apply(x, m, blk: MsabWeights) -> None:
    _check_pos(x, m, blk)
    c = x.shape[-1]
    if tuple(blk.w0.shape) != (c, 4 * c) or tuple(blk.w4.shape) != (4 * c, c):
        raise ValueError(f"msab_apply: C {c}, w0 {tuple(blk.w0.shape)}, w4 {tuple(blk.w4.shape)}")
    _same_device(x, "msab_apply", blk.ln_w, blk.ln_b, blk.w0, blk.dw, blk.w4)


def pos_smem_bytes(c: int, tile: tuple[int, int]) -> int:
    """Shared memory of one block of the pos kernel: x over the tile with
    its 2-pixel halo, a 32-channel chunk of V over the same and of T over
    the 1-pixel halo, and the chunk's Wv and M columns, at the kernel's
    padded pitches. Must equal ``Pos::SMEM_FLOATS`` in
    ``csrc/fused_msab.cu``."""
    th, tw = tile
    cp = -(-c // 8) * 8
    n2, n1 = (th + 4) * (tw + 4), (th + 2) * (tw + 2)
    return 4 * (n2 * (cp + 4) + n2 * 40 + n1 * 32 + 2 * cp * 40)


def kernel_smem_bytes(kind: str, c: int) -> int:
    """Dynamic shared memory of one block of the ``"pos"``, ``"stats"`` or
    ``"up_fuse"`` kernel at C = ``c`` as the library reports it, in bytes
    (builds the library)."""
    return _lib().av_msab_smem({"pos": 0, "stats": 1, "up_fuse": 2}[kind], c)


def pos_tile_for(c: int, limit: int) -> tuple[int, int]:
    """The pos kernel's output tile at C = ``c``; raises when two blocks of
    it do not fit in ``limit`` bytes of one SM's shared memory
    (``fused_mst.smem_limit``)."""
    th, tw = POS_TILES[c]
    need = 2 * pos_smem_bytes(c, (th, tw))
    if need > limit:
        raise ValueError(f"msab_pos: C = {c} needs {need} bytes of shared memory for two blocks of its {th}x{tw} "
                         f"tile; an SM has {limit}")
    return th, tw


def msab_pos(x: torch.Tensor, m: torch.Tensor, blk: MsabWeights) -> torch.Tensor:
    """The first half of MSAB pass B on (N, H, W, C) float32 frames with the
    per-frame (N, C, C) attention matrix ``m`` of ``attn_matrix``:
    res1 = x m + bproj + dw3(gelu(dw3(x Wv, pos0)), pos2) + x; each
    depthwise 3x3 zero-pads its own input. Counted as
    ``LAUNCHES["msab_apply_kernel"]``."""
    if x.device.type == "cpu":
        return msab_pos_plain(x, m, blk)
    from animal_vision_tpu_torch.ops import fused_mst  # it imports this module

    _check_pos(x, m, blk)
    n, h, w, c = x.shape
    # the kernel copies rows of C floats in pieces of 16 bytes at C = 124,
    # 8 at C = 62 and 4 at C = 31, so their starts must be aligned as much
    align = 16 if c % 4 == 0 else 8 if c % 2 == 0 else 4
    if blk.wv.data_ptr() % align:
        raise ValueError(f"msab_pos: wv must start on {align} bytes at C = {c}")
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    th, tw = pos_tile_for(c, fused_mst.smem_limit(index))
    frames, mats = x.contiguous(), m.contiguous()
    if frames.data_ptr() % align:
        frames = frames.clone()
    if mats.data_ptr() % align:  # a frame's slice of a batch's matrices
        mats = mats.clone()
    out = torch.empty_like(frames)
    _build.launch(_lib(), "av_msab_pos", x.device, frames.data_ptr(), out.data_ptr(), mats.data_ptr(), _ptr(blk.wv),
                  _ptr(blk.bproj), _ptr(blk.pos0), _ptr(blk.pos2), n, h, w, c, th, tw)
    LAUNCHES["msab_apply_kernel"] += 1
    return out


def msab_apply(x: torch.Tensor, m: torch.Tensor, blk: MsabWeights) -> torch.Tensor:
    """MSAB pass B on (N, H, W, C) float32 frames with the per-frame
    (N, C, C) attention matrix ``m`` of ``attn_matrix``: res1 = x m + bproj
    + dw3(gelu(dw3(x Wv))) + x, out = W4 gelu(dw3(gelu(W0 LN(res1)))) +
    res1; every depthwise 3x3 zero-pads its own input. On the card:
    ``msab_pos``, then ``fused_mst.ffn``, on the same stream."""
    if x.device.type == "cpu":
        return msab_apply_plain(x, m, blk)
    from animal_vision_tpu_torch.ops import fused_mst  # it imports this module

    _check_apply(x, m, blk)
    return fused_mst.ffn(msab_pos(x, m, blk), blk.ln_w, blk.ln_b, blk.w0, blk.dw, blk.w4)


def _check_up(fea, skip, uw: UpFuseWeights, composed: bool = True) -> None:
    """Shapes and devices of an up-fuse call: the raw weights always, the
    composed ones where ``composed`` (the kernel reads only those)."""
    _frames(fea, "up_fuse", (62, 124))
    n, h, w, c = fea.shape
    half = c // 2
    cf, hp, np_ = _up_dims(c)
    want = ((c, 2, 2, half), (2, 2, half), (c, half), (2, 2, c, half), (2, 2, half), (half, half), (4 * cf + hp, np_))
    used = len(uw) if composed else 3
    shapes = tuple(None if t is None else tuple(t.shape) for t in uw[:used])
    if tuple(skip.shape) != (n, 2 * h, 2 * w, half) or shapes != want[:used]:
        raise ValueError(f"up_fuse: fea {tuple(fea.shape)}, skip {tuple(skip.shape)}, weights {shapes}")
    _same_device(fea, "up_fuse", skip, *uw[:used])


def up_smem_bytes(c: int, tile: tuple[int, int]) -> int:
    """Shared memory of one block of the up-fuse kernel: fea over the tile,
    the skip rows of the output tile (each 2 tw pixels plus a pad of 4
    floats), and a ring of three weight slabs (the larger of four parities'
    fea slices and a 32-row skip slice), at the kernel's padded pitches.
    Must equal ``Up::SMEM_FLOATS`` in ``csrc/fused_msab.cu``."""
    th, tw = tile
    half = c // 2
    cf, _, np_ = _up_dims(c)
    slab = max(4 * UP_FEA_SLICE[c], 32) * (np_ + 8)
    return 4 * (th * tw * (cf + 4) + 2 * th * (2 * tw * half + 4) + 3 * slab)


def up_tile_for(c: int, limit: int) -> tuple[int, int]:
    """The up-fuse kernel's input tile at C = ``c``; raises when two blocks
    of it do not fit in ``limit`` bytes of one SM's shared memory
    (``fused_mst.smem_limit``)."""
    th, tw = UP_TILES[c]
    need = 2 * up_smem_bytes(c, (th, tw))
    if need > limit:
        raise ValueError(f"up_fuse: C = {c} needs {need} bytes of shared memory for two blocks of its {th}x{tw} "
                         f"tile; an SM has {limit}")
    return th, tw


def up_fuse(fea: torch.Tensor, skip: torch.Tensor, uw: UpFuseWeights) -> torch.Tensor:
    """Decoder level of (N, H, W, C) ``fea`` and its (N, 2H, 2W, C/2)
    ``skip``: the 2x2 stride-2 transposed convolution with ``uw.wup``
    (C, 2, 2, C/2) and one bias per (dy, dx, out) ``uw.bup`` (2, 2, C/2),
    depth-to-space, then the 1x1 ``uw.fuse`` (C, C/2) over [up | skip]. The
    kernel computes [fea | skip] [wc[dy, dx] ; wskip] + bc[dy, dx] for each
    output parity (dy, dx) in 3xTF32."""
    if fea.device.type == "cpu":
        return up_fuse_plain(fea, skip, uw)
    from animal_vision_tpu_torch.ops import fused_mst  # it imports this module

    _check_up(fea, skip, uw)
    n, h, w, c = fea.shape
    # the kernel copies fea in 8- or 16-byte pieces and skip in 4- or 8-byte
    # pieces (C = 62, 124), so their starts must be aligned as much
    align_f, align_s = (8, 4) if c == 62 else (16, 8)
    if uw.packed.data_ptr() % 16:
        raise ValueError("up_fuse: the packed weights must start on 16 bytes")
    index = fea.device.index if fea.device.index is not None else torch.cuda.current_device()
    th, tw = up_tile_for(c, fused_mst.smem_limit(index))
    f, s = fea.contiguous(), skip.contiguous()
    if f.data_ptr() % align_f:
        f = f.clone()
    if s.data_ptr() % align_s:
        s = s.clone()
    out = torch.empty((n, 2 * h, 2 * w, c // 2), dtype=torch.float32, device=fea.device)
    _build.launch(_lib(), "av_msab_up_fuse", fea.device, f.data_ptr(), s.data_ptr(), out.data_ptr(),
                  _ptr(uw.packed), _ptr(uw.bc), n, h, w, c, th, tw)
    LAUNCHES["up_fuse_kernel"] += 1
    return out
