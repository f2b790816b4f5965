"""The MST-L FFN kernel: wrapper, plain version.

Counterpart of ``animal_vision_tpu/ops/fused_mst.py``. ``ffn`` is the
prenorm feed-forward of every block of the mask-guided MST
(``models/mst.py``): out = x + W4 gelu(dw3(gelu(W0 LN(x)))) on (N, H, W, C)
float32 frames, C in {31, 62, 124}, hidden 4C; LN with the biased variance
and eps 1e-5, GELU in the exact erf form, the depthwise 3x3 zero-padding the
hidden map at every image edge.

On a CUDA tensor ``ffn`` launches the CUDA C++ kernel ``ffn_kernel`` of
``csrc/fused_mst.cu``, which replaces the Pallas ``_ffn_kernel``, or
raises; on a CPU tensor it takes its plain version, ``ffn_plain``. Nothing
falls back. The kernel stages an output tile with a 1-pixel halo in shared
memory and runs both 1x1 products on the tensor cores in 3xTF32, the 4C
hidden in chunks of 32 (C = 31) or 16 (C = 62, 124) channels, one output
tile per C; each weight is split into its TF32 hi and lo parts once per
block, and each activation fragment once for all the products it enters,
not at every fragment load. ``tile_for`` raises, naming C and the tile, where two
blocks of it do not fit one SM's shared memory.

Weights are in the layouts the kernel reads: w0 (C, 4C), dw (3, 3, 4C),
w4 (4C, C), ln_w and ln_b (C,).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from animal_vision_tpu_torch.core import linalg
from animal_vision_tpu_torch.ops import _build
from animal_vision_tpu_torch.ops.fused_msab import _dw3, _frames, _ptr, _same_device

#: Channel counts the kernel is built for (the three MST-L levels).
FFN_CHANNELS = (31, 62, 124)
#: The output tile (rows, columns) the kernel is built for at each C
#: (``FfnTile`` in ``csrc/fused_mst.cu``): the largest of which two blocks
#: fit an H100 SM.
TILES = {31: (8, 16), 62: (8, 16), 124: (8, 8)}

_P = ctypes.c_void_p
_I = ctypes.c_int
LIB = _build.Library("fused_mst", {
    "av_mst_ffn": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "av_mst_ffn_blocks_per_sm": [_I, _build.INT_OUT],
    "av_mst_smem_limit": [_build.INT_OUT, _build.INT_OUT],
})


def blocks_per_sm(c: int, device_index: int) -> int:
    """Blocks of the kernel built for C = ``c`` that one SM of the CUDA
    device ``device_index`` holds at once (the occupancy calculator, with
    the kernel's registers and shared memory)."""
    return LIB.query("av_mst_ffn_blocks_per_sm", device_index, c)[0]


def hidden_chunk(c: int) -> int:
    """Hidden channels per chunk of the kernel at C = ``c``."""
    return 32 if c <= 31 else 16


def smem_bytes(c: int, tile: tuple[int, int]) -> int:
    """Shared memory of one block: LN(x) and a hidden chunk over the tile
    with its 1-pixel halo, the chunk after the depthwise conv over the tile,
    and the chunk's W0 and W4 slabs split into TF32 hi and lo, at the
    kernel's padded pitches. Must equal ``Ffn::SMEM_FLOATS`` in
    ``csrc/fused_mst.cu``."""
    th, tw = tile
    cp, hc = -(-c // 8) * 8, hidden_chunk(c)
    n1, n0 = (th + 2) * (tw + 2), th * tw
    return 4 * (n1 * (cp + 4) + n1 * (hc + 8) + n0 * (hc + 4) + 2 * 2 * cp * hc)


def tile_for(c: int, limit: int) -> tuple[int, int]:
    """The kernel's output tile at C = ``c``; raises when two blocks of it
    do not fit in ``limit`` bytes of one SM's shared memory
    (``_build.two_block_smem_limit``)."""
    th, tw = TILES[c]
    need = 2 * smem_bytes(c, (th, tw))
    if need > limit:
        raise ValueError(f"ffn: C = {c} needs {need} bytes of shared memory for two blocks of its {th}x{tw} tile; "
                         f"an SM has {limit}")
    return th, tw


def _check(x, ln_w, ln_b, w0, dw, w4) -> None:
    _frames(x, "ffn", FFN_CHANNELS)
    c = x.shape[-1]
    shapes = tuple(tuple(t.shape) for t in (ln_w, ln_b, w0, dw, w4))
    if shapes != ((c,), (c,), (c, 4 * c), (3, 3, 4 * c), (4 * c, c)):
        raise ValueError(f"ffn: C {c} takes ln (C,), w0 (C, 4C), dw (3, 3, 4C), w4 (4C, C); got {shapes}")
    _same_device(x, "ffn", ln_w, ln_b, w0, dw, w4)


def ffn_plain(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor, w0: torch.Tensor, dw: torch.Tensor,
              w4: torch.Tensor) -> torch.Tensor:
    """Plain version of ``ffn``."""
    _check(x, ln_w, ln_b, w0, dw, w4)
    y = F.layer_norm(x, (x.shape[-1],), ln_w, ln_b, eps=1e-5)
    hid = F.gelu(_dw3(F.gelu(linalg.frame_matmul(y, w0)), dw))
    return linalg.frame_matmul(hid, w4) + x


def ffn(x: torch.Tensor, ln_w: torch.Tensor, ln_b: torch.Tensor, w0: torch.Tensor, dw: torch.Tensor,
        w4: torch.Tensor) -> torch.Tensor:
    """x + W4 gelu(dw3(gelu(W0 LN(x)))) of (N, H, W, C) float32 frames."""
    if x.device.type == "cpu":
        return ffn_plain(x, ln_w, ln_b, w0, dw, w4)
    _check(x, ln_w, ln_b, w0, dw, w4)
    n, h, w, c = x.shape
    th, tw = tile_for(c, _build.two_block_smem_limit(_build.device_index(x.device)))
    frames = x.contiguous()
    if frames.data_ptr() % 16:  # the kernel copies pixel rows in 8- or 16-byte pieces
        frames = frames.clone()
    out = torch.empty_like(frames)
    LIB.launch("av_mst_ffn", "ffn", x.device, frames.data_ptr(), out.data_ptr(), _ptr(ln_w), _ptr(ln_b),
               _ptr(w0), _ptr(dw), _ptr(w4), n, h, w, c, th, tw)
    return out
