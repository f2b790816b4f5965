"""The MST-L FFN kernel: wrapper, plain version, launch counter.

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
memory; ``tile_for`` picks the largest of 8x16, 8x8 and 4x8 that fits the
card and raises, naming C and the tile, when none does.

Weights are in the layouts the kernel reads: w0 (C, 4C), dw (3, 3, 4C),
w4 (4C, C), ln_w and ln_b (C,).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from animal_vision_tpu_torch.core import linalg
from animal_vision_tpu_torch.ops import _build
from animal_vision_tpu_torch.ops.fused_msab import _dw3, _frames, _ptr, _same_device

#: Kernel launches (plain-version calls are not counted).
LAUNCHES = {"ffn": 0}

#: Channel counts the kernel is built for (the three MST-L levels).
FFN_CHANNELS = (31, 62, 124)
#: Output tiles (rows, columns), largest first.
TILES = ((8, 16), (8, 8), (4, 8))

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    LAUNCHES["ffn"] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_mst")
    if lib.av_mst_ffn.argtypes is None:
        lib.av_mst_ffn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        lib.av_mst_ffn.restype = ctypes.c_int
        lib.av_mst_smem_limit.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.av_mst_smem_limit.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def smem_limit(device_index: int) -> int:
    """The most dynamic shared memory, in bytes, one block may use on the
    CUDA device ``device_index``."""
    lib = _lib()
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _build.check(lib, lib.av_mst_smem_limit(ctypes.byref(out)), "av_mst_smem_limit")
    return out.value


def smem_bytes(c: int, tile: tuple[int, int]) -> int:
    """Shared memory of one block: LN(x) and a C-wide hidden chunk over the
    tile with its 1-pixel halo, and the chunk after the depthwise conv over
    the tile. Must equal ``ffn_smem_floats`` in ``csrc/fused_mst.cu``."""
    th, tw = tile
    return 4 * c * (2 * (th + 2) * (tw + 2) + th * tw)


def tile_for(c: int, limit: int) -> tuple[int, int]:
    """The largest output tile whose block fits in ``limit`` bytes of shared
    memory; raises when not even the smallest does."""
    for tile in TILES:
        if smem_bytes(c, tile) <= limit:
            return tile
    th, tw = TILES[-1]
    raise ValueError(
        f"ffn: C = {c} needs {smem_bytes(c, TILES[-1])} bytes of shared memory even with a {th}x{tw} tile; "
        f"the card allows {limit}"
    )


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
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    th, tw = tile_for(c, smem_limit(index))
    frames = x.contiguous()
    out = torch.empty_like(frames)
    _build.launch(_lib(), "av_mst_ffn", x.device, frames.data_ptr(), out.data_ptr(), _ptr(ln_w), _ptr(ln_b),
                  _ptr(w0), _ptr(dw), _ptr(w4), n, h, w, c, th, tw)
    LAUNCHES["ffn"] += 1
    return out
