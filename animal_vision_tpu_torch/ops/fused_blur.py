"""The UV blur kernel: wrapper, plain version, launch counter.

Counterpart of ``animal_vision_tpu/ops/fused_blur.py``. ``blur_uv`` is a
float32 separable Gaussian over (N, H, W, C) frames (C <= 8) with a given
odd tap table and reflect-101 borders on both axes, W pass first: what
``core/blur.py:gaussian_blur_uv`` runs for every UV blur. On a CUDA tensor
it launches the CUDA C++ kernel ``blur_kernel`` in ``csrc/fused_blur.cu``,
which replaces the Pallas ``_blur_kernel``, or raises; on a CPU tensor it
takes its plain version, ``blur_uv_plain``. Nothing falls back.

The kernel stages an output tile of 64 pixels by 32, 16 or 8 rows with its
halo in shared memory; ``tile_rows`` picks the tallest that fits the card
and raises, naming the kernel size, when not even 8 rows fit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from animal_vision_tpu_torch.core import blur as _blur
from animal_vision_tpu_torch.ops import _build

#: Kernel launches (plain-version calls are not counted).
LAUNCHES = {"blur_uv": 0}

TILE_W = 64
TILE_ROWS = (32, 16, 8)
MAX_CHANNELS = 8

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    LAUNCHES["blur_uv"] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_blur")
    if lib.av_blur_uv.argtypes is None:
        lib.av_blur_uv.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        lib.av_blur_uv.restype = ctypes.c_int
        lib.av_blur_uv_smem_limit.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.av_blur_uv_smem_limit.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def smem_limit(device_index: int) -> int:
    """The most dynamic shared memory, in bytes, one block may use on the
    CUDA device ``device_index``."""
    lib = _lib()
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _build.check(lib, lib.av_blur_uv_smem_limit(ctypes.byref(out)), "av_blur_uv_smem_limit")
    return out.value


def smem_bytes(ksize: int, channels: int, rows: int) -> int:
    """Shared memory of one block: the taps (rounded up to 4 floats), the
    staged (rows + 2R, 64 + 2R, C) tile and its (rows + 2R, 64, C) W pass.
    Must equal ``blur_smem_bytes`` in ``csrc/fused_blur.cu``."""
    r = ksize // 2
    taps = (ksize + 3) & ~3
    return 4 * (taps + (rows + 2 * r) * (TILE_W + 2 * r) * channels + (rows + 2 * r) * TILE_W * channels)


def tile_rows(ksize: int, channels: int, limit: int) -> int:
    """The tallest output tile whose block fits in ``limit`` bytes of shared
    memory; raises when not even the shortest does."""
    for rows in TILE_ROWS:
        if smem_bytes(ksize, channels, rows) <= limit:
            return rows
    raise ValueError(
        f"blur_uv: ksize {ksize} with {channels} channels needs "
        f"{smem_bytes(ksize, channels, TILE_ROWS[-1])} bytes of shared memory even with "
        f"{TILE_ROWS[-1]}-row tiles; the card allows {limit}"
    )


def _check(img: torch.Tensor, taps: torch.Tensor) -> None:
    if img.dim() != 4 or not 1 <= img.shape[-1] <= MAX_CHANNELS:
        raise ValueError(f"blur_uv takes (N, H, W, C) frames with C <= {MAX_CHANNELS}, got {tuple(img.shape)}")
    if img.dtype != torch.float32:
        raise TypeError(f"blur_uv takes float32 frames, got {img.dtype}")
    if taps.dim() != 1 or taps.shape[0] % 2 != 1 or taps.dtype != torch.float32 or taps.device != img.device:
        raise ValueError(
            f"taps must be an odd-length float32 vector on {img.device}, "
            f"got {tuple(taps.shape)} {taps.dtype} on {taps.device}"
        )


def blur_uv_plain(img: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Plain version of ``blur_uv``: reflect-101 shifted-slice sums, W then H."""
    _check(img, taps)
    return _blur.conv1d_axis(_blur.conv1d_axis(img, taps, -2), taps, -3)


def blur_uv(img: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian of (N, H, W, C) float32 frames with the odd tap
    vector ``taps`` (on the frames' device), reflect-101 on H and W."""
    _check(img, taps)
    if img.device.type == "cpu":
        return blur_uv_plain(img, taps)
    if img.device.type != "cuda":
        raise ValueError(f"frames on unsupported device {img.device}")
    n, h, w, c = img.shape
    ksize = int(taps.shape[0])
    rows = tile_rows(ksize, c, smem_limit(img.device.index if img.device.index is not None
                                          else torch.cuda.current_device()))
    frames = img.contiguous()
    taps = taps.contiguous()
    out = torch.empty_like(frames)
    _build.launch(_lib(), "av_blur_uv", frames.device, frames.data_ptr(), out.data_ptr(), taps.data_ptr(),
                  ksize, rows, n, h, w, c)
    LAUNCHES["blur_uv"] += 1
    return out
