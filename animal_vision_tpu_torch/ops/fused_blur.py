"""The UV blur kernel: wrapper, plain version.

Counterpart of ``animal_vision_tpu/ops/fused_blur.py``. ``blur_uv`` is a
float32 separable Gaussian over (N, H, W, C) frames (C <= 8) with a given
odd tap table and reflect-101 borders on both axes, W pass first: what
``core/blur.py:gaussian_blur_uv`` runs for every UV blur. On a CUDA tensor
it launches the CUDA C++ kernel ``blur_kernel`` in ``csrc/fused_blur.cu``,
which replaces the Pallas ``_blur_kernel``, or raises; on a CPU tensor it
takes its plain version, ``blur_uv_plain``. Nothing falls back.

The kernel streams rows: one block per strip of 64 output columns and run
of ``run_rows`` output rows walks down its run ``GROUP`` rows at a time,
through a ring of staged input rows and a ring of the last k + ``GROUP``
W-pass rows in shared memory. ``block_smem`` gives a block's shared memory and raises,
naming the kernel size, when the card cannot hold it.
"""

from __future__ import annotations

import ctypes

import torch

from animal_vision_tpu_torch.core import blur as _blur
from animal_vision_tpu_torch.ops import _build

TILE_W = 64
GROUP = 8  # rows per step of a block
STAGES = 3  # staged input groups in flight
RUN_ROWS = (128, 64, 32, 16)  # output rows per block, longest first
MAX_CHANNELS = 8

_P = ctypes.c_void_p
_I = ctypes.c_int
LIB = _build.Library("fused_blur", {
    "av_blur_uv": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "av_blur_uv_smem": [_I, _I],
    "av_blur_uv_smem_limit": [_build.INT_OUT],
})


def smem_bytes(ksize: int, channels: int) -> int:
    """Shared memory of one block: the taps rounded up to 4 floats (kp),
    the ring of kp + GROUP W-pass rows (rounded up to whole groups) of 64
    pixels, 3 staged groups of GROUP input spans of 64 + kp pixels, and one
    int per element of a span (its source offset). Must equal
    ``blur_smem_bytes`` in ``csrc/fused_blur.cu``."""
    kp = (ksize + 3) & ~3
    ring = GROUP * (-(-kp // GROUP) + 1)
    span = (TILE_W + kp) * channels
    return 4 * (kp + ring * TILE_W * channels + STAGES * GROUP * span + span)


def library_smem_bytes(ksize: int, channels: int) -> int:
    """A block's shared memory as the library counts it (builds the library)."""
    return LIB.load().av_blur_uv_smem(ksize, channels)


def block_smem(ksize: int, channels: int, limit: int) -> int:
    """A block's shared memory in bytes; raises when it is above ``limit``."""
    need = smem_bytes(ksize, channels)
    if need > limit:
        raise ValueError(f"blur_uv: ksize {ksize} with {channels} channels needs {need} bytes of shared memory "
                         f"per block; the card allows {limit}")
    return need


def run_rows(n: int, h: int, w: int, channels: int) -> int:
    """Output rows per block: the longest run whose grid still gives every
    SM ``_build.WARPS_PER_SM`` warps (blocks of 2 min(C, 4) warps; the
    shortest run for small frames)."""
    warps = n * -(-w // TILE_W) * 2 * min(channels, 4)
    for rows in RUN_ROWS:
        if warps * -(-h // rows) >= _build.WARPS_PER_SM * _build.SMS:
            return rows
    return RUN_ROWS[-1]


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
    block_smem(ksize, c, _build.block_smem_limit(_build.device_index(img.device)))
    rows = run_rows(n, h, w, c)
    frames = img.contiguous()
    taps = taps.contiguous()
    out = torch.empty_like(frames)
    LIB.launch("av_blur_uv", "blur_uv", frames.device, frames.data_ptr(), out.data_ptr(), taps.data_ptr(),
               ksize, rows, n, h, w, c)
    return out
