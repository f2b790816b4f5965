"""The three fused non-UV species kernels: wrappers, plain versions, host tables.

Counterpart of ``animal_vision_tpu/ops/fused_nonuv.py``. Each kernel runs a
whole species chain in one pass: uint8 (N, H, W, 3) frames -> per-frame
1/255 scale -> sRGB->linear -> colour matrix and blur -> linear->sRGB ->
uint8 frames. The kernels are CUDA C++ for sm_90a in ``csrc/fused_nonuv.cu``:

- ``iso_u8``: 3x3 matrix then separable Gaussian (the blur species and
  the cat), replacing ``_iso_kernel``;
- ``streak_u8``: per-row combined horizontal kernel, per-row 3x3 mix,
  optional chroma (the streak species), replacing ``_streak_kernel``;
- ``pointwise_u8``: 3x3 matrix and an optional per-row blue gain (pig and
  rat), replacing ``_pointwise_kernel``.

Each wrapper takes its plain PyTorch version (``*_plain``, built from
``core.color`` and ``core.blur``) for a tensor on the CPU, and for a CUDA
tensor launches its kernel or raises: nothing falls back. Each launch is
booked under its wrapper's name. Tables are device tensors built once by
the caller (``iso_params``, ``streak_tables``, ``scone_gain``) and shared by
every frame of a batch; frame sizes are run-time arguments of the kernels,
so no table depends on anything but H.

All three kernels encode by exact thresholds: ``encode_table`` makes,
once per device, the table of the least float at which the card's own
powf encode reaches each code (and the floats where it is not monotone),
and each kernel takes it. ``iso_u8`` runs row-streaming strips (one block
per 64-column strip and run of ``iso_run_rows`` rows), ``streak_u8`` one
block per resident slot (``streak_blocks``), each taking an equal share of
the batch's rows, and ``pointwise_u8`` ``pointwise_blocks`` blocks per
frame, each striding over its frame's 16-pixel units.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from animal_vision_tpu_torch.core import blur as _blur
from animal_vision_tpu_torch.core import color as _color
from animal_vision_tpu_torch.core import effects as _effects
from animal_vision_tpu_torch.ops import _build
from animal_vision_tpu_torch.utils.profiling import SETUP, span

#: The iso kernel's strips, rows per step and largest kernel size; runs of
#: output rows per block, longest first (csrc/fused_nonuv.cu)
ISO_TILE_W = 64
ISO_GROUP = 8
ISO_STAGES = 4
ISO_MAX_TAPS = 55
ISO_RUN_ROWS = (128, 64, 32, 16, 8)
ISO_BLOCK_WARPS = 6
#: pointwise_kernel's threads per block and pixels per thread and unit (48
#: bytes: three 16-byte vectors)
POINTWISE_THREADS = 256
POINTWISE_PIX = 16
#: Floats of the device encode table: 255 thresholds, 256 exception floats
#: and 256 exception codes
ENCODE_TABLE = 255 + 2 * 256

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_ulonglong
LIB = _build.Library("fused_nonuv", {
    "av_iso_u8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "av_iso_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "av_streak_u8": [_P, _P, _P, _P, _P, _P, _I, ctypes.c_float, _I, _I, _I, _I, _I, _P],
    "av_pointwise_u8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "av_encode_table": [_P, _P, _P],
    "av_encode_check": [_P, _U64, _U64, _P, _P],
    "av_iso_smem": [_I, _I],
    "av_streak_slots": [_I, _I, _build.INT_OUT],
    "av_pointwise_slots": [_I, _build.INT_OUT],
})


def _frames(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) or (N, H, W, 3) -> contiguous (N, H, W, 3)."""
    if img.dim() not in (3, 4) or img.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) or (N, H, W, 3) frames, got {tuple(img.shape)}")
    return img.reshape(-1, *img.shape[-3:]).contiguous()


def _check_operands(img: torch.Tensor, scale: torch.Tensor, *tables: torch.Tensor | None) -> torch.Tensor:
    """Validate frames, the (N,) scale and the tables; return the frames as
    contiguous (N, H, W, 3)."""
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError(f"frames on unsupported device {img.device}")
    frames = _frames(img)
    if scale.shape != (frames.shape[0],):
        raise ValueError(f"scale must have shape ({frames.shape[0]},), got {tuple(scale.shape)}")
    for t in (scale, *tables):
        if t is None:
            continue
        if t.device != img.device or t.dtype != torch.float32:
            raise ValueError(
                f"tables must be float32 on {img.device}, got {t.dtype} on {t.device}"
            )
    return frames


@functools.lru_cache(maxsize=None)
def _encode_table(device_index: int) -> torch.Tensor:
    device = torch.device("cuda", device_index)
    with span("ops.build", into=SETUP, library="encode_table"):
        table = torch.empty(ENCODE_TABLE, dtype=torch.float32, device=device)
        status = torch.zeros(2, dtype=torch.int32, device=device)
        LIB.launch("av_encode_table", None, device, table.data_ptr(), status.data_ptr())
        exceptions, collisions = status.tolist()  # synchronizes, once per device
    if collisions:
        raise RuntimeError(f"encode_table: {exceptions} floats where the card's encode is not monotone, "
                           f"{collisions} of them at a step that already has one")
    return table


def encode_table(device: torch.device) -> torch.Tensor:
    """The device encode table of the CUDA ``device``, made once: T[1..255]
    (the least float32 at which the card's powf encode reaches each code),
    then per threshold count k the float where the encode is not monotone
    (NaN where none) and its code. Each non-UV kernel takes it."""
    return _encode_table(_build.device_index(torch.device(device)))


def encode_check(device: torch.device, start: int = 0, count: int = 1 << 32) -> tuple[int, int]:
    """(mismatches, first mismatching bit pattern) of the kernels' threshold
    encode against the powf encode at the float32 bit patterns ``start`` ..
    ``start + count - 1``, on the card."""
    table = encode_table(device)
    result = torch.tensor([0, -1], dtype=torch.int64, device=table.device)
    LIB.launch("av_encode_check", None, table.device, table.data_ptr(), start, count, result.data_ptr())
    bad, first = (int(v) & (2**64 - 1) for v in result.tolist())
    return bad, first


def scale_of(img: torch.Tensor) -> torch.Tensor:
    """Per-frame ``normalize_image`` scale of (H, W, 3) or (N, H, W, 3):
    an (N,) float32 tensor, 1/255 where the frame's max exceeds 1, else 1.
    Computed on the frames' device; never read back to the host."""
    mx = torch.amax(img.reshape(-1, img.shape[-3] * img.shape[-2] * img.shape[-1]), dim=1)
    return torch.where(mx > 1, 1.0 / 255.0, 1.0).to(torch.float32)


def _scaled_linear(frames: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    f = frames.to(torch.float32) * scale.view(-1, 1, 1, 1)
    return _color.srgb_to_linear(torch.clamp(f, 0.0, 1.0))


# ---------------------------------------------------------------------------
# Kernel 1: matrix + isotropic Gaussian
# ---------------------------------------------------------------------------


def iso_params(mat: np.ndarray, sigma: float) -> np.ndarray:
    """Host table of the iso kernel: the 3x3 matrix (row-major, applied as
    ``pixels @ mat.T``) then the cv2 auto-ksize Gaussian taps, float32."""
    ksize = _blur.cv2_auto_ksize(float(sigma))
    kern = _blur.gaussian_kernel_1d(ksize, float(sigma))
    return np.concatenate([np.asarray(mat, np.float32).reshape(9), kern]).astype(np.float32)


def iso_smem_bytes(ksize: int, elem: int) -> int:
    """Shared memory of one iso block, for ``elem``-byte frames (1: uint8,
    4: float32): the taps rounded up to 4 (kp), the decode and encode
    tables, two decoded spans of 8 rows of 64 + kp pixels, the ring of
    8 (lag + 2) W-pass rows (lag = (kp + 6) // 8), the column table, the
    staged rows' offsets, ISO_STAGES groups of 8 staged input rows (16-byte
    chunks) and two groups of 8 encoded rows. Must equal ``iso_layout`` in
    ``csrc/fused_nonuv.cu``."""
    def a16(b):
        return (b + 15) // 16 * 16

    kp = (ksize + 3) & ~3
    span = ISO_TILE_W + kp
    ring = ISO_GROUP * ((kp + 6) // ISO_GROUP + 2)
    pitch = 16 * ((span * 3 * elem + 15) // 16 + 1)
    enc = 4 * (257 + 256) + 256
    return (a16(4 * kp) + a16(4 * 256) + a16(enc) + a16(4 * 2 * ISO_GROUP * span * 3)
            + a16(4 * ring * ISO_TILE_W * 3) + a16(4 * span) + a16(4 * ISO_STAGES * ISO_GROUP)
            + a16(ISO_STAGES * ISO_GROUP * pitch) + a16(2 * ISO_GROUP * (ISO_TILE_W * 3 + 16)))


def library_iso_smem_bytes(ksize: int, elem: int) -> int:
    """An iso block's shared memory as the library counts it (builds the library)."""
    return LIB.load().av_iso_smem(ksize, elem)


def iso_check_ksize(ksize: int, elem: int, limit: int) -> int:
    """A block's shared memory in bytes; raises, naming ``ksize``, for an
    even ksize, one above ISO_MAX_TAPS or one whose block is above ``limit``."""
    if ksize < 1 or ksize % 2 == 0 or ksize > ISO_MAX_TAPS:
        raise ValueError(f"iso_u8: ksize {ksize} must be odd and at most {ISO_MAX_TAPS}")
    need = iso_smem_bytes(ksize, elem)
    if need > limit:
        raise ValueError(f"iso_u8: ksize {ksize} needs {need} bytes of shared memory per block; the card allows {limit}")
    return need


def iso_run_rows(n: int, h: int, w: int) -> int:
    """Output rows per iso block: the longest run whose grid still gives
    every SM ``_build.WARPS_PER_SM`` warps (the shortest run for small
    frames)."""
    warps = n * -(-w // ISO_TILE_W) * ISO_BLOCK_WARPS
    for rows in ISO_RUN_ROWS:
        if warps * -(-h // rows) >= _build.WARPS_PER_SM * _build.SMS:
            return rows
    return ISO_RUN_ROWS[-1]


def iso_u8_plain(img: torch.Tensor, scale: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Plain version of ``iso_u8``."""
    frames = _frames(img)
    lin = _scaled_linear(frames, scale)
    out = _color.apply_color_matrix(lin, params[:9].view(3, 3))
    kern = params[9:]
    out = _blur.conv1d_axis(_blur.conv1d_axis(out, kern, -2), kern, -3)
    return _color.encode_output(out, torch.uint8).reshape(img.shape)


def iso_u8(img: torch.Tensor, scale: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """scale -> linearize -> 3x3 matrix -> separable Gaussian (reflect-101)
    -> encode, for uint8 frames or float32 sRGB frames; uint8 out.

    ``scale`` is (N,) float32, ``params`` is ``iso_params`` on the frames'
    device."""
    frames = _check_operands(img, scale, params)
    if img.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"iso_u8 takes uint8 or float32 frames, got {img.dtype}")
    if img.device.type == "cpu":
        return iso_u8_plain(img, scale, params)
    n, h, w, _ = frames.shape
    ksize = int(params.numel()) - 9
    iso_check_ksize(ksize, frames.element_size(), _build.block_smem_limit(_build.device_index(frames.device)))
    out = torch.empty(frames.shape, dtype=torch.uint8, device=frames.device)
    params = params.contiguous()
    fn = "av_iso_u8" if frames.dtype == torch.uint8 else "av_iso_f32"
    LIB.launch(fn, "iso_u8", frames.device, frames.data_ptr(), out.data_ptr(), scale.data_ptr(), params.data_ptr(),
               encode_table(frames.device).data_ptr(), ksize, iso_run_rows(n, h, w), n, h, w)
    return out.reshape(img.shape)


# ---------------------------------------------------------------------------
# Kernel 2: streak (per-row horizontal kernel + per-row mix + chroma)
# ---------------------------------------------------------------------------


def streak_fixed_radius(params: tuple) -> int:
    """Upper bound on the combined-kernel half width over every row: the
    per-row sigma approaches, and never exceeds, ``sigma_far``."""
    _, _, s_f, _ = params
    k1 = _blur.cv2_auto_ksize(float(s_f))
    k2 = _blur.cv2_auto_ksize(max(0.4, 0.5 * float(s_f)))
    return (k1 + k2 - 2) // 2


def streak_tables(
    h: int, params: tuple, alpha: float, s_scale: float, r_fixed: int | None = None
) -> tuple[np.ndarray, np.ndarray, int]:
    """Per-row tables of the streak kernel: (tab (h, r+1), mix (h, 9), r).

    The reference's two per-row horizontal blurs with a channel mix between
    them collapse into one per-row convolution with k12 = k1 (*) k2 followed
    by one mix: the mix acts on channels and the second blur on pixels, so
    they commute. ``tab`` is the symmetric half-table of k12 (column d =
    weight at distance d, symmetry enforced to the ulp); ``mix`` is the
    per-row channel-mix matrix with the dichromat matrix folded in.
    ``r_fixed`` widens the table to a fixed radius with zeros."""
    y_c, s_s, s_f, fo = params
    sx, sy = _blur.streak_sigma_map(h, y_c, s_s, s_f, fo)

    rows = []
    for s1, s2 in zip(sx, sy):
        k1v = _blur.gaussian_kernel_1d(_blur.cv2_auto_ksize(float(s1)), float(s1))
        k2v = _blur.gaussian_kernel_1d(_blur.cv2_auto_ksize(float(s2)), float(s2))
        v = np.convolve(k1v.astype(np.float64), k2v.astype(np.float64))
        rows.append(0.5 * (v + v[::-1]))
    r = max(len(v) for v in rows) // 2 if r_fixed is None else r_fixed
    tab = np.zeros((h, r + 1), dtype=np.float32)
    for y, v in enumerate(rows):
        rv = len(v) // 2
        tab[y, : rv + 1] = v[rv:]

    mat = _color.collapse_lms_matrix(alpha, s_scale).astype(np.float64)
    mix = np.stack(
        [
            (
                _blur._channel_mix_matrix(_blur.cv2_auto_ksize(float(s)), float(s)).astype(np.float64)
                @ mat
            ).reshape(9)
            for s in sx
        ],
        axis=0,
    ).astype(np.float32)
    return tab, mix, r


@functools.lru_cache(maxsize=None)
def streak_slots(device_index: int, r: int, w: int) -> int:
    """Streak blocks the card holds at once for radius ``r`` and width ``w``
    (SMs x resident blocks per SM); raises when one block does not fit."""
    slots = LIB.query("av_streak_slots", device_index, r, w)[0]
    if slots < 1:
        raise ValueError(f"streak_u8: a row of width {w} with radius {r} does not fit one block's shared memory")
    return slots


def streak_blocks(n: int, h: int, slots: int) -> int:
    """Streak blocks for a batch: one per resident slot, at most one per
    row. Block b of B takes rows n h b // B .. n h (b + 1) // B - 1 of the
    batch's n h rows (frames one after another)."""
    return min(slots, n * h)


def streak_u8_plain(
    img: torch.Tensor, scale: torch.Tensor, tab: torch.Tensor, mix: torch.Tensor,
    chroma: float | None = None,
) -> torch.Tensor:
    """Plain version of ``streak_u8``."""
    frames = _frames(img)
    h, w = frames.shape[1], frames.shape[2]
    r = int(tab.shape[1]) - 1
    lin = _scaled_linear(frames, scale)
    padded = _blur._pad_reflect101(lin, r, axis=-2)
    acc = padded.narrow(-2, r, w) * tab[:, 0, None, None]
    for d in range(1, r + 1):
        pair = padded.narrow(-2, r - d, w) + padded.narrow(-2, r + d, w)
        acc = acc + pair * tab[:, d, None, None]
    out = torch.einsum("hij,nhwj->nhwi", mix.view(h, 3, 3), acc)
    if chroma is not None:
        out = _effects.chroma_compression(out, chroma)
    return _color.encode_output(out, torch.uint8).reshape(img.shape)


def streak_u8(
    img: torch.Tensor, scale: torch.Tensor, tab: torch.Tensor, mix: torch.Tensor,
    chroma: float | None = None,
) -> torch.Tensor:
    """scale -> linearize -> per-row symmetric horizontal convolution with
    ``tab`` (reflect-101 on W) -> per-row 3x3 ``mix`` -> optional chroma
    compression toward the pixel mean -> encode; uint8 in and out.

    ``tab`` is (H, r+1) and ``mix`` (H, 9), float32 on the frames' device."""
    frames = _check_operands(img, scale, tab, mix)
    if img.dtype != torch.uint8:
        raise TypeError(f"streak_u8 takes uint8 frames, got {img.dtype}")
    n, h, w, _ = frames.shape
    if tab.dim() != 2 or tab.shape[0] != h or mix.shape != (h, 9):
        raise ValueError(f"tables {tuple(tab.shape)}, {tuple(mix.shape)} do not fit H={h}")
    if img.device.type == "cpu":
        return streak_u8_plain(img, scale, tab, mix, chroma)
    r = int(tab.shape[1]) - 1
    blocks = streak_blocks(n, h, streak_slots(_build.device_index(frames.device), r, w))
    out = torch.empty_like(frames)
    tab = tab.contiguous()
    mix = mix.contiguous()
    keep = 1.0 - chroma if chroma is not None else 1.0
    LIB.launch("av_streak_u8", "streak_u8", frames.device, frames.data_ptr(), out.data_ptr(), scale.data_ptr(),
               tab.data_ptr(), mix.data_ptr(), encode_table(frames.device).data_ptr(), r, keep,
               int(chroma is not None), blocks, n, h, w)
    return out.reshape(img.shape)


# ---------------------------------------------------------------------------
# Kernel 3: pointwise (matrix + optional per-row blue gain)
# ---------------------------------------------------------------------------


def scone_gain(h: int, scone: tuple) -> np.ndarray:
    """The (h, 1) float32 blue-channel row gain of the rat's S-cone ramp,
    ``scone = (s_top, s_bottom, power, extra_boost)``."""
    return _effects.s_cone_gain_ramp(h, *scone).reshape(-1, 1)


@functools.lru_cache(maxsize=None)
def pointwise_slots(device_index: int, use_gain: bool) -> int:
    """Pointwise blocks (the instance with the gain or without) the card
    holds at once: SMs x resident blocks per SM."""
    return LIB.query("av_pointwise_slots", device_index, int(use_gain))[0]


def pointwise_blocks(n: int, npx: int, slots: int) -> int:
    """Pointwise blocks per frame for ``n`` frames of ``npx`` pixels: the
    frames share the resident slots, at least one block per frame and no
    more than a frame's 16-pixel units fill at POINTWISE_THREADS per
    block. Block b of B strides over units b T + t, b T + t + B T, ... (T
    threads); the frame's block 0 also takes its head and tail pixels."""
    units = -(-npx // POINTWISE_PIX)
    return max(1, min(slots // n, -(-units // POINTWISE_THREADS)))


def pointwise_u8_plain(
    img: torch.Tensor, scale: torch.Tensor, mat9: torch.Tensor, gain: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain version of ``pointwise_u8``."""
    frames = _frames(img)
    out = _color.apply_color_matrix(_scaled_linear(frames, scale), mat9.view(3, 3))
    if gain is not None:
        blue = torch.clamp(out[..., 2] * gain.reshape(-1, 1), 0.0, 1.0)
        out = torch.cat([out[..., :2], blue[..., None]], dim=-1)
    return _color.encode_output(out, torch.uint8).reshape(img.shape)


def pointwise_u8(
    img: torch.Tensor, scale: torch.Tensor, mat9: torch.Tensor, gain: torch.Tensor | None = None
) -> torch.Tensor:
    """scale -> linearize -> 3x3 matrix -> optional per-row gain on blue,
    clipped to [0,1] -> encode; uint8 in and out.

    ``mat9`` is the row-major (9,) matrix and ``gain`` an (H,) or (H, 1)
    row gain, float32 on the frames' device."""
    frames = _check_operands(img, scale, mat9, gain)
    if img.dtype != torch.uint8:
        raise TypeError(f"pointwise_u8 takes uint8 frames, got {img.dtype}")
    n, h, w, _ = frames.shape
    if mat9.numel() != 9 or (gain is not None and gain.numel() != h):
        raise ValueError("pointwise_u8 takes a 9-element matrix and an H-element gain")
    if img.device.type == "cpu":
        return pointwise_u8_plain(img, scale, mat9, gain)
    if n > 65535:
        raise ValueError(f"pointwise_u8 takes at most 65535 frames per call, got {n}")
    blocks = pointwise_blocks(n, h * w, pointwise_slots(_build.device_index(frames.device), gain is not None))
    out = torch.empty_like(frames)
    mat9 = mat9.contiguous()
    gain = None if gain is None else gain.contiguous()
    LIB.launch("av_pointwise_u8", "pointwise_u8", frames.device, frames.data_ptr(), out.data_ptr(), scale.data_ptr(),
               mat9.data_ptr(), None if gain is None else gain.data_ptr(),
               encode_table(frames.device).data_ptr(), blocks, n, h, w)
    return out.reshape(img.shape)


# ---------------------------------------------------------------------------
# Whole-species functions with the JAX package's signatures
# ---------------------------------------------------------------------------


def _device_table(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(like.device)


def fused_matrix_blur(img: torch.Tensor, mat, sigma: float, assume01: bool = False) -> torch.Tensor:
    """linearize -> 3x3 ``mat`` -> Gaussian(sigma) -> encode, for uint8
    frames or (``assume01``) float32 sRGB frames in [0,1] taken as they are."""
    if assume01:
        scale = torch.ones(_frames(img).shape[0], dtype=torch.float32, device=img.device)
    else:
        scale = scale_of(img)
    return iso_u8(img, scale, _device_table(iso_params(np.asarray(mat, np.float64), sigma), img))


def fused_iso_u8(img: torch.Tensor, alpha: float, s_scale: float, sigma: float) -> torch.Tensor:
    """The blur species' chain: normalize -> linear -> dichromat matrix ->
    cv2 auto-ksize Gaussian -> encode."""
    return fused_matrix_blur(img, _color.collapse_lms_matrix(alpha, s_scale), sigma)


def fused_streak_u8(
    img: torch.Tensor, alpha: float, s_scale: float, params: tuple, chroma: float | None = None
) -> torch.Tensor:
    """The streak species' chain: normalize -> linear -> dichromat matrix ->
    streak blur -> optional chroma compression -> encode."""
    tab, mix, _ = streak_tables(int(img.shape[-3]), params, alpha, s_scale)
    return streak_u8(img, scale_of(img), _device_table(tab, img), _device_table(mix, img), chroma)


def fused_pointwise_u8(
    img: torch.Tensor, alpha: float, s_scale: float, scone: tuple | None = None
) -> torch.Tensor:
    """The pig's (matrix only) or the rat's (matrix + S-cone row gain) chain."""
    mat9 = _device_table(_color.collapse_lms_matrix(alpha, s_scale).reshape(9), img)
    gain = None if scone is None else _device_table(scone_gain(int(img.shape[-3]), scone), img)
    return pointwise_u8(img, scale_of(img), mat9, gain)
