"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA card (sm_90a) and nvcc:

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Without a card every test here skips. Each test bars the plain versions
from CUDA tensors, so a pass also shows that the wrappers launch their
kernels and never fall back."""

import hashlib

import numpy as np
import pytest
import torch

from animal_vision_tpu_torch.core import blur, color
from animal_vision_tpu_torch.models import zoo
from animal_vision_tpu_torch.models.mst_plus_plus import load_shipped
from animal_vision_tpu_torch.models.providers import attach_model, attach_mst, make_mst_hsi_provider
from animal_vision_tpu_torch.ops import _build
from animal_vision_tpu_torch.ops import fused_blur as B
from animal_vision_tpu_torch.ops import fused_msab as M
from animal_vision_tpu_torch.ops import fused_mst as T
from animal_vision_tpu_torch.ops import fused_nonuv as F
from animal_vision_tpu_torch.ops import gelu_probe as GP
from animal_vision_tpu_torch.species import NON_UV_NAMES, PORTED_UV_NAMES, get_animal
from animal_vision_tpu_torch.species.nonuv import NONUV_SPECS, Cat, NonUVAnimal
from animal_vision_tpu_torch.species.uv.goldfish import Goldfish
from animal_vision_tpu_torch.species.uv.kestrel import Kestrel
from animal_vision_tpu_torch.species.uv.mantis_shrimp import MantisShrimp

pytestmark = pytest.mark.gpu

SHAPES = [(2, 64, 96), (1, 37, 53), (3, 5, 3), (1, 1, 1)]
#: The launch keys of ``fused_msab``'s MST++ kernels.
MSAB_KEYS = ("conv_kernel", "attn_stats_kernel", "msab_apply_kernel", "up_fuse_kernel", "msab_masked_kernel")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest -m gpu tests/test_torch_kernels_gpu.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def no_plain_on_cuda(monkeypatch):
    """Plain versions that raise on a CUDA tensor; returns the originals."""
    originals = {}
    for mod, name in ((F, "iso_u8_plain"), (F, "streak_u8_plain"), (F, "pointwise_u8_plain"),
                      (B, "blur_uv_plain"), (M, "conv_plain"), (M, "attn_stats_plain"),
                      (M, "msab_pos_plain"), (M, "msab_apply_plain"), (M, "up_fuse_plain"), (T, "ffn_plain")):
        fn = getattr(mod, name)
        originals[name] = fn

        def guarded(img, *args, _fn=fn, _name=name, **kwargs):
            if img.is_cuda:
                raise AssertionError(f"{_name} reached with a CUDA tensor")
            return _fn(img, *args, **kwargs)

        monkeypatch.setattr(mod, name, guarded)
    return originals


def _frames(shape, device, seed=0):
    n, h, w = shape
    x = np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    x[-1] = x[-1] & 1  # a frame of 0/1 values: the scale = 1 branch
    return torch.from_numpy(x).to(device)


def _launches(*keys) -> dict:
    return {k: _build.LAUNCHES[k] for k in keys}


def _table(a, device):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def _lsb(a, b):
    return int((a.to(torch.int16) - b.to(torch.int16)).abs().max().item())


def _kernel_vs_plain(run, plain, x, scale, kernel):
    before = _build.LAUNCHES[kernel]
    got = run(x, scale)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[kernel] == before + 1
    want = plain(x.cpu(), scale.cpu())
    assert got.dtype == torch.uint8 and got.shape == x.shape
    assert _lsb(got.cpu(), want) <= 1


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sigma", [0.7, 3.5])
def test_iso_kernel(cuda, no_plain_on_cuda, shape, sigma):
    params = _table(F.iso_params(color.collapse_lms_matrix(0.58, 0.65), sigma), cuda)
    x = _frames(shape, cuda)
    _kernel_vs_plain(lambda a, s: F.iso_u8(a, s, params),
                     lambda a, s: no_plain_on_cuda["iso_u8_plain"](a, s, params.cpu()),
                     x, F.scale_of(x), "iso_u8")


@pytest.mark.parametrize("shape", SHAPES)
def test_iso_kernel_float_input(cuda, no_plain_on_cuda, shape):
    params = _table(F.iso_params(Cat._merge_matrix(), Cat.BLUR_SIGMA), cuda)
    x = (_frames(shape, cuda).float() / 255.0).contiguous()
    ones = torch.ones(shape[0], device=cuda)
    before = _build.LAUNCHES["iso_u8"]
    got = F.iso_u8(x, ones, params)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["iso_u8"] == before + 1
    want = no_plain_on_cuda["iso_u8_plain"](x.cpu(), ones.cpu(), params.cpu())
    assert _lsb(got.cpu(), want) <= 1


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ["deer", "rabbit"])
def test_streak_kernel(cuda, no_plain_on_cuda, shape, name):
    spec = NONUV_SPECS[name]
    chroma = spec.effects[1].params[0] if len(spec.effects) == 2 else None
    tab, mix, _ = F.streak_tables(shape[1], spec.effects[0].params, spec.alpha, spec.s_scale)
    tab, mix = _table(tab, cuda), _table(mix, cuda)
    x = _frames(shape, cuda)
    _kernel_vs_plain(lambda a, s: F.streak_u8(a, s, tab, mix, chroma),
                     lambda a, s: no_plain_on_cuda["streak_u8_plain"](a, s, tab.cpu(), mix.cpu(), chroma),
                     x, F.scale_of(x), "streak_u8")


def test_encode_table_exhaustive(cuda):
    """The kernels' threshold encode equals the powf encode at every one of
    the 2^32 float32 bit patterns: the 1,065,353,217 floats in [0, 1],
    negatives, values above 1, infinities and NaN."""
    table = F.encode_table(cuda)
    assert table.shape == (F.ENCODE_TABLE,) and table.dtype == torch.float32
    thr = table[:255].cpu().numpy()
    assert thr[0] > 0 and thr[-1] <= 1 and np.all(np.diff(thr) > 0)
    bad, first = F.encode_check(cuda)
    assert bad == 0, f"{bad} mismatches, first at 0x{first:08x}"


def _pinned(monkeypatch, name, value):
    """Pin a wrapper's partition (``iso_run_rows``, ``streak_blocks``) to ``value``."""
    monkeypatch.setattr(F, name, lambda *args, **kwargs: value)


def _iso_vs_plain(no_plain_on_cuda, shape, ksize, as_float=False, seed=0):
    sigma = (ksize - 1) / 8  # cv2_auto_ksize(sigma) == ksize
    params = F.iso_params(color.collapse_lms_matrix(0.58, 0.65), sigma)
    assert params.size - 9 == ksize
    x = _frames(shape, "cpu", seed=seed)
    scale = F.scale_of(x)
    if as_float:
        x = (x.float() / 255.0).contiguous()
        scale = torch.ones(shape[0])
    got = F.iso_u8(x.to("cuda"), scale.to("cuda"), _table(params, "cuda"))
    want = no_plain_on_cuda["iso_u8_plain"](x, scale, torch.from_numpy(params))
    assert got.shape == x.shape and got.dtype == torch.uint8
    assert _lsb(got.cpu(), want) <= 1


@pytest.mark.parametrize("ksize", [3, 29, 55])
@pytest.mark.parametrize("width", [63, 64, 65, 129, 1283])
@pytest.mark.parametrize("height", [(16, -1), (16, 1), (128, -1), (128, 1)])
def test_iso_kernel_strips_and_runs(cuda, no_plain_on_cuda, monkeypatch, height, width, ksize):
    """Strip edges (widths 63, 64, 65, 129 and 1283, whose rows start off 16
    bytes) and run edges (heights one row either side of a run of 16 or
    128 rows, the run length pinned), at ksize 3, 29 and 55."""
    rows, delta = height
    _pinned(monkeypatch, "iso_run_rows", rows)
    _iso_vs_plain(no_plain_on_cuda, (1, rows + delta, width), ksize, seed=ksize)


@pytest.mark.parametrize("ksize", [3, 9, 55])
@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 5, 3), (1, 37, 53), (2, 17, 65), (1, 129, 1283)])
def test_iso_kernel_float_strips(cuda, no_plain_on_cuda, shape, ksize):
    """The float32 instance (the cat's) from 1x1 frames to strips and runs."""
    _iso_vs_plain(no_plain_on_cuda, shape, ksize, as_float=True)


@pytest.mark.parametrize("as_float", [False, True])
def test_iso_kernel_frames_independent(cuda, no_plain_on_cuda, as_float):
    """Each frame of a batch equals the same frame alone, bit for bit, and
    two runs are bit-equal."""
    params = _table(F.iso_params(color.collapse_lms_matrix(0.58, 0.65), 3.5), cuda)
    x = _frames((3, 70, 130), cuda, seed=3)
    scale = F.scale_of(x)
    if as_float:
        x = (x.float() / 255.0).contiguous()
        scale = torch.ones(3, device=cuda)
    got = F.iso_u8(x, scale, params)
    assert torch.equal(got, F.iso_u8(x, scale, params))
    for i in range(3):
        assert torch.equal(got[i:i + 1], F.iso_u8(x[i:i + 1].contiguous(), scale[i:i + 1], params))


def test_iso_raises_naming_ksize(cuda):
    """A kernel size above ISO_MAX_TAPS raises and names its size; nothing
    falls back. The library's shared memory per block is the wrapper's count."""
    for k, elem in ((1, 1), (3, 1), (29, 1), (55, 1), (9, 4), (55, 4)):
        assert F.library_iso_smem_bytes(k, elem) == F.iso_smem_bytes(k, elem)
    params = torch.cat([torch.eye(3, device=cuda).reshape(9), torch.full((57,), 1.0 / 57, device=cuda)])
    x = torch.zeros(1, 8, 8, 3, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="ksize 57"):
        F.iso_u8(x, F.scale_of(x), params)


def _streak_vs_plain(no_plain_on_cuda, name, shape, r_fixed=None, seed=0):
    spec = NONUV_SPECS[name]
    chroma = spec.effects[1].params[0] if len(spec.effects) == 2 else None
    tab, mix, _ = F.streak_tables(shape[1], spec.effects[0].params, spec.alpha, spec.s_scale, r_fixed)
    x = _frames(shape, "cpu", seed=seed)
    scale = F.scale_of(x)
    got = F.streak_u8(x.to("cuda"), scale.to("cuda"), _table(tab, "cuda"), _table(mix, "cuda"), chroma)
    want = no_plain_on_cuda["streak_u8_plain"](x, scale, torch.from_numpy(tab), torch.from_numpy(mix), chroma)
    assert got.shape == x.shape and got.dtype == torch.uint8
    assert _lsb(got.cpu(), want) <= 1


@pytest.mark.parametrize("name", ["deer", "rabbit"])
@pytest.mark.parametrize("width", [1, 63, 64, 65, 129, 1283])
@pytest.mark.parametrize("height", [(1, 1), (7, 1), (7, 3), (16, 5), (16, 32)])
def test_streak_kernel_rows(cuda, no_plain_on_cuda, monkeypatch, height, width, name):
    """Two frames of h rows shared by 1, 3, 5 or 32 blocks (the count
    pinned), so that blocks end mid-frame and open a second frame; widths 1
    to 1283 (rows that start off 16 bytes, a last thread's ragged window)."""
    h, blocks = height
    _pinned(monkeypatch, "streak_blocks", blocks)
    _streak_vs_plain(no_plain_on_cuda, name, (2, h, width), seed=width)


@pytest.mark.parametrize("r_fixed", [16, 17, 40])
@pytest.mark.parametrize("shape", [(1, 9, 130), (2, 5, 3)])
def test_streak_kernel_wide_radius(cuda, no_plain_on_cuda, shape, r_fixed):
    """Tables widened with zeros to r = 16 (the register-window path's
    largest), 17 and 40 (taken pixel by pixel)."""
    _streak_vs_plain(no_plain_on_cuda, "deer", shape, r_fixed=r_fixed)


@pytest.mark.parametrize("name", ["deer", "rabbit"])
def test_streak_kernel_frames_independent(cuda, no_plain_on_cuda, name):
    """Each frame of a batch equals the same frame alone, bit for bit, and
    two runs are bit-equal."""
    spec = NONUV_SPECS[name]
    chroma = spec.effects[1].params[0] if len(spec.effects) == 2 else None
    tab, mix, _ = F.streak_tables(70, spec.effects[0].params, spec.alpha, spec.s_scale)
    tab, mix = _table(tab, cuda), _table(mix, cuda)
    x = _frames((3, 70, 130), cuda, seed=4)
    scale = F.scale_of(x)
    got = F.streak_u8(x, scale, tab, mix, chroma)
    assert torch.equal(got, F.streak_u8(x, scale, tab, mix, chroma))
    for i in range(3):
        assert torch.equal(got[i:i + 1], F.streak_u8(x[i:i + 1].contiguous(), scale[i:i + 1], tab, mix, chroma))


# W = 1, 7, 15 (the narrow-frame row path), 16, 17, 1283; H W not a
# multiple of 16; frames of an odd byte count, so frame n >= 1 starts off
# 16 bytes (3 x 5 x 1283 x 3 bytes, 2 x 7 x 7 x 3, ...)
POINTWISE_SHAPES = SHAPES + [(2, 7, 1), (3, 5, 7), (2, 9, 15), (2, 4, 16), (3, 6, 17), (3, 5, 1283),
                             (2, 33, 1283), (1, 1, 1283), (4, 1, 17)]


def _at_offset(x, offset):
    """``x`` copied into a buffer at a byte ``offset``: a contiguous tensor
    whose data starts ``offset`` bytes past an aligned allocation."""
    buf = torch.empty(x.numel() + offset, dtype=x.dtype, device=x.device)
    buf[offset:].copy_(x.reshape(-1))
    return buf[offset:].view(x.shape)


def _pointwise_tables(h, with_gain, device):
    mat9 = _table(color.collapse_lms_matrix(0.05, 0.86).reshape(9), device)
    gain = _table(F.scone_gain(h, NONUV_SPECS["rat"].effects[0].params), device) if with_gain else None
    return mat9, gain


@pytest.mark.parametrize("offset", [0, 1, 6])
@pytest.mark.parametrize("shape", POINTWISE_SHAPES)
@pytest.mark.parametrize("with_gain", [False, True])
def test_pointwise_kernel(cuda, no_plain_on_cuda, shape, with_gain, offset):
    """<= 1 LSB from the plain version from 1x1 frames to W = 1283, with
    and without the rat's gain, on batches that start 0, 1 or 6 bytes past
    16 (units then store byte by byte: the output is aligned)."""
    mat9, gain = _pointwise_tables(shape[1], with_gain, cuda)
    x = _at_offset(_frames(shape, cuda), offset)
    _kernel_vs_plain(
        lambda a, s: F.pointwise_u8(a, s, mat9, gain),
        lambda a, s: no_plain_on_cuda["pointwise_u8_plain"](a, s, mat9.cpu(), None if gain is None else gain.cpu()),
        x, F.scale_of(x), "pointwise_u8")


@pytest.mark.parametrize("shape", [(3, 70, 130), (3, 5, 1283), (5, 3, 7)])
@pytest.mark.parametrize("with_gain", [False, True])
def test_pointwise_kernel_frames_independent(cuda, no_plain_on_cuda, shape, with_gain):
    """Each frame of a batch equals the same frame alone, bit for bit, as a
    copy and as the batch's own slice (which may start anywhere within 16
    bytes), and two runs are bit-equal."""
    mat9, gain = _pointwise_tables(shape[1], with_gain, cuda)
    x = _frames(shape, cuda, seed=6)
    scale = F.scale_of(x)
    got = F.pointwise_u8(x, scale, mat9, gain)
    assert torch.equal(got, F.pointwise_u8(x, scale, mat9, gain))
    for i in range(shape[0]):
        alone = F.pointwise_u8(x[i:i + 1].clone(), scale[i:i + 1], mat9, gain)
        assert torch.equal(got[i:i + 1], alone)
        assert torch.equal(got[i:i + 1], F.pointwise_u8(x[i:i + 1], scale[i:i + 1], mat9, gain))
        assert torch.equal(got[i], F.pointwise_u8(x[i], scale[i:i + 1], mat9, gain))


def test_pointwise_blocks_fit_the_card(cuda):
    """The library's slots hold at least one block per SM for both
    instances, and a 1080p batch of 4 gets one wave of them."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for use_gain in (False, True):
        slots = F.pointwise_slots(torch.cuda.current_device(), use_gain)
        assert slots >= sms
        assert F.pointwise_blocks(4, 1080 * 1920, slots) == slots // 4


@pytest.mark.parametrize("name", NON_UV_NAMES)
def test_species_on_card_vs_cpu(cuda, no_plain_on_cuda, name):
    frame = _frames((1, 72, 130), "cpu", seed=5)[0].numpy()
    base_g, out_g = get_animal(name, cuda).visualize(frame)
    base_c, out_c = get_animal(name, "cpu").visualize(frame)
    assert _lsb(torch.from_numpy(out_g), torch.from_numpy(out_c)) <= 1
    assert _lsb(torch.from_numpy(base_g), torch.from_numpy(base_c)) <= 1


@pytest.mark.parametrize("ksize", [3, 7, 19, 37])
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 1, 1), (1, 1, 50), (1, 50, 1), (3, 9, 5), (1, 70, 130)])
def test_blur_uv_kernel(cuda, no_plain_on_cuda, shape, channels, ksize):
    """Within 1e-5 of the plain version on [0, 1] data, from 1x1 frames and
    frames narrower than the kernel to several tiles per frame."""
    x = torch.from_numpy(np.random.default_rng(ksize).random((*shape, channels), dtype=np.float32))
    sigma = (ksize - 1) / 6  # uv_ksize(sigma) == ksize
    assert blur.uv_ksize(sigma) == ksize
    taps = blur.uv_taps(sigma, "cpu")
    before = _build.LAUNCHES["blur_uv"]
    got = B.blur_uv(x.to(cuda), taps.to(cuda))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["blur_uv"] == before + 1
    want = no_plain_on_cuda["blur_uv_plain"](x, taps)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert (got.cpu() - want).abs().max().item() <= 1e-5


def _blur_vs_plain(no_plain_on_cuda, shape, channels, ksize, seed=0):
    x = torch.from_numpy(np.random.default_rng(seed + ksize).random((*shape, channels), dtype=np.float32))
    taps = blur.uv_taps((ksize - 1) / 6, "cpu")
    got = B.blur_uv(x.to("cuda"), taps.to("cuda"))
    want = no_plain_on_cuda["blur_uv_plain"](x, taps)
    assert got.shape == x.shape
    assert (got.cpu() - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("ksize", [3, 19])
@pytest.mark.parametrize("channels", [1, 2, 3, 8])
@pytest.mark.parametrize("rows", [16, 64, 128])
@pytest.mark.parametrize("height,width", [((1, 0), 65), ((18, 0), 63), ((-1, 1), 130), ((1, 1), 1), ((3, 2), 65)])
def test_blur_uv_kernel_runs(cuda, no_plain_on_cuda, monkeypatch, height, width, rows, channels, ksize):
    """Runs of 16, 64 and 128 rows (the wrapper's run length pinned), with
    heights (a, b) of a + b runs: 1, k - 1 (at k = 19), a run less one row,
    a run plus one and two runs plus 3, so that runs end mid-frame and
    groups of 4 rows are ragged; widths of 1, 63, 65 and 130; C from 1 to
    8."""
    monkeypatch.setattr(B, "RUN_ROWS", (rows,))
    h = height[0] + height[1] * rows
    assert B.run_rows(1, h, width, channels) == rows
    _blur_vs_plain(no_plain_on_cuda, (1, h, width), channels, ksize)


@pytest.mark.parametrize("channels", [1, 3, 8])
def test_blur_uv_kernel_frames_independent(cuda, no_plain_on_cuda, channels):
    """Each frame of a batch equals the same frame alone, bit for bit, and
    two runs are bit-equal."""
    x = torch.from_numpy(np.random.default_rng(channels).random((3, 70, 130, channels), dtype=np.float32)).to(cuda)
    taps = blur.uv_taps(3.0, "cuda")
    got = B.blur_uv(x, taps)
    assert torch.equal(got, B.blur_uv(x, taps))
    for i in range(x.shape[0]):
        assert torch.equal(got[i:i + 1], B.blur_uv(x[i:i + 1].contiguous(), taps))


def test_blur_uv_raises_above_shared_memory(cuda):
    """A kernel too wide for the card's shared memory raises and names its
    size; nothing falls back to the plain version. The library's shared
    memory per block is the wrapper's count."""
    for k, c in ((3, 1), (19, 3), (37, 8)):
        assert B.library_smem_bytes(k, c) == B.smem_bytes(k, c)
    ksize = 301
    taps = torch.full((ksize,), 1.0 / ksize, device=cuda)
    with pytest.raises(ValueError, match=f"ksize {ksize}"):
        B.blur_uv(torch.zeros(1, 8, 8, 3, device=cuda), taps)


@pytest.mark.parametrize("name", PORTED_UV_NAMES)
def test_uv_species_on_card_vs_cpu(cuda, no_plain_on_cuda, psnr_fn, name):
    frame = _frames((1, 72, 130), "cpu", seed=6)[0].numpy()
    before = _build.LAUNCHES["blur_uv"]
    base_g, out_g = get_animal(name, cuda).visualize(frame)
    assert _build.LAUNCHES["blur_uv"] > before
    base_c, out_c = get_animal(name, "cpu").visualize(frame)
    assert psnr_fn(out_g / 255.0, out_c / 255.0) >= 40.0
    assert _lsb(torch.from_numpy(base_g), torch.from_numpy(base_c)) <= 1


# --- MST++ kernels (ops/fused_msab.py); inputs of scale 0.5, weights of 0.2 ---

MST_SHAPES = [(1, 8, 8), (2, 13, 21), (1, 9, 7), (1, 40, 67)]


def _randn(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _msab_weights(rng, c):
    return M.MsabWeights(
        heads=c // 31, wq=_randn(rng, c, c, scale=0.2), wk=_randn(rng, c, c, scale=0.2),
        wv=_randn(rng, c, c, scale=0.2), rescale=torch.from_numpy(rng.uniform(0.5, 1.5, c // 31).astype(np.float32)),
        wproj=_randn(rng, c, c, scale=0.2), bproj=_randn(rng, c, scale=0.2), pos0=_randn(rng, 3, 3, c, scale=0.2),
        pos2=_randn(rng, 3, 3, c, scale=0.2), ln_w=1.0 + _randn(rng, c, scale=0.2), ln_b=_randn(rng, c, scale=0.2),
        w0=_randn(rng, c, 4 * c, scale=0.2), dw=_randn(rng, 3, 3, 4 * c, scale=0.2),
        w4=_randn(rng, 4 * c, c, scale=0.2))


def _to(blk, device):
    return M.MsabWeights(blk.heads, *(t.to(device) for t in blk[1:]))


def _counted(kernel, fn, *args):
    before = _build.LAUNCHES[kernel]
    out = fn(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[kernel] == before + 1
    return out


# Output shapes (frames, rows, columns): narrower and shorter than one
# output tile (8x32 at K = 3, 8x16 and 4x16 at K = 4), widths that are not
# a multiple of the tile, several frames.
CONV_OUT_SHAPES = [(1, 1, 1), (1, 1, 7), (1, 5, 3), (3, 9, 37), (1, 8, 8), (2, 13, 21), (1, 9, 7), (1, 40, 67)]
CONV_CASES = [(3, 31, 3, False), (31, 31, 3, False), (31, 31, 3, True), (31, 62, 4, False), (62, 124, 4, False)]


def _conv_operands(shape, cin, cout, k, residual, odd=(0, 0)):
    """Inputs of scale 0.5 whose output is ``shape`` (n, ho, wo), a weight of
    scale 0.2 and the residual. At K = 4 the input has 2 ho + odd[0] rows
    and 2 wo + odd[1] columns."""
    n, ho, wo = shape
    rng = np.random.default_rng(cin + cout + k + ho * wo)
    hi, wi = (ho, wo) if k == 3 else (2 * ho + odd[0], 2 * wo + odd[1])
    assert M.conv_out_hw(hi, wi, k) == (ho, wo)
    x = _randn(rng, n, hi, wi, cin, scale=0.5)
    w = _randn(rng, k, k, cin, cout, scale=0.2)
    r = _randn(rng, n, ho, wo, cout, scale=0.5) if residual else None
    return x, w, r


@pytest.mark.parametrize("shape", CONV_OUT_SHAPES)
@pytest.mark.parametrize("cin,cout,k,residual", CONV_CASES)
def test_msab_conv_kernel(cuda, no_plain_on_cuda, shape, cin, cout, k, residual):
    x, w, r = _conv_operands(shape, cin, cout, k, residual)
    got = _counted("conv_kernel", M.conv, x.to(cuda), w.to(cuda), None if r is None else r.to(cuda))
    want = no_plain_on_cuda["conv_plain"](x, w, r)
    assert got.shape == want.shape
    assert (got.cpu() - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("odd", [(1, 1), (1, 0), (0, 1)])
@pytest.mark.parametrize("shape", CONV_OUT_SHAPES)
@pytest.mark.parametrize("cin,cout", [(31, 62), (62, 124)])
def test_msab_conv_kernel_odd_input(cuda, no_plain_on_cuda, shape, cin, cout, odd):
    """4x4 stride 2 on an odd number of input rows or columns: the last
    outputs then read a last input row or column of data, not the zero
    pad."""
    x, w, _ = _conv_operands(shape, cin, cout, 4, False, odd)
    got = _counted("conv_kernel", M.conv, x.to(cuda), w.to(cuda), None)
    want = no_plain_on_cuda["conv_plain"](x, w, None)
    assert got.shape == want.shape == (*shape, cout)
    assert (got.cpu() - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("cin,cout,k,residual", CONV_CASES)
def test_msab_conv_kernel_frames_independent(cuda, no_plain_on_cuda, cin, cout, k, residual):
    """Each frame of a batch equals the same frame alone, bit for bit, and
    two runs are bit-equal: every output is one block's fixed-order sum."""
    x, w, r = (None if t is None else t.to(cuda) for t in _conv_operands((3, 9, 37), cin, cout, k, residual))
    got = M.conv(x, w, r)
    assert torch.equal(got, M.conv(x, w, r))
    for i in range(x.shape[0]):
        alone = M.conv(x[i:i + 1].contiguous(), w, None if r is None else r[i:i + 1].contiguous())
        assert torch.equal(got[i:i + 1], alone)


def test_msab_conv_kernel_raises_on_other_shapes(cuda):
    """The card's kernel is built for the four MST++ shapes; others raise."""
    with pytest.raises(ValueError, match="built for"):
        M.conv(torch.zeros(1, 8, 8, 31, device=cuda), torch.zeros(3, 3, 31, 62, device=cuda))


@pytest.mark.parametrize("shape", MST_SHAPES)
@pytest.mark.parametrize("c", M.MSAB_CHANNELS)
def test_attn_stats_kernel(cuda, no_plain_on_cuda, shape, c):
    """Within 1e-5 of max |G| of the plain version, and bit-equal over two
    runs (a fixed-order two-stage sum, no atomics)."""
    rng = np.random.default_rng(c)
    x = _randn(rng, *shape, c, scale=0.5)
    wq, wk = _randn(rng, c, c, scale=0.2), _randn(rng, c, c, scale=0.2)
    args = (x.to(cuda), wq.to(cuda), wk.to(cuda), c // 31)
    got = _counted("attn_stats_kernel", M.attn_stats, *args)
    again = M.attn_stats(*args)
    want = no_plain_on_cuda["attn_stats_plain"](x, wq, wk, c // 31)
    for a, b, r in zip(got, want, again):
        assert a.shape == b.shape
        assert (a.cpu() - b).abs().max().item() <= 1e-5 * b.abs().max().item()
        assert torch.equal(a, r)


@pytest.mark.parametrize("c", M.MSAB_CHANNELS)
def test_attn_stats_kernel_frames_independent(cuda, no_plain_on_cuda, c):
    """Each frame of a batch gives the same bits as the frame alone (the
    block count is a function of the pixel count only), and two runs are
    bit-equal."""
    rng = np.random.default_rng(c + 4)
    x = _randn(rng, 3, 17, 33, c, scale=0.5).to(cuda)
    wq, wk = _randn(rng, c, c, scale=0.2).to(cuda), _randn(rng, c, c, scale=0.2).to(cuda)
    got = M.attn_stats(x, wq, wk, c // 31)
    for a, b in zip(got, M.attn_stats(x, wq, wk, c // 31)):
        assert torch.equal(a, b)
    for i in range(x.shape[0]):
        for a, b in zip(got, M.attn_stats(x[i:i + 1].contiguous(), wq, wk, c // 31)):
            assert torch.equal(a[i:i + 1], b)


def _msab_operands(shape, c):
    rng = np.random.default_rng(c + 1)
    x = _randn(rng, *shape, c, scale=0.5)
    blk = _msab_weights(rng, c)
    m = _randn(rng, shape[0], c, c, scale=0.2)
    return x, m, blk


@pytest.mark.parametrize("shape", MST_SHAPES + [(1, 1, 1), (1, 1, 7), (1, 5, 3)])
@pytest.mark.parametrize("c", M.MSAB_CHANNELS)
def test_msab_pos_kernel(cuda, no_plain_on_cuda, shape, c):
    """The first half of pass B within 1e-4 of its plain version, from 1x1
    frames and frames narrower than one tile up."""
    x, m, blk = _msab_operands(shape, c)
    got = _counted("msab_apply_kernel", M.msab_pos, x.to(cuda), m.to(cuda), _to(blk, cuda))
    want = no_plain_on_cuda["msab_pos_plain"](x, m, blk)
    assert got.shape == want.shape
    assert (got.cpu() - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("shape", MST_SHAPES)
@pytest.mark.parametrize("c", M.MSAB_CHANNELS)
def test_msab_apply_kernel(cuda, no_plain_on_cuda, shape, c):
    """Pass B: the pos kernel, then the FFN kernel."""
    x, m, blk = _msab_operands(shape, c)
    before = _build.LAUNCHES["ffn"]
    got = _counted("msab_apply_kernel", M.msab_apply, x.to(cuda), m.to(cuda), _to(blk, cuda))
    assert _build.LAUNCHES["ffn"] == before + 1
    want = no_plain_on_cuda["msab_apply_plain"](x, m, blk)
    assert (got.cpu() - want).abs().max().item() <= 5e-4


@pytest.mark.parametrize("c", M.MSAB_CHANNELS)
def test_msab_apply_kernel_frames_independent(cuda, no_plain_on_cuda, c):
    """Each frame of a batch equals the same frame alone, bit for bit, and
    two runs are bit-equal."""
    x, m, blk = _msab_operands((3, 17, 33), c)
    x, m, blk = x.to(cuda), m.to(cuda), _to(blk, cuda)
    got = M.msab_apply(x, m, blk)
    assert torch.equal(got, M.msab_apply(x, m, blk))
    for i in range(x.shape[0]):
        assert torch.equal(got[i:i + 1], M.msab_apply(x[i:i + 1].contiguous(), m[i:i + 1].contiguous(), blk))


def _gate(rng, shape, c):
    """A (1, H, W, C) gate of MST-L's range: m sigmoid(g) + m."""
    m, g = _randn(rng, 1, *shape[1:], c, scale=0.5), _randn(rng, 1, *shape[1:], c)
    return m * torch.sigmoid(g) + m


@pytest.mark.parametrize("shape", MST_SHAPES + [(1, 1, 1), (1, 1, 7), (1, 5, 3), (2, 33, 70)])
@pytest.mark.parametrize("c", M.MSAB_CHANNELS)
def test_msab_pos_masked_kernel(cuda, no_plain_on_cuda, shape, c):
    """The masked form (MST-L): within 1e-4 of its plain version, counted
    as ``msab_masked_kernel`` and not as the unmasked launch."""
    x, m, blk = _msab_operands(shape, c)
    gate = _gate(np.random.default_rng(c + 3), shape, c)
    before = _build.LAUNCHES["msab_apply_kernel"]
    got = _counted("msab_masked_kernel", M.msab_pos, x.to(cuda), m.to(cuda), _to(blk, cuda), gate.to(cuda))
    assert _build.LAUNCHES["msab_apply_kernel"] == before
    want = no_plain_on_cuda["msab_pos_plain"](x, m, blk, gate)
    assert got.shape == want.shape
    assert (got.cpu() - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("c", M.MSAB_CHANNELS)
def test_msab_pos_masked_kernel_frames_independent(cuda, no_plain_on_cuda, c):
    """A batch of 2 with one gate equals each frame alone, bit for bit, and
    two runs are bit-equal."""
    x, m, blk = _msab_operands((2, 17, 33), c)
    gate = _gate(np.random.default_rng(c + 4), (2, 17, 33), c).to(cuda)
    x, m, blk = x.to(cuda), m.to(cuda), _to(blk, cuda)
    got = M.msab_pos(x, m, blk, gate)
    assert torch.equal(got, M.msab_pos(x, m, blk, gate))
    for i in range(x.shape[0]):
        assert torch.equal(got[i:i + 1], M.msab_pos(x[i:i + 1].contiguous(), m[i:i + 1].contiguous(), blk, gate))


def test_msab_pos_tile_raises_above_shared_memory(cuda):
    """Two blocks of the 8x16 tile fit an SM of this card at C = 31, of 8x8
    at C = 62 and of 4x8 at C = 124, and the library's shared memory per
    block is the wrappers' count; where two do not fit, the wrapper raises
    and names C and the tile."""
    limit = _build.two_block_smem_limit(torch.cuda.current_device())
    assert [M.pos_tile_for(c, limit) for c in M.MSAB_CHANNELS] == [(8, 16), (8, 8), (4, 8)]
    for c in M.MSAB_CHANNELS:
        assert M.kernel_smem_bytes("pos", c) == M.pos_smem_bytes(c, M.POS_TILES[c])
        assert M.kernel_smem_bytes("stats", c) == M.stats_smem_bytes(c)
    with pytest.raises(ValueError, match="C = 62 .* 8x8 tile"):
        M.pos_tile_for(62, 64 * 1024)


def _up_operands(shape, c):
    """fea, skip and the decoder level's weights; the bias's four (dy, dx)
    copies differ."""
    rng = np.random.default_rng(c + 2)
    n, h, w = shape
    fea = _randn(rng, n, h, w, c, scale=0.5)
    skip = _randn(rng, n, 2 * h, 2 * w, c // 2, scale=0.5)
    raw = (_randn(rng, c, 2, 2, c // 2, scale=0.2), _randn(rng, 2, 2, c // 2, scale=0.2),
           _randn(rng, c, c // 2, scale=0.2))
    return fea, skip, raw


@pytest.mark.parametrize("shape", [(1, 4, 4), (2, 7, 11), (1, 17, 30), (1, 33, 70), (2, 9, 130), (1, 1, 1)])
@pytest.mark.parametrize("c", [124, 62])
def test_up_fuse_kernel(cuda, no_plain_on_cuda, shape, c):
    """Several tiles with ragged edges, against the plain version's two
    products from the raw weights."""
    fea, skip, raw = _up_operands(shape, c)
    uw = M.up_fuse_weights(*raw)
    got = _counted("up_fuse_kernel", M.up_fuse, fea.to(cuda), skip.to(cuda),
                   M.up_fuse_weights(*(t.to(cuda) for t in raw)))
    want = no_plain_on_cuda["up_fuse_plain"](fea, skip, uw)
    assert got.shape == want.shape
    assert (got.cpu() - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("c", [124, 62])
def test_up_fuse_kernel_frames_independent(cuda, no_plain_on_cuda, c):
    """Each frame of a batch equals the same frame alone, bit for bit, and
    two runs are bit-equal."""
    fea, skip, raw = _up_operands((3, 9, 21), c)
    fea, skip, uw = fea.to(cuda), skip.to(cuda), M.up_fuse_weights(*(t.to(cuda) for t in raw))
    got = M.up_fuse(fea, skip, uw)
    assert torch.equal(got, M.up_fuse(fea, skip, uw))
    for i in range(fea.shape[0]):
        assert torch.equal(got[i:i + 1], M.up_fuse(fea[i:i + 1].contiguous(), skip[i:i + 1].contiguous(), uw))


def test_up_fuse_tile_raises_above_shared_memory(cuda):
    """Two blocks of the 8x8 tile fit an SM of this card at C = 62 and of
    4x8 at C = 124, and the library's shared memory per block is the
    wrapper's count; where two do not fit, the wrapper raises and names C
    and the tile."""
    limit = _build.two_block_smem_limit(torch.cuda.current_device())
    assert [M.up_tile_for(c, limit) for c in (62, 124)] == [(8, 8), (4, 8)]
    for c in (62, 124):
        assert M.kernel_smem_bytes("up_fuse", c) == M.up_smem_bytes(c, M.UP_TILES[c])
    with pytest.raises(ValueError, match="C = 124 .* 4x8 tile"):
        M.up_tile_for(124, 128 * 1024)


def test_mst_on_card_vs_cpu(cuda, no_plain_on_cuda):
    """The shipped model at 64x96 (and 37x53, padded to 40x56): kernels on
    the card against the plain versions on the CPU, < 5e-4, with the
    per-forward launch counts (pass B's second half is the FFN kernel)."""
    gpu, cpu = load_shipped(cuda), load_shipped("cpu")
    for shape in [(1, 64, 96, 3), (2, 37, 53, 3)]:
        x = torch.from_numpy(np.random.default_rng(7).random(shape, dtype=np.float32))
        _build.reset_launches()
        with torch.no_grad():
            got = gpu(x.to(cuda))
            torch.cuda.synchronize()
            assert _launches(*MSAB_KEYS) == {"conv_kernel": 14, "attn_stats_kernel": 15, "msab_apply_kernel": 15,
                                             "up_fuse_kernel": 6, "msab_masked_kernel": 0}
            assert _build.LAUNCHES["ffn"] == 15
            want = cpu(x)
        assert got.shape == want.shape == (*shape[:3], 31)
        assert (got.cpu() - want).abs().max().item() < 5e-4


@pytest.mark.parametrize("cls", [Kestrel, Goldfish])
def test_uv_species_with_mst_on_card_vs_cpu(cuda, no_plain_on_cuda, psnr_fn, cls):
    frame = _frames((1, 72, 130), "cpu", seed=8)[0].numpy()
    before = _build.LAUNCHES["msab_apply_kernel"]
    _, out_g = attach_mst(cls(cuda), load_shipped(cuda)).visualize(frame)
    assert _build.LAUNCHES["msab_apply_kernel"] == before + 15
    _, out_c = attach_mst(cls("cpu"), load_shipped("cpu")).visualize(frame)
    assert psnr_fn(out_g / 255.0, out_c / 255.0) >= 40.0


# --- MST-L's FFN kernel (ops/fused_mst.py) and the model ---


FFN_SHAPES = [(1, 1, 1), (1, 1, 7), (3, 5, 3), (2, 9, 13), (1, 8, 16), (1, 17, 33), (2, 40, 67), (4, 68, 120)]


def _ffn_operands(shape, c):
    rng = np.random.default_rng(c + 3)
    x = _randn(rng, *shape, c, scale=0.5)
    ws = (1.0 + _randn(rng, c, scale=0.2), _randn(rng, c, scale=0.2), _randn(rng, c, 4 * c, scale=0.2),
          _randn(rng, 3, 3, 4 * c, scale=0.2), _randn(rng, 4 * c, c, scale=0.2))
    return x, ws


@pytest.mark.parametrize("shape", FFN_SHAPES)
@pytest.mark.parametrize("c", T.FFN_CHANNELS)
def test_ffn_kernel(cuda, no_plain_on_cuda, shape, c):
    """From 1x1 frames and frames narrower than one tile to C = 124 at
    4 x 68 x 120 (the 272x480 operating point's deepest level)."""
    x, ws = _ffn_operands(shape, c)
    before = _build.LAUNCHES["ffn"]
    got = T.ffn(x.to(cuda), *(t.to(cuda) for t in ws))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ffn"] == before + 1
    want = no_plain_on_cuda["ffn_plain"](x, *ws)
    assert got.shape == want.shape
    assert (got.cpu() - want).abs().max().item() <= 1e-4


# SHA-256 of the output bytes of the kernel that split its operands at every
# fragment load, for _ffn_operands(shape, c); splitting each operand once
# computes the same fragments in the same order, so the bits must not move.
FFN_DIGESTS = {
    ((2, 40, 67), 31): "8bb32a44a34501c9fdee99fe072e379b3572a5984be36384bad9a7069a06ce7f",
    ((2, 40, 67), 62): "fcd413a832a3e03692da06ebbb1b0df417095fec9d4b7f7ad4ae126f20770d17",
    ((2, 40, 67), 124): "c0ac606e2fb43300994b0fe2d16a0c34dd714d38b48949850ca66773fcf99207",
    ((4, 68, 120), 31): "f6bc483694c91c264fa18f7516e246dc2796ada713609b465a83f0814b4ecb40",
    ((4, 68, 120), 62): "07e5a35ca0993ec87eb19e5e200ee2b1aef08c5aff2c493d0c521c20311dc1ab",
    ((4, 68, 120), 124): "e8e7725f4fff17fa5026e19cd3f87450ac756d4fae88895c0476119ac11dd4ff",
    ((1, 136, 240), 31): "a8657f5affb0448763c8ea6805b9a40ad1b8a5d4279ba0258374c3e8ef2ab109",
    ((1, 136, 240), 62): "f7f99c75d8f607e47901a550e9cfc9be083aa21e03d43fb21ca42988f4c78459",
    ((1, 136, 240), 124): "d6ef2549c92265b45a3add03e331d6f47f7997baf6fab66050e336ff6b2d84ef",
    ((1, 68, 120), 31): "4cb47e0c995ccb14a2f40af57a3678ebd7a9a35752f5c4d40491f701abd287bb",
    ((1, 68, 120), 62): "4bb5bd622c15f10e61d6a4686e3aa85631252da897f69190111c33cfde61910a",
    ((1, 68, 120), 124): "d885d72fb10e64128e385b5a490d7155684777a2e8e082a2ca10bdea8bc2b38b",
}


@pytest.mark.parametrize("shape,c", sorted(FFN_DIGESTS))
def test_ffn_kernel_bits_as_recorded(cuda, no_plain_on_cuda, shape, c):
    """Ragged tiles (2 x 40 x 67), the 272x480 point's deepest level in a
    batch of 4, and MST-L's levels one frame at a time (136 x 240, 68 x 120):
    the output bytes hash to the digest recorded before the operands were
    split once."""
    x, ws = _ffn_operands(shape, c)
    got = T.ffn(x.to(cuda), *(t.to(cuda) for t in ws))
    assert hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest() == FFN_DIGESTS[(shape, c)]


@pytest.mark.parametrize("c", T.FFN_CHANNELS)
def test_ffn_two_blocks_per_sm(cuda, c):
    """The kernel built for each C keeps two blocks (16 warps) on an SM, so
    MST-L's small grids at C = 62 and 124 still fit one partial wave."""
    assert T.blocks_per_sm(c, torch.cuda.current_device()) == 2


@pytest.mark.parametrize("c", T.FFN_CHANNELS)
def test_ffn_kernel_frames_independent(cuda, no_plain_on_cuda, c):
    """Each frame of a batch equals the same frame alone, bit for bit, and
    two runs are bit-equal."""
    x, ws = _ffn_operands((3, 17, 33), c)
    x, ws = x.to(cuda), tuple(t.to(cuda) for t in ws)
    got = T.ffn(x, *ws)
    assert torch.equal(got, T.ffn(x, *ws))
    for i in range(x.shape[0]):
        assert torch.equal(got[i:i + 1], T.ffn(x[i:i + 1].contiguous(), *ws))


def test_ffn_tile_raises_above_shared_memory(cuda):
    """Two blocks of the 8x16 tile fit an SM of this card at C = 31 and 62,
    of 8x8 at C = 124; where two do not fit, the wrapper raises and names C
    and the tile."""
    limit = _build.two_block_smem_limit(torch.cuda.current_device())
    assert [T.tile_for(c, limit) for c in T.FFN_CHANNELS] == [(8, 16), (8, 16), (8, 8)]
    with pytest.raises(ValueError, match="C = 124 .* 8x8 tile"):
        T.tile_for(124, 48 * 1024)


def test_mst_l_on_card_vs_cpu(cuda, no_plain_on_cuda):
    """MST-L with seeded weights at 40x67 (padded to 40x72): per forward 27
    launches each of the stats, masked pos and FFN kernels (none of the
    unmasked pos kernel), within 5e-4 of max |y| of the CPU forward."""
    gpu = zoo.model_generator("mst", device=cuda)
    cpu = zoo.model_generator("mst", device="cpu")
    x = torch.from_numpy(np.random.default_rng(9).random((1, 40, 67, 3), dtype=np.float32))
    _build.reset_launches()
    with torch.no_grad():
        got = gpu(x.to(cuda))
        torch.cuda.synchronize()
        assert _build.LAUNCHES["ffn"] == 27
        assert _launches(*MSAB_KEYS) == {"conv_kernel": 0, "attn_stats_kernel": 27, "msab_apply_kernel": 0,
                                         "up_fuse_kernel": 0, "msab_masked_kernel": 27}
        want = cpu(x)
    assert got.shape == want.shape == (1, 40, 67, 31)
    assert (got.cpu() - want).abs().max().item() <= 5e-4 * max(1.0, want.abs().max().item())


def test_mst_l_provider_replays_a_graph_per_shape(cuda, no_plain_on_cuda):
    """MST-L's provider on the card: the first frame of a shape runs the
    module and captures its forward, the other frames replay the graph.
    Every frame equals the module's own forward (the same kernels; 1e-5 of
    max |y| leaves room for cuDNN picking another algorithm under capture),
    a second call equals the first, and each frame counts 27 launches of
    the stats, masked pos and FFN kernels, replays included. Reloading the
    weights captures anew."""
    module = zoo.model_generator("mst", device=cuda, seed=0)
    provider = make_mst_hsi_provider(module, device=cuda)
    for shape in ((3, 40, 67), (2, 24, 40)):
        x = torch.from_numpy(np.random.default_rng(12).random((*shape, 3), dtype=np.float32)).to(cuda)
        with torch.no_grad():
            want = torch.cat([torch.clamp(module(x[i:i + 1]), min=0.0) for i in range(shape[0])])
        bar = 1e-5 * max(1.0, want.abs().max().item())
        outs = []
        for _ in range(2):
            _build.reset_launches()
            outs.append(provider(x))
            torch.cuda.synchronize()
            n = 27 * shape[0]
            assert _build.LAUNCHES["ffn"] == n
            assert _launches(*MSAB_KEYS) == {"conv_kernel": 0, "attn_stats_kernel": n, "msab_apply_kernel": 0,
                                             "up_fuse_kernel": 0, "msab_masked_kernel": n}
            assert (outs[-1] - want).abs().max().item() <= bar
        assert torch.equal(outs[0][1:], outs[1][1:])  # replays of one graph
    module.load_state_dict({k: v * 0.5 for k, v in module.state_dict().items()})
    with torch.no_grad():
        want = torch.cat([torch.clamp(module(x[i:i + 1]), min=0.0) for i in range(x.shape[0])])
    assert (provider(x) - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("cls", [Kestrel, MantisShrimp])
def test_uv_species_with_mst_l_on_card_vs_cpu(cuda, no_plain_on_cuda, psnr_fn, cls):
    frame = _frames((1, 72, 130), "cpu", seed=10)[0].numpy()
    before = _build.LAUNCHES["ffn"]
    _, out_g = attach_model(cls(cuda), "mst").visualize(frame)
    assert _build.LAUNCHES["ffn"] == before + 27
    _, out_c = attach_model(cls("cpu"), "mst").visualize(frame)
    assert psnr_fn(out_g / 255.0, out_c / 255.0) >= 40.0


# --- rat_uv, the blur-driven library effects and the degradation ladder ---


def test_rat_uv_mixed_batch_on_card(cuda, no_plain_on_cuda, psnr_fn):
    """A batch of two day and two night frames: the kernel path on the card
    against the CPU path (>= 40 dB, baselines within 1 LSB), each frame
    of the batch equal to the frame alone, both renderings launched."""
    from animal_vision_tpu_torch.species.uv.rat_uv import RatUV

    host = _frames((4, 72, 130), "cpu", seed=11).numpy()
    host[1::2] = (host[1::2] * 0.05).astype(np.uint8)
    assert RatUV.is_night(torch.from_numpy(host)).flatten().tolist() == [False, True, False, True]
    animal = get_animal("rat_uv", cuda)
    before = _build.LAUNCHES["blur_uv"]
    base_g, out_g = animal.visualize_batch(host)
    assert _build.LAUNCHES["blur_uv"] == before + 2  # the day and the night scatter blur
    base_c, out_c = get_animal("rat_uv", "cpu").visualize_batch(host)
    assert psnr_fn(out_g / 255.0, out_c / 255.0) >= 40.0
    assert _lsb(torch.from_numpy(base_g), torch.from_numpy(base_c)) <= 1
    for i in range(4):
        np.testing.assert_array_equal(animal.visualize(host[i])[1], out_g[i])


@pytest.mark.parametrize("shape", [(2, 72, 130, 3), (1, 37, 53, 1)])
def test_unsharp_mask_and_dog_bandpass_on_card(cuda, no_plain_on_cuda, shape):
    from animal_vision_tpu_torch.core import effects

    x = torch.from_numpy(np.random.default_rng(12).random(shape, dtype=np.float32))
    before = _build.LAUNCHES["blur_uv"]
    got = effects.unsharp_mask(x.to(cuda), 1.3, 0.7)
    band = effects.dog_bandpass(x.to(cuda), 0.8, 2.5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["blur_uv"] == before + 3
    assert (got.cpu() - effects.unsharp_mask(x, 1.3, 0.7, plain=True)).abs().max().item() <= 1e-5
    assert (band.cpu() - effects.dog_bandpass(x, 0.8, 2.5, plain=True)).abs().max().item() <= 1e-5


@pytest.mark.parametrize("name", ["dog", "rat_uv"])
def test_ladder_under_budget_on_card(cuda, no_plain_on_cuda, monkeypatch, name):
    """ANIMAL_VISION_MAX_PIXELS below the frame: the rung-1024 composition
    on the card, bit for bit, and no full-size program."""
    from animal_vision_tpu_torch.species import base
    from animal_vision_tpu_torch.species.uv.rat_uv import RatUV

    make = {"dog": lambda: NonUVAnimal(NONUV_SPECS["dog"], cuda), "rat_uv": lambda: RatUV(cuda)}[name]
    img = _frames((1, 720, 1280), "cpu", seed=13)[0].numpy()
    monkeypatch.setenv("ANIMAL_VISION_MAX_PIXELS", "600000")
    animal = make()
    before = base.RUNGS[1024]
    got = animal.visualize(img)
    assert base.RUNGS[1024] == before + 1
    assert {k[0] for k in animal._programs} == {(576, 1024, 3)}
    small = base.host_resize(img, 576, 1024, "area")
    want = [base.host_resize(o, 720, 1280, "linear") for o in make().visualize(small)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("name", ["dog", "kestrel"])
def test_streaming_executor_on_card(cuda, no_plain_on_cuda, monkeypatch, name):
    """The executor at 1080p on 7 host frames, batch 3 (a short last batch
    of 1), with a sink that keeps every frame: each frame bit-equal to
    ``visualize_batch`` of its batch after the run, no two sharing memory;
    the staging and output buffers pinned, two staging buffers in turn; the
    frames through the native ring; the copies and compute timed."""
    from pathlib import Path

    from animal_vision_tpu_torch.native import ring as R
    from animal_vision_tpu_torch.pipeline import StreamingExecutor

    seen = []
    dispatch = StreamingExecutor._dispatch_card

    def spy(self, program, host, out_buf, bases, s):
        seen.append((host.is_pinned(), out_buf.is_pinned(), host.data_ptr(), host.shape[0]))
        return dispatch(self, program, host, out_buf, bases, s)

    monkeypatch.setattr(StreamingExecutor, "_dispatch_card", spy)
    rng = np.random.default_rng(11)
    frames = [rng.integers(0, 256, (1080, 1920, 3), dtype=np.uint8) for _ in range(7)]
    animal = get_animal(name, cuda)
    ex = StreamingExecutor(animal, batch=3, split=False)
    outs = []
    assert ex.run(iter(frames), outs.append) == 7 and len(outs) == 7
    assert [k for *_, k in seen] == [3, 3, 1]
    assert all(pinned_in and pinned_out for pinned_in, pinned_out, _, _ in seen)
    assert seen[0][2] != seen[1][2] and seen[0][2] == seen[2][2]
    for start in (0, 3, 6):
        _, want = animal.visualize_batch(np.stack(frames[start:start + 3]))
        for i, w in enumerate(want):
            np.testing.assert_array_equal(outs[start + i], w)
    assert not any(np.shares_memory(a, b) for i, a in enumerate(outs) for b in outs[i + 1:])
    assert Path(ex.ring.library).parent == R.BUILD_DIR and ex.ring.reads == 3
    assert all(ex.timer.counts[k] == 3 for k in ("h2d", "compute", "d2h"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [name for name, _ in GP.CASES])
def test_gelu_probe_kernel(cuda, case, dtype):
    """The probe's kernel against its plain version on the card after 1, 8
    and all its applications, on [-2, 2) and on [-8, 8], held by
    ``gelu_probe.excess``: float32 within 1e-5 of min(1, max |y|) (the
    stencil of max |y|: its values grow 5.5^32-fold), bf16 within 2^-6 of
    each |y| (both sides round each operation once)."""
    x = torch.rand(1024, 64, generator=torch.Generator(device="cuda").manual_seed(3), device=cuda) * 4 - 2
    wide = torch.linspace(-8.0, 8.0, 1024 * 64, device=cuda).reshape(1024, 64)
    for inp in (x.to(dtype), wide.to(dtype)):
        for reps in (1, 8, GP.REPS[case]):
            _build.reset_launches()
            got = GP.run(case, inp, reps)
            assert _build.LAUNCHES[case] == 1 and got.dtype == dtype
            err, ratio = GP.excess(case, got, GP.run_plain(case, inp, reps))
            assert ratio <= 1, (reps, err, ratio)


@pytest.mark.parametrize("method", ["awan", "edsr", "hdnet", "hinet", "hrnet", "hscnn_plus", "mirnet", "mprnet",
                                    "restormer"])
def test_zoo_model_on_card_vs_cpu(cuda, method):
    """The registry configuration with the same seeded weights on the card
    and on the CPU, at an odd size: within 1e-4 of max |y| (TF32 off)."""
    x = torch.rand(2, 37, 53, 3, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = zoo.model_generator(method, device="cpu", seed=5)(x)
        got = zoo.model_generator(method, device=cuda, seed=5)(x.to(cuda)).cpu()
    assert got.shape == want.shape == (2, 37, 53, 31)
    assert (got - want).abs().max().item() <= 1e-4 * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("name", ["dog", "deer", "rat", "cat", "kestrel"])
def test_getframe_on_card_is_visualize(cuda, no_plain_on_cuda, name):
    """``POST /getframe`` through the port's ASGI app on the card, with the
    raw codec of ``chip_smoke.py`` in place of cv2: the frame ``visualize``
    gives on the card, bit for bit, and the species' kernel launched."""
    import asyncio
    import json

    import chip_smoke
    from animal_vision_tpu_torch.server.app import build_asgi_app

    frame = _frames((1, 72, 130), "cpu", seed=6)[0].numpy()
    sent = []

    async def receive():
        body = json.dumps({"image": chip_smoke.raw_uri(frame), "animal": name}).encode()
        return {"type": "http.request", "body": body, "more_body": False}

    async def send(msg):
        sent.append(msg)

    scope = {"type": "http", "method": "POST", "path": "/getframe", "query_string": b"", "headers": []}
    with chip_smoke.raw_codec(frame.shape[:2]):
        chip_smoke.reset_counters()
        asyncio.run(build_asgi_app(cuda)(scope, receive, send))
        moved = {k: v for k, v in chip_smoke.counters().items() if v}
    assert sent[0]["status"] == 200
    got = chip_smoke.raw_frame(json.loads(sent[1]["body"])["image"])
    np.testing.assert_array_equal(got, get_animal(name, cuda).visualize(frame)[1])
    kernel = "blur_uv" if name == "kestrel" else chip_smoke.expected_kernel(name)
    assert set(moved) == {kernel} and (kernel == "blur_uv" or moved[kernel] == 1)


# --- MST++ training (models/train.py): the plain versions under autograd on the card ---


def _train_pair(cuda, stage=1):
    """A seeded model on the CPU and its copy on the card, each with its
    optimizer and schedule (lr 2e-3, warmup 1), and one batch of patches."""
    from animal_vision_tpu_torch.models import train
    from animal_vision_tpu_torch.models.mst_plus_plus import MSTPlusPlus

    cfg = train.make_optimizer(lr=2e-3, total_steps=10, warmup=1)
    cpu = train.init_state(MSTPlusPlus(stage=stage), cfg, seed=3, device="cpu")
    model = MSTPlusPlus(stage=stage).to(cuda)
    model.load_state_dict(cpu.model.state_dict())
    card = train.TrainState(model, *cfg.build(model.parameters()))
    scenes = train.synthetic_scenes(2, 64, 64, 0, device="cpu")
    rng = np.random.default_rng(5)
    return cpu, card, cfg, [train.sample_patches(rng, *scenes[i % 2], 32, 2) for i in range(2)]


def test_kernel_forward_raises_under_grad(cuda):
    """The CUDA kernels have no backward: ``forward(x)`` under grad with a
    parameter that requires it raises on the card, and ``plain=True``
    trains."""
    cpu, card, _, _ = _train_pair(cuda)
    x = torch.rand(1, 16, 16, 3, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        card.model(x)
    card.model(x, plain=True).mean().backward()
    assert card.model.conv_in.weight.grad is not None


def test_train_step_on_card_vs_cpu(cuda):
    """Two train steps (the first at rate 0) on the card against the CPU from
    the same weights and patches: losses within 1e-4 relative, parameters
    within Adam's bound (2 x the rates' sum; RMS 1e-4 of it); no kernel
    launched."""
    from animal_vision_tpu_torch.models import train

    cpu, card, cfg, batches = _train_pair(cuda)
    step = train.make_train_step("mrae")
    _build.reset_launches()
    for rgb, hsi in batches:
        cpu, mc = step(cpu, rgb, hsi)
        card, mg = step(card, rgb, hsi)
        assert abs(mg["loss"].item() - mc["loss"].item()) <= 1e-4 * abs(mc["loss"].item())
    assert set(_launches(*MSAB_KEYS).values()) == {0} and _build.LAUNCHES["ffn"] == 0
    want = dict(cpu.model.named_parameters())
    diffs = torch.cat([(p.detach().cpu() - want[k].detach()).flatten() for k, p in card.model.named_parameters()])
    bound = 2 * sum(cfg.schedule(c) for c in range(len(batches)))
    assert diffs.abs().max().item() <= bound
    assert diffs.pow(2).mean().sqrt().item() <= 1e-4 * bound


def test_kernel_forward_after_a_train_step(cuda):
    """After train steps on the card (the plain versions under autograd)
    the kernel forward reads the new weights: the launches of one stage-1
    forward, within 5e-4 of the plain forward at the stepped weights, and
    unlike the forward before the steps."""
    from animal_vision_tpu_torch.models import train

    _, card, _, batches = _train_pair(cuda)
    x = torch.from_numpy(np.random.default_rng(9).random((1, 40, 64, 3), dtype=np.float32)).to(cuda)
    with torch.no_grad():
        before = card.model(x)
    step = train.make_train_step("mrae")
    for rgb, hsi in batches:
        card, _ = step(card, rgb, hsi)
    _build.reset_launches()
    with torch.no_grad():
        got = card.model(x)
        torch.cuda.synchronize()
        assert _launches(*MSAB_KEYS) == {"conv_kernel": 6, "attn_stats_kernel": 5, "msab_apply_kernel": 5,
                                         "up_fuse_kernel": 2, "msab_masked_kernel": 0}
        assert _build.LAUNCHES["ffn"] == 5
        want = card.model(x, plain=True)
    assert (got - want).abs().max().item() < 5e-4
    assert (got - before).abs().max().item() > 1e-3


def test_exported_program_on_card(cuda):
    """``models/export.py``: the shipped model's ``torch.export`` program made
    on the card runs there, within 1e-5 of max |y| of the plain forward and
    within 5e-4 of the kernel forward."""
    from animal_vision_tpu_torch.models import export

    model = load_shipped(cuda)
    fn = export.load_program(export.export_program(model, (1, 32, 48, 3)))
    x = torch.from_numpy(np.random.default_rng(10).random((1, 32, 48, 3), dtype=np.float32)).to(cuda)
    with torch.no_grad():
        got, plain, kernels = fn(x), model(x, plain=True), model(x)
    assert got.is_cuda
    assert (got - plain).abs().max().item() <= 1e-5 * plain.abs().max().item()
    assert (got - kernels).abs().max().item() < 5e-4


def test_export_of_the_kernel_forward_raises(cuda):
    """A trace cannot follow a kernel launch: ``torch.export`` of the kernel
    forward (``plain=False``) on the card raises, under ``no_grad`` too,
    instead of tracing the plain versions in its place."""

    class KernelForward(torch.nn.Module):
        def __init__(self, model):
            super().__init__()
            self.model = model

        def forward(self, x):
            return self.model(x)

    model = load_shipped(cuda)
    x = torch.zeros(1, 16, 16, 3, device=cuda)
    with torch.no_grad(), pytest.raises(RuntimeError, match="cannot be traced"):
        torch.export.export(KernelForward(model), (x,), strict=False)


def test_band_forward_on_card_two_ranks(cuda):
    """``parallel/fused_shard.py`` on the card: 2 ranks on the one card
    (gloo, host-staged transport), sp 2 at 272x480 with the shipped
    weights; each rank launches every MST++ kernel, and the whole output is
    within 5e-4 of the unsharded kernel forward."""
    import torch_parallel_checks as checks

    from animal_vision_tpu_torch.parallel.launch import spawn

    x = np.random.default_rng(12).random((1, 272, 480, 3), dtype=np.float32)
    res = spawn(checks.card_band_check, 2, cuda, timeout=300, x=x)
    model = load_shipped(cuda)
    with torch.no_grad():
        want = model(torch.from_numpy(x).to(cuda)).cpu().numpy()
    for r in res:
        if torch.cuda.device_count() < 2:
            assert r["backend"] == "gloo" and r["device"] == "cuda:0"
        assert all(r["launches"][k] > 0 for k in ("conv_kernel", "attn_stats_kernel", "msab_apply_kernel",
                                                   "up_fuse_kernel", "ffn")), r["launches"]
        assert np.abs(r["out"] - want).max() < 5e-4


@pytest.mark.parametrize("method", ["mst_plus_plus", "mst"])
def test_summary_flops_on_card_equal_cpu(cuda, method):
    """``models/summary.py`` counts the plain composition on every device:
    the card's FLOPs at 64x64 equal the CPU's (the kernel forward's
    launches would be invisible to ``FlopCounterMode``)."""
    from animal_vision_tpu_torch.models import summary

    card = summary.summarize(method, 64, 64, device=cuda)
    assert card == summary.summarize(method, 64, 64, device="cpu")
    assert card["flops"] > 0


def test_train_synth_on_card(cuda, tmp_path):
    """``tools/train_synth.py``: 100 steps of the default 8 x 64x64 patches
    on the card, the protocol by this host's route; no kernel launched by a
    step; the saved file reloads through ``quality.load_pretrained`` and
    scores the held-out scenes as the run did."""
    from animal_vision_tpu_torch.models import eval as meval
    from animal_vision_tpu_torch.models import quality
    from animal_vision_tpu_torch.models import train as Tr
    from animal_vision_tpu_torch.tools import train_synth

    launches = []
    real = Tr.make_train_step

    def counted(loss):
        step = real(loss)

        def run(state, rgb, hsi):
            before = sum(_launches(*MSAB_KEYS, "ffn").values())
            out = step(state, rgb, hsi)
            launches.append(sum(_launches(*MSAB_KEYS, "ffn").values()) - before)
            return out

        return run

    out = tmp_path / "trained.pt"
    Tr.make_train_step = counted
    try:
        r = train_synth.main(["--steps", "100", "--out", str(out)])
    finally:
        Tr.make_train_step = real
    assert r["steps"] == len(launches) == 100 and not any(launches) and np.isfinite(r["losses"]).all()
    assert r["protocol"] == quality.protocol_route()
    assert all(r["held_out"][f]["psnr"] > r["held_out_log"][0][f]["psnr"] for f in ("synth", "xgen"))
    model = quality.load_pretrained(cuda, path=out)
    _, held = train_synth.split_scenes("mixed", 24, 160, cuda)
    for family, scene in held:
        got = meval.validate(meval.model_apply_fn(model), [scene], crop=0)
        assert abs(got["psnr"] - r["held_out"][family]["psnr"]) < 1e-3
