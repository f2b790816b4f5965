"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Run on a machine with an NVIDIA card (sm_90a) and nvcc:

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Without a card every test here skips. Each test bars the plain versions
from CUDA tensors, so a pass also shows that the wrappers launch their
kernels and never fall back."""

import numpy as np
import pytest
import torch

from animal_vision_tpu_torch.core import blur, color
from animal_vision_tpu_torch.ops import fused_blur as B
from animal_vision_tpu_torch.ops import fused_nonuv as F
from animal_vision_tpu_torch.species import NON_UV_NAMES, PORTED_UV_NAMES, get_animal
from animal_vision_tpu_torch.species.nonuv import NONUV_SPECS, Cat

pytestmark = pytest.mark.gpu

SHAPES = [(2, 64, 96), (1, 37, 53), (3, 5, 3), (1, 1, 1)]


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
                      (B, "blur_uv_plain")):
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


def _table(a, device):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)


def _lsb(a, b):
    return int((a.to(torch.int16) - b.to(torch.int16)).abs().max().item())


def _kernel_vs_plain(run, plain, x, scale, kernel):
    before = F.LAUNCHES[kernel]
    got = run(x, scale)
    torch.cuda.synchronize()
    assert F.LAUNCHES[kernel] == before + 1
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
    before = F.LAUNCHES["iso_u8"]
    got = F.iso_u8(x, ones, params)
    torch.cuda.synchronize()
    assert F.LAUNCHES["iso_u8"] == before + 1
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


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_gain", [False, True])
def test_pointwise_kernel(cuda, no_plain_on_cuda, shape, with_gain):
    mat9 = _table(color.collapse_lms_matrix(0.05, 0.86).reshape(9), cuda)
    gain = _table(F.scone_gain(shape[1], NONUV_SPECS["rat"].effects[0].params), cuda) if with_gain else None
    x = _frames(shape, cuda)
    _kernel_vs_plain(
        lambda a, s: F.pointwise_u8(a, s, mat9, gain),
        lambda a, s: no_plain_on_cuda["pointwise_u8_plain"](a, s, mat9.cpu(), None if gain is None else gain.cpu()),
        x, F.scale_of(x), "pointwise_u8")


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
    before = B.LAUNCHES["blur_uv"]
    got = B.blur_uv(x.to(cuda), taps.to(cuda))
    torch.cuda.synchronize()
    assert B.LAUNCHES["blur_uv"] == before + 1
    want = no_plain_on_cuda["blur_uv_plain"](x, taps)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert (got.cpu() - want).abs().max().item() <= 1e-5


def test_blur_uv_raises_above_shared_memory(cuda):
    """A kernel too wide for the card's shared memory raises and names its
    size; nothing falls back to the plain version."""
    ksize = 201
    taps = torch.full((ksize,), 1.0 / ksize, device=cuda)
    with pytest.raises(ValueError, match=f"ksize {ksize}"):
        B.blur_uv(torch.zeros(1, 8, 8, 3, device=cuda), taps)


@pytest.mark.parametrize("name", PORTED_UV_NAMES)
def test_uv_species_on_card_vs_cpu(cuda, no_plain_on_cuda, psnr_fn, name):
    frame = _frames((1, 72, 130), "cpu", seed=6)[0].numpy()
    before = B.LAUNCHES["blur_uv"]
    base_g, out_g = get_animal(name, cuda).visualize(frame)
    assert B.LAUNCHES["blur_uv"] > before
    base_c, out_c = get_animal(name, "cpu").visualize(frame)
    assert psnr_fn(out_g / 255.0, out_c / 255.0) >= 40.0
    assert _lsb(torch.from_numpy(base_g), torch.from_numpy(base_c)) <= 1
