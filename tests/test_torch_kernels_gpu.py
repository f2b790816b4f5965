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
from animal_vision_tpu_torch.models import zoo
from animal_vision_tpu_torch.models.mst_plus_plus import load_shipped
from animal_vision_tpu_torch.models.providers import attach_model, attach_mst
from animal_vision_tpu_torch.ops import fused_blur as B
from animal_vision_tpu_torch.ops import fused_msab as M
from animal_vision_tpu_torch.ops import fused_mst as T
from animal_vision_tpu_torch.ops import fused_nonuv as F
from animal_vision_tpu_torch.species import NON_UV_NAMES, PORTED_UV_NAMES, get_animal
from animal_vision_tpu_torch.species.nonuv import NONUV_SPECS, Cat
from animal_vision_tpu_torch.species.uv.goldfish import Goldfish
from animal_vision_tpu_torch.species.uv.kestrel import Kestrel
from animal_vision_tpu_torch.species.uv.mantis_shrimp import MantisShrimp

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
                      (B, "blur_uv_plain"), (M, "conv_plain"), (M, "attn_stats_plain"),
                      (M, "msab_apply_plain"), (M, "up_fuse_plain"), (T, "ffn_plain")):
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
    before = M.LAUNCHES[kernel]
    out = fn(*args)
    torch.cuda.synchronize()
    assert M.LAUNCHES[kernel] == before + 1
    return out


@pytest.mark.parametrize("shape", MST_SHAPES)
@pytest.mark.parametrize("cin,cout,k,residual", [(3, 31, 3, False), (31, 31, 3, False), (31, 31, 3, True),
                                                   (31, 62, 4, False), (62, 124, 4, False)])
def test_msab_conv_kernel(cuda, no_plain_on_cuda, shape, cin, cout, k, residual):
    rng = np.random.default_rng(cin + cout + k)
    x = _randn(rng, *shape, cin, scale=0.5)
    w = _randn(rng, k, k, cin, cout, scale=0.2)
    ho, wo = M.conv_out_hw(shape[1], shape[2], k)
    r = _randn(rng, shape[0], ho, wo, cout, scale=0.5) if residual else None
    got = _counted("conv_kernel", M.conv, x.to(cuda), w.to(cuda), None if r is None else r.to(cuda))
    want = no_plain_on_cuda["conv_plain"](x, w, r)
    assert got.shape == want.shape
    assert (got.cpu() - want).abs().max().item() <= 1e-4


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


@pytest.mark.parametrize("shape", MST_SHAPES)
@pytest.mark.parametrize("c", M.MSAB_CHANNELS)
def test_msab_apply_kernel(cuda, no_plain_on_cuda, shape, c):
    rng = np.random.default_rng(c + 1)
    x = _randn(rng, *shape, c, scale=0.5)
    blk = _msab_weights(rng, c)
    m = _randn(rng, shape[0], c, c, scale=0.2)
    got = _counted("msab_apply_kernel", M.msab_apply, x.to(cuda), m.to(cuda), _to(blk, cuda))
    want = no_plain_on_cuda["msab_apply_plain"](x, m, blk)
    assert (got.cpu() - want).abs().max().item() <= 5e-4


@pytest.mark.parametrize("shape", [(1, 4, 4), (2, 7, 11), (1, 17, 30)])
@pytest.mark.parametrize("c", [124, 62])
def test_up_fuse_kernel(cuda, no_plain_on_cuda, shape, c):
    """The bias's four (dy, dx) copies differ."""
    rng = np.random.default_rng(c + 2)
    n, h, w = shape
    fea = _randn(rng, n, h, w, c, scale=0.5)
    skip = _randn(rng, n, 2 * h, 2 * w, c // 2, scale=0.5)
    wup, bup = _randn(rng, c, 2, 2, c // 2, scale=0.2), _randn(rng, 2, 2, c // 2, scale=0.2)
    fuse = _randn(rng, c, c // 2, scale=0.2)
    got = _counted("up_fuse_kernel", M.up_fuse, *(t.to(cuda) for t in (fea, skip, wup, bup, fuse)))
    want = no_plain_on_cuda["up_fuse_plain"](fea, skip, wup, bup, fuse)
    assert (got.cpu() - want).abs().max().item() <= 1e-4


def test_mst_on_card_vs_cpu(cuda, no_plain_on_cuda):
    """The shipped model at 64x96 (and 37x53, padded to 40x56): kernels on
    the card against the plain versions on the CPU, < 5e-4, with the
    per-forward launch counts."""
    gpu, cpu = load_shipped(cuda), load_shipped("cpu")
    for shape in [(1, 64, 96, 3), (2, 37, 53, 3)]:
        x = torch.from_numpy(np.random.default_rng(7).random(shape, dtype=np.float32))
        M.reset_launches()
        with torch.no_grad():
            got = gpu(x.to(cuda))
            torch.cuda.synchronize()
            assert M.LAUNCHES == {"conv_kernel": 14, "attn_stats_kernel": 15, "msab_apply_kernel": 15,
                                  "up_fuse_kernel": 6}
            want = cpu(x)
        assert got.shape == want.shape == (*shape[:3], 31)
        assert (got.cpu() - want).abs().max().item() < 5e-4


@pytest.mark.parametrize("cls", [Kestrel, Goldfish])
def test_uv_species_with_mst_on_card_vs_cpu(cuda, no_plain_on_cuda, psnr_fn, cls):
    frame = _frames((1, 72, 130), "cpu", seed=8)[0].numpy()
    before = M.LAUNCHES["msab_apply_kernel"]
    _, out_g = attach_mst(cls(cuda), load_shipped(cuda)).visualize(frame)
    assert M.LAUNCHES["msab_apply_kernel"] == before + 15
    _, out_c = attach_mst(cls("cpu"), load_shipped("cpu")).visualize(frame)
    assert psnr_fn(out_g / 255.0, out_c / 255.0) >= 40.0


# --- MST-L's FFN kernel (ops/fused_mst.py) and the model ---


@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 9, 13), (1, 8, 16), (1, 17, 33), (2, 40, 67)])
@pytest.mark.parametrize("c", T.FFN_CHANNELS)
def test_ffn_kernel(cuda, no_plain_on_cuda, shape, c):
    rng = np.random.default_rng(c + 3)
    x = _randn(rng, *shape, c, scale=0.5)
    ws = (1.0 + _randn(rng, c, scale=0.2), _randn(rng, c, scale=0.2), _randn(rng, c, 4 * c, scale=0.2),
          _randn(rng, 3, 3, 4 * c, scale=0.2), _randn(rng, 4 * c, c, scale=0.2))
    before = T.LAUNCHES["ffn"]
    got = T.ffn(x.to(cuda), *(t.to(cuda) for t in ws))
    torch.cuda.synchronize()
    assert T.LAUNCHES["ffn"] == before + 1
    want = no_plain_on_cuda["ffn_plain"](x, *ws)
    assert got.shape == want.shape
    assert (got.cpu() - want).abs().max().item() <= 1e-4


def test_ffn_tile_raises_above_shared_memory(cuda):
    """This card takes the 8x16 tile up to C = 62 and 8x8 at C = 124; where
    no tile fits, the wrapper raises and names C and the tile."""
    limit = T.smem_limit(torch.cuda.current_device())
    assert [T.tile_for(c, limit) for c in T.FFN_CHANNELS] == [(8, 16), (8, 16), (8, 8)]
    with pytest.raises(ValueError, match="C = 124 .* 4x8 tile"):
        T.tile_for(124, 48 * 1024)


def test_mst_l_on_card_vs_cpu(cuda, no_plain_on_cuda):
    """MST-L with seeded weights at 40x67 (padded to 40x72): 27 FFN kernel
    launches per forward, within 5e-4 of max |y| of the CPU forward."""
    gpu = zoo.model_generator("mst", device=cuda)
    cpu = zoo.model_generator("mst", device="cpu")
    x = torch.from_numpy(np.random.default_rng(9).random((1, 40, 67, 3), dtype=np.float32))
    T.reset_launches()
    with torch.no_grad():
        got = gpu(x.to(cuda))
        torch.cuda.synchronize()
        assert T.LAUNCHES["ffn"] == 27
        want = cpu(x)
    assert got.shape == want.shape == (1, 40, 67, 31)
    assert (got.cpu() - want).abs().max().item() <= 5e-4 * max(1.0, want.abs().max().item())


@pytest.mark.parametrize("cls", [Kestrel, MantisShrimp])
def test_uv_species_with_mst_l_on_card_vs_cpu(cuda, no_plain_on_cuda, psnr_fn, cls):
    frame = _frames((1, 72, 130), "cpu", seed=10)[0].numpy()
    before = T.LAUNCHES["ffn"]
    _, out_g = attach_model(cls(cuda), "mst").visualize(frame)
    assert T.LAUNCHES["ffn"] == before + 27
    _, out_c = attach_model(cls("cpu"), "mst").visualize(frame)
    assert psnr_fn(out_g / 255.0, out_c / 255.0) >= 40.0
