"""The arithmetic of the port's tensor-core kernels, emulated in numpy.

``conv_kernel``, ``attn_stats_kernel``, ``msab_pos_kernel`` and
``up_fuse_kernel`` (``csrc/fused_msab.cu``) and ``ffn_kernel``
(``csrc/fused_mst.cu``) run
their float32 products as 3xTF32 on
``mma.sync.m16n8k8`` (``csrc/mma_tf32.cuh``): each operand is split as
hi = rna(x), lo = rna(x - hi), where rna rounds to TF32 (10 mantissa bits)
to nearest with ties away from zero; each 8-deep step accumulates lo*hi',
then hi*lo', then hi*hi' into a float32 partial sum, and each slice of the
inner dimension (one tap's 32 channels for the convolution, one hidden
chunk for the FFN's down product) is added into the float32 result apart.

Here a tensor-core step is emulated as exact products summed with the
partial sum and rounded once to float32. At the convolution's inner
dimensions (27, 279, 496, 992) and the FFN's (C and 4C for C = 31, 62,
124), with the card tests' data scales, 3xTF32 stays within their 1e-4 of
a float64 product, and one TF32 pass does not at 992: the reason for the
three passes. The stats kernel's Gram (31 x 31 per head, the pixels as
the inner dimension) is emulated with its tiles, blocks and fixed-order
reduction at 2^16 + 29 pixels, within 1e-5 of max |G|. The up-fuse's
composed product (inner dimensions 93 and 186) stays within 1e-4 in
3xTF32, and one TF32 pass does not at 186."""

import numpy as np
import pytest
import torch

from animal_vision_tpu_torch.ops import fused_msab, fused_mst

TOL = 1e-4  # the card tests' bar for conv and ffn against their plain versions
ROWS, COLS = 64, 32  # output pixels and channels per emulated product


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 on finite float32: add half an ulp of the 10-bit
    mantissa to the magnitude, clear the 13 low bits."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    hi = tf32_rna(x)
    return hi, tf32_rna(x.astype(np.float32) - hi)


def mma(d: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One tensor-core step: d + a b with exact products, rounded once."""
    return (d.astype(np.float64) + a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)


def kernel_product(a: np.ndarray, b: np.ndarray, slice_len: int, passes: int = 3) -> np.ndarray:
    """(M, K) x (K, N) as the kernels compute it: slices of ``slice_len``
    (each zero-padded to a multiple of 8), 8-deep steps, 3xTF32 (or one
    TF32 pass, hi*hi' only), each slice's partial sum added in float32."""
    m, k = a.shape
    acc = np.zeros((m, b.shape[1]), np.float32)
    for s0 in range(0, k, slice_len):
        part = np.zeros_like(acc)
        for k0 in range(s0, min(s0 + slice_len, k), 8):
            k1 = min(k0 + 8, s0 + slice_len, k)
            ahi, alo = split(a[:, k0:k1])
            bhi, blo = split(b[k0:k1])
            if passes == 3:
                part = mma(part, alo, bhi)
                part = mma(part, ahi, blo)
            part = mma(part, ahi, bhi)
        acc = acc + part
    return acc


def _error(a, b, slice_len, passes=3) -> float:
    want = a.astype(np.float64) @ b.astype(np.float64)
    return float(np.abs(kernel_product(a, b, slice_len, passes) - want).max())


def _conv_operands(k: int, cin: int):
    """im2col rows of inputs of scale 0.5 and a (K*K*Cin, Cout) weight of
    scale 0.2, as the card tests draw them."""
    rng = np.random.default_rng(k * 100 + cin)
    a = (rng.standard_normal((ROWS, k * k * cin)) * 0.5).astype(np.float32)
    b = (rng.standard_normal((k * k * cin, COLS)) * 0.2).astype(np.float32)
    return a, b


# (K, Cin, slice): conv_in flattens its 27 (tap, channel) pairs into one
# slice; the others take one tap's channels per slice
CONV_CASES = [(3, 3, 27), (3, 31, 31), (4, 31, 31), (4, 62, 31)]


def test_rna_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32 spacing at 1
    x = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - np.float32(2.0 ** -23), one + ulp * 1.5,
                  np.float32(3.0e-3), np.float32(-7.25)], np.float32)
    got = tf32_rna(x)
    want = np.array([one + ulp, -(one + ulp), one, one + ulp * 2], np.float32)
    assert np.array_equal(got[:4], want)
    assert np.array_equal(got[5:], x[5:])  # already exact in TF32
    assert np.all(tf32_rna(got) == got)
    assert np.all(got.view(np.uint32) & np.uint32(0x1FFF) == 0)


def test_split_keeps_about_21_bits():
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 10
    hi, lo = split(x)
    assert np.all(np.abs(lo) <= np.abs(x) * 2.0 ** -11)
    resid = np.abs(x.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64))
    assert np.all(resid <= np.abs(x.astype(np.float64)) * 2.0 ** -21)


@pytest.mark.parametrize("k,cin,slice_len", CONV_CASES)
def test_conv_3xtf32_within_the_card_bar(k, cin, slice_len):
    a, b = _conv_operands(k, cin)
    assert a.shape[1] in (27, 279, 496, 992)
    assert _error(a, b, slice_len) <= TOL


def test_conv_one_tf32_pass_misses_the_bar_at_992():
    a, b = _conv_operands(4, 62)
    assert a.shape[1] == 992
    one_pass = _error(a, b, 31, passes=1)
    assert one_pass > TOL
    assert _error(a, b, 31) < one_pass / 20


def _ffn_operands(c: int):
    """LN(x) rows (scale 1) by W0 (C, 4C) of scale 0.2, and hidden rows
    (GELU outputs, scale 0.5 and non-negative-leaning) by W4 (4C, C), as
    ``tests/test_torch_kernels_gpu.py:test_ffn_kernel`` draws the weights."""
    rng = np.random.default_rng(c)
    y = rng.standard_normal((ROWS, c)).astype(np.float32)
    w0 = (rng.standard_normal((c, 4 * c)) * 0.2).astype(np.float32)
    hid = np.abs(rng.standard_normal((ROWS, 4 * c)) * 0.5).astype(np.float32)
    w4 = (rng.standard_normal((4 * c, c)) * 0.2).astype(np.float32)
    return y, w0, hid, w4


@pytest.mark.parametrize("c", fused_mst.FFN_CHANNELS)
def test_ffn_up_product_3xtf32_within_the_card_bar(c):
    y, w0, _, _ = _ffn_operands(c)
    assert _error(y, w0, c) <= TOL  # one slice: K = C


@pytest.mark.parametrize("c", fused_mst.FFN_CHANNELS)
def test_ffn_down_product_3xtf32_within_the_card_bar(c):
    _, _, hid, w4 = _ffn_operands(c)
    assert _error(hid, w4, fused_mst.hidden_chunk(c)) <= TOL  # K = 4C in hidden chunks


# --- MSAB pass A (attn_stats_kernel) and the first half of pass B (msab_pos_kernel) ---


def stats_gram(k: np.ndarray, q: np.ndarray, tile: int, nblk: int) -> np.ndarray:
    """G = k^T q (one head, (npix, 31) each) as ``attn_stats_kernel`` and
    ``stats_reduce_kernel`` sum it: block b takes pixel tiles b, b + nblk,
    ...; per tile each 32-pixel slice is summed apart (8-deep 3xTF32 steps)
    into the block's float32 sum; then warp w of the reduction adds blocks
    w, w + 8, ... in order, and the eight warp sums are added in order."""
    npix = k.shape[0]
    ntiles = -(-npix // tile)
    pad = ((0, ntiles * tile - npix), (0, 32 - k.shape[1]))
    kt = np.pad(k, pad).reshape(ntiles, tile, 32)
    qt = np.pad(q, pad).reshape(ntiles, tile, 32)
    acc = np.zeros((nblk, 32, 32), np.float32)
    for first in range(0, ntiles, nblk):
        idx = np.arange(first, min(first + nblk, ntiles))
        for p0 in range(0, tile, 32):
            part = np.zeros((len(idx), 32, 32), np.float32)
            for kk in range(p0, p0 + 32, 8):
                ahi, alo = split(kt[idx, kk:kk + 8].transpose(0, 2, 1))
                bhi, blo = split(qt[idx, kk:kk + 8])
                part = mma(part, alo, bhi)
                part = mma(part, ahi, blo)
                part = mma(part, ahi, bhi)
            acc[idx - first] = acc[idx - first] + part
    sums = [np.zeros((32, 32), np.float32) for _ in range(8)]
    for b in range(nblk):
        sums[b % 8] = sums[b % 8] + acc[b]
    out = sums[0]
    for s in sums[1:]:
        out = out + s
    return out[:31, :31]


@pytest.mark.parametrize("c", fused_msab.MSAB_CHANNELS)
def test_attn_stats_gram_3xtf32_within_the_card_bar(c):
    """A frame of 2^16 + 29 pixels (every block of the kernel's 1024 takes
    a tile or two), the last head's q and k in 3xTF32 from x, then the
    Gram's 3xTF32 sum: within the card tests' 1e-5 of max |G| of the
    float64 product."""
    rng = np.random.default_rng(100 + c)
    npix = 2 ** 16 + 29
    x = (rng.standard_normal((npix, c)) * 0.5).astype(np.float32)
    cols = slice(c - 31, c)
    wq = (rng.standard_normal((c, c)) * 0.2).astype(np.float32)[:, cols]
    wk = (rng.standard_normal((c, c)) * 0.2).astype(np.float32)[:, cols]
    q, k = kernel_product(x, wq, 32), kernel_product(x, wk, 32)
    x64 = x.astype(np.float64)
    want = (x64 @ wk.astype(np.float64)).T @ (x64 @ wq.astype(np.float64))
    nblk = fused_msab.stats_blocks(npix)
    assert nblk == 1024
    got = stats_gram(k, q, fused_msab.stats_tile(c), nblk)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("c", fused_msab.MSAB_CHANNELS)
@pytest.mark.parametrize("which", ["wv", "m"])
def test_pos_products_3xtf32_within_the_card_bar(c, which):
    """x Wv over the tile's halo and x M over the tile: K = C in 32-deep
    slices, inputs of scale 0.5 and weights of scale 0.2, within 1e-4."""
    rng = np.random.default_rng(c + (0 if which == "wv" else 1))
    x = (rng.standard_normal((ROWS, c)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((c, 32)) * 0.2).astype(np.float32)
    assert _error(x, w, 32) <= TOL


# --- the decoder's up-fuse (up_fuse_kernel): one composed product per parity ---


def _up_fuse_operands(c: int):
    """fea and skip rows of scale 0.5, and wc[dy, dx] and wskip composed by
    ``up_fuse_weights`` from raw weights of scale 0.2, as the card tests
    draw them."""
    rng = np.random.default_rng(200 + c)
    half = c // 2
    raw = [(rng.standard_normal(s) * 0.2).astype(np.float32) for s in ((c, 2, 2, half), (2, 2, half), (c, half))]
    uw = fused_msab.up_fuse_weights(*(torch.from_numpy(t) for t in raw))
    fea = (rng.standard_normal((ROWS, c)) * 0.5).astype(np.float32)
    skip = (rng.standard_normal((ROWS, half)) * 0.5).astype(np.float32)
    return fea, skip, uw.wc[1, 0].numpy(), uw.wskip.numpy()


def _up_fuse_error(c: int, passes: int = 3) -> float:
    """The composed product as ``up_fuse_kernel`` sums it: fea by wc in
    slices of ``UP_FEA_SLICE`` rows, then skip by wskip in slices of 32,
    each slice added into the float32 result apart; against float64."""
    fea, skip, wc, wskip = _up_fuse_operands(c)
    got = kernel_product(fea, wc, fused_msab.UP_FEA_SLICE[c], passes)
    for s0 in range(0, skip.shape[1], 32):
        got = got + kernel_product(skip[:, s0:s0 + 32], wskip[s0:s0 + 32], 32, passes)
    want = fea.astype(np.float64) @ wc.astype(np.float64) + skip.astype(np.float64) @ wskip.astype(np.float64)
    return float(np.abs(got - want).max())


@pytest.mark.parametrize("c", [62, 124])
def test_up_fuse_3xtf32_within_the_card_bar(c):
    """Inner dimensions 93 and 186 (C + C/2): within the card tests' 1e-4
    of the float64 product."""
    assert c + c // 2 in (93, 186)
    assert _up_fuse_error(c) <= TOL


def test_up_fuse_one_tf32_pass_misses_the_bar():
    one_pass = _up_fuse_error(124, passes=1)
    assert one_pass > TOL
    assert _up_fuse_error(124) < one_pass / 20
