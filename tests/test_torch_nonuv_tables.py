"""The table forms and the block partitions of the redesigned non-UV kernels,
emulated in numpy on the CPU.

``iso_kernel`` and ``streak_kernel`` (``csrc/fused_nonuv.cu``) decode a
uint8 input by a 256-entry table and encode by exact thresholds (T[k], the
least float32 at which the encode reaches code k, plus the floats where the
encode is not monotone, ``csrc/srgb.cuh``). On the card the table comes
from the card's own powf; here the same rule is built from the port's
``core/color.py:encode_output`` and held against it, and against the JAX
package's polynomial encode. Then the partitions: every output pixel is
written by exactly one block, the staged columns hold every source a
valid output reads, and the W-pass ring holds every row an H pass reads.
"""

import numpy as np
import pytest
import torch

from animal_vision_tpu.core import color as jcolor
from animal_vision_tpu.ops import fused_nonuv as jfused
from animal_vision_tpu_torch.core import color
from animal_vision_tpu_torch.ops import fused_nonuv as F

ONE_BITS = 0x3F800000
WINDOW = 4096  # ulps either side of each threshold searched for exceptions


def _encode(x: np.ndarray) -> np.ndarray:
    """``encode_output`` to uint8 on the CPU, each float through PyTorch's
    vectorised pow: the scalar tail of an array may round a float on the
    other side of a step (0x3f519d91 is 234 in a vector, 233 alone), so
    the array is padded to whole vectors."""
    x = np.asarray(x, np.float32).ravel()
    padded = np.zeros(-(-x.size // 256) * 256, np.float32)
    padded[:x.size] = x
    return color.encode_output(torch.from_numpy(padded), torch.uint8).numpy()[:x.size].astype(np.int64)


def _floats(bits: np.ndarray) -> np.ndarray:
    return bits.astype(np.uint32).view(np.float32)


@pytest.fixture(scope="module")
def table():
    """(T bits, exceptions {bits: code}) of ``encode_output``, as the card
    builds its table: T[k] by bisection over the bit patterns of [0, 1],
    then the floats where the threshold count differs from the encode (in
    windows around each T[k] here; the card scans all of [0, 1])."""
    k = np.arange(1, 256)
    lo, hi = np.zeros(255, np.int64), np.full(255, ONE_BITS, np.int64)
    while np.any(hi - lo > 1):
        mid = (lo + hi) // 2
        ge = _encode(_floats(mid)) >= k
        hi, lo = np.where(ge, mid, hi), np.where(ge, lo, mid)
    bits = (hi[:, None] + np.arange(-WINDOW, WINDOW + 1)[None, :]).ravel()
    bits = np.unique(bits[(bits >= 0) & (bits <= ONE_BITS)])
    x = _floats(bits)
    count = np.searchsorted(_floats(hi), x, side="right")
    enc = _encode(x)
    exc = {int(b): int(v) for b, v in zip(bits[count != enc], enc[count != enc])}
    return hi, exc


def _by_thresholds(x: np.ndarray, table) -> np.ndarray:
    """The kernels' encode: clamp (NaN to 0), count the thresholds at or
    below x, replace an exception."""
    hi, exc = table
    x = np.nan_to_num(np.clip(np.asarray(x, np.float32), 0.0, 1.0), nan=0.0)
    out = np.searchsorted(_floats(hi), x, side="right")
    bits = x.view(np.uint32)
    for b, v in exc.items():
        out[bits == b] = v
    return out


def _dense_bits() -> np.ndarray:
    return np.arange(0, ONE_BITS + 1, 97, dtype=np.int64)


def test_thresholds_increase_and_exceptions_are_few(table):
    hi, exc = table
    assert hi[0] > 0 and hi[-1] <= ONE_BITS and np.all(np.diff(hi) > 0)
    assert len(exc) <= 4
    # at most one exception per threshold count (the card's table has one slot each)
    counts = np.searchsorted(_floats(hi), _floats(np.array(sorted(exc), np.int64)), side="right")
    assert len(set(counts.tolist())) == len(exc)


def test_threshold_rule_exact_at_each_threshold(table):
    """At every T[k] and at the float just below it the rule gives the
    encode: the steps sit exactly there."""
    hi, _ = table
    bits = np.concatenate([hi, hi - 1])
    x = _floats(bits)
    np.testing.assert_array_equal(_by_thresholds(x, table), _encode(x))
    np.testing.assert_array_equal(_encode(_floats(hi)), np.arange(1, 256))
    assert np.all(_encode(_floats(hi - 1)) < np.arange(1, 256))


def test_threshold_rule_equals_encode_dense(table):
    """Equal on every 97th float32 in [0, 1] (about 11 M floats) and around
    each threshold, and clamped like the encode outside [0, 1]."""
    hi, _ = table
    x = _floats(_dense_bits())
    np.testing.assert_array_equal(_by_thresholds(x, table), _encode(x))
    near = _floats(np.clip((hi[:, None] + np.arange(-64, 65)[None, :]).ravel(), 0, ONE_BITS))
    np.testing.assert_array_equal(_by_thresholds(near, table), _encode(near))
    odd = np.array([-1.0, -0.0, -1e-30, 1.0, 1.0000001, 2.0, 1e30, np.inf, -np.inf, np.nan], np.float32)
    np.testing.assert_array_equal(_by_thresholds(odd, table), _encode(odd))


def test_threshold_rule_within_one_lsb_of_jax(table):
    """Within 1 LSB of the JAX package's polynomial encode (``_encode_u8``)."""
    x = _floats(_dense_bits()[::4])
    want = np.asarray(jfused._encode_u8(x)).astype(np.int64)
    assert np.abs(_by_thresholds(x, table) - want).max() <= 1


@pytest.mark.parametrize("scale", [1.0 / 255.0, 1.0])
def test_decode_table(scale):
    """The kernels' decode table, linearize(clip(v scale)) for v = 0..255,
    is the plain path's value for each byte bit for bit, and within 1e-6
    of the JAX ``srgb_to_linear``."""
    v = torch.arange(256, dtype=torch.float32)
    lut = color.srgb_to_linear(torch.clamp(v * np.float32(scale), 0.0, 1.0))
    frame = torch.arange(256, dtype=torch.uint8).reshape(1, 1, 256, 1).expand(1, 1, 256, 3).contiguous()
    plain = F._scaled_linear(frame, torch.tensor([scale], dtype=torch.float32))[0, 0, :, 0]
    assert torch.equal(lut, plain)
    want = np.asarray(jcolor.srgb_to_linear(np.clip(np.arange(256, dtype=np.float32) * np.float32(scale), 0, 1)))
    np.testing.assert_allclose(lut.numpy(), want, rtol=0, atol=1e-6)


def _reflect101(p: np.ndarray, n: int) -> np.ndarray:
    if n == 1:
        return np.zeros_like(p)
    period = 2 * (n - 1)
    m = np.mod(p, period)
    return np.where(m < n, m, period - m)


ISO_SHAPES = [(1, 1, 1), (3, 5, 3), (1, 37, 53), (2, 64, 96), (1, 15, 63), (1, 17, 65), (1, 129, 129),
              (1, 127, 1283), (3, 1080, 1920), (1, 721, 1283)]


@pytest.mark.parametrize("shape", ISO_SHAPES)
def test_iso_partition_covers_each_output_once(shape):
    """Blocks (strip of 64 columns, run of ``iso_run_rows`` rows, frame),
    each writing rows y0 + 8g + j of its run and its strip's columns: every
    output pixel exactly once, at the wrapper's run and at every run
    length."""
    n, h, w = shape
    for rows in sorted({F.iso_run_rows(n, h, w), *F.ISO_RUN_ROWS}):
        hits = np.zeros((n, h, w), np.int32)
        for y0 in range(0, h, rows):
            out_rows = min(rows, h - y0)
            for g in range(-(-out_rows // F.ISO_GROUP)):
                left = min(F.ISO_GROUP, out_rows - F.ISO_GROUP * g)
                for x0 in range(0, w, F.ISO_TILE_W):
                    cols = min(F.ISO_TILE_W, w - x0)
                    hits[:, y0 + F.ISO_GROUP * g:y0 + F.ISO_GROUP * g + left, x0:x0 + cols] += 1
        assert hits.min() == 1 and hits.max() == 1, (shape, rows)


@pytest.mark.parametrize("ksize", list(range(1, F.ISO_MAX_TAPS + 1, 2)))
def test_iso_staged_columns_and_ring(ksize):
    """Every source column of a valid output lies in the block's staged
    range [max(0, x0 - r), min(w, x0 - r + 64 + kp)) and its clamped column
    table; and with the H pass of group g at step g + lag + 1, every
    W-pass row it reads was written in an earlier step and is still in the
    ring of 8 (lag + 2) rows."""
    r, kp = ksize // 2, (ksize + 3) & ~3
    span = F.ISO_TILE_W + kp
    for w in (1, 2, 3, 5, 27, 63, 64, 65, 129, 1283, 1920):
        x = np.arange(w)
        for x0 in range(0, w, F.ISO_TILE_W):
            lo, hi = max(0, x0 - r), min(w, x0 - r + span)
            col = np.clip(_reflect101(x0 - r + np.arange(span), w), lo, hi - 1)
            valid = x[(x >= x0) & (x < x0 + F.ISO_TILE_W)]
            for t in range(ksize):
                lx = valid - x0 + t  # span column of tap t
                assert lx.max() < span
                np.testing.assert_array_equal(col[lx], _reflect101(valid - r + t, w))
    lag = (kp + 6) // F.ISO_GROUP
    ring = lag + 2  # groups
    for groups in (1, 2, 5, 16):
        written = {}
        for s in range(groups + lag + 1):
            g = s - lag - 1
            if g >= 0:
                last_row = F.ISO_GROUP * g + F.ISO_GROUP - 1 + kp - 1
                for q in range(g, last_row // F.ISO_GROUP + 1):
                    assert written.get(q % ring) == q and q < s
            if s < groups + lag:
                written[s % ring] = s


def test_iso_sizes_and_raise():
    limit = 232448  # an H100 block's dynamic shared memory
    for elem in (1, 4):
        assert F.iso_smem_bytes(F.ISO_MAX_TAPS, elem) <= limit
    assert F.iso_check_ksize(29, 1, limit) == F.iso_smem_bytes(29, 1)
    for bad in (F.ISO_MAX_TAPS + 2, 4):
        with pytest.raises(ValueError, match=f"ksize {bad}"):
            F.iso_check_ksize(bad, 1, limit)
    with pytest.raises(ValueError, match="ksize 29"):
        F.iso_check_ksize(29, 1, 1000)
    assert F.iso_run_rows(3, 1080, 1920) == 128 and F.iso_run_rows(1, 8, 8) == F.ISO_RUN_ROWS[-1]


@pytest.mark.parametrize("n,h", [(1, 1), (3, 5), (1, 37), (2, 64), (3, 1080), (1, 721), (4, 1080)])
@pytest.mark.parametrize("slots", [1, 7, 132, 396, 528])
def test_streak_partition_covers_each_row_once(n, h, slots):
    """``streak_blocks`` blocks, block b of B taking rows n h b // B ..
    n h (b + 1) // B - 1 of the batch: every image row once, every block
    at least one row, and the blocks' shares within one row of each other."""
    total = n * h
    blocks = F.streak_blocks(n, h, slots)
    assert 1 <= blocks <= min(slots, total)
    hits = np.zeros(total, np.int32)
    sizes = []
    for b in range(blocks):
        g0, g1 = total * b // blocks, total * (b + 1) // blocks
        hits[g0:g1] += 1
        sizes.append(g1 - g0)
    assert hits.min() == 1 and hits.max() == 1
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("w", [1, 2, 3, 8, 9, 10, 63, 64, 65, 129, 1283, 1920])
@pytest.mark.parametrize("r", [0, 5, 15, 16, 40])
def test_streak_row_decode_and_units(w, r):
    """A streak row at any of the 16 offsets within 16 bytes: the 4-byte
    words cover each byte once, the whole-word path's floats are 16-byte
    aligned, the halo's sources are reflect101; threads of 9 pixels cover
    each pixel once and read no further than the float row holds."""
    nbytes = 3 * w
    fcount = 3 * (w + 2 * r + 9 - 1) + 4
    for shift in range(16):
        pad = (shift - 3 * r) & 3
        seen = np.zeros(nbytes, np.int32)
        for q in range((shift + nbytes + 3) // 4):
            j0 = 4 * q - shift
            if 0 <= j0 and j0 + 4 <= nbytes:
                assert (pad + 3 * r + j0) % 4 == 0
            for j in range(j0, j0 + 4):
                if 0 <= j < nbytes:
                    seen[j] += 1
        assert seen.min() == 1 and seen.max() == 1
    if r > 0:
        src = _reflect101(np.concatenate([np.arange(-r, 0), np.arange(w, w + r)]), w)
        assert src.min() >= 0 and src.max() < w
    units = np.zeros(w, np.int32)
    for u in range(-(-w // 9)):
        units[9 * u:min(9 * u + 9, w)] += 1
        last = 9 * u + 8 + r  # the furthest pixel a thread's window reads
        assert 3 * (last + r) + 2 + 3 < fcount
    assert units.min() == 1 and units.max() == 1


def _fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 fma(a, b, c) through float64: the product is exact there, so
    only a sum that lands on a float32 tie after its float64 rounding can
    round otherwise than the card's single rounding."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def _pointwise_emulated(frames: np.ndarray, scale: np.ndarray, mat9: np.ndarray, gain, table) -> np.ndarray:
    """``pointwise_kernel``'s chain in numpy: the frame's decode table, each
    output channel as fma(m2, l2, fma(m1, l1, m0 l0)) (``mix_row``), blue
    times its row's gain clipped to [0, 1], the threshold encode."""
    m = np.asarray(mat9, np.float32).reshape(9)
    out = np.empty(frames.shape, np.int64)
    for f, (frame, s) in enumerate(zip(frames, scale)):
        v = torch.arange(256, dtype=torch.float32)
        lut = color.srgb_to_linear(torch.clamp(v * np.float32(s), 0.0, 1.0)).numpy()
        lin = lut[frame]
        l0, l1, l2 = lin[..., 0], lin[..., 1], lin[..., 2]
        o = [_fma(m[3 * c + 2], l2, _fma(m[3 * c + 1], l1, (m[3 * c] * l0).astype(np.float32))) for c in range(3)]
        if gain is not None:
            o[2] = np.clip(o[2] * np.asarray(gain, np.float32).reshape(-1, 1), 0.0, 1.0).astype(np.float32)
        out[f] = _by_thresholds(np.stack(o, axis=-1), table)
    return out


@pytest.mark.parametrize("name", ["pig", "rat"])
@pytest.mark.parametrize("shape,seed", [((2, 37, 53), 1), ((3, 16, 17), 2), ((2, 5, 7), 3), ((1, 1, 1), 4)])
def test_pointwise_chain_emulated(table, name, shape, seed):
    """The kernel's chain (table decode, the spelled-out matrix order, gain,
    threshold encode) within 1 LSB of ``pointwise_u8_plain`` and of the JAX
    ``fused_pointwise_u8`` (Pallas in interpret mode), frame by frame; the
    last frame holds 0/1 values (the scale = 1 branch)."""
    from animal_vision_tpu.species.nonuv import NONUV_SPECS

    spec = NONUV_SPECS[name]
    scone = spec.effects[0].params if name == "rat" else None
    n, h, w = shape
    x = np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    x[-1] &= 1
    frames = torch.from_numpy(x)
    scale = F.scale_of(frames)
    mat9 = color.collapse_lms_matrix(spec.alpha, spec.s_scale).reshape(9).astype(np.float32)
    gain = None if scone is None else F.scone_gain(h, scone)
    got = _pointwise_emulated(x, scale.numpy(), mat9, gain, table)
    plain = F.pointwise_u8_plain(frames, scale, torch.from_numpy(mat9),
                                 None if gain is None else torch.from_numpy(gain)).numpy()
    assert np.abs(got - plain).max() <= 1
    for f in range(n):
        want = np.asarray(jfused.fused_pointwise_u8(x[f], spec.alpha, spec.s_scale, scone=scone)).astype(np.int64)
        assert np.abs(got[f] - want).max() <= 1
