"""The partition of the redesigned ``pointwise_kernel`` (``csrc/fused_nonuv.cu``),
emulated in numpy on the CPU.

The kernel runs ``pointwise_blocks`` blocks per frame (grid: blocks per
frame, N). A thread's unit is 16 pixels, 48 bytes, moved as three 16-byte
vectors; units start at the frame's first byte offset that is a multiple of
3 and lies on 16 bytes. The head before it and the tail after the last
whole unit go byte by byte in the frame's block 0, one pixel per thread.
The rat's gain row comes from one division per unit: at W >= 16 a unit
crosses at most one row boundary (two gains), narrower frames count rows
pixel by pixel. These tests hold that partition to: every byte of the batch
exactly once, every vector on 16 bytes, every pixel in its own frame and
row, and the block count within the card's slots.
"""

import numpy as np
import pytest

from animal_vision_tpu_torch.ops import fused_nonuv as F

T = F.POINTWISE_THREADS
PIX = F.POINTWISE_PIX
SLOTS = (1, 7, 132, 528, 1056, 2112)


def _partition(addr: int, npx: int) -> tuple[int, int, int]:
    """(head, units, tail) of a frame whose bytes start at ``addr``, as the
    kernel computes them: head = the least p with addr + 3p on 16 bytes
    ((16 - addr % 16) 11 mod 16, since 3 11 = 1 mod 16), or the whole frame."""
    head = min(((16 - addr % 16) * 11) % 16, npx)
    units = (npx - head) // PIX
    return head, units, npx - head - units * PIX


def _units_of_blocks(blocks: int, units: int) -> np.ndarray:
    """The units the grid-stride loop visits: thread t of block b takes u =
    b T + t, then u + B T, ... while u < units."""
    u = np.arange(blocks * T)
    visits = [u + k * blocks * T for k in range(-(-units // (blocks * T)))]
    visits = np.concatenate(visits) if visits else np.zeros(0, np.int64)
    return visits[visits < units]


def _unit_rows(q0: np.ndarray, w: int) -> np.ndarray:
    """(units, 16) rows of each unit's pixels as the kernel takes them."""
    r0 = q0 // w
    i = np.arange(PIX)[None, :]
    if w >= PIX:
        split = (r0 + 1) * w - q0  # pixels i >= split lie in row r0 + 1
        assert split.min(initial=1) >= 1
        return r0[:, None] + (i >= split[:, None])
    row, col = r0.copy(), q0 - r0 * w
    rows = np.empty((q0.size, PIX), np.int64)
    for k in range(PIX):
        wrap = col == w
        col = np.where(wrap, 0, col) + 1
        row = row + wrap
        rows[:, k] = row
    return rows


@pytest.mark.parametrize("addr", range(16))
def test_head_is_least_aligned_pixel(addr):
    """The head formula gives the least pixel whose byte offset lies on 16
    bytes, at most 15 pixels (the offset lies within 48 bytes)."""
    for npx in (1, 5, 15, 16, 17, 100):
        head, units, tail = _partition(addr, npx)
        aligned = [p for p in range(16) if (addr + 3 * p) % 16 == 0]
        assert aligned and head == min(aligned[0], npx) <= 15
        assert 3 * aligned[0] < 48 and 0 <= tail < PIX and head + PIX * units + tail == npx
        assert head + tail <= T  # block 0 takes them one pixel per thread


@pytest.mark.parametrize("slots", SLOTS)
def test_pointwise_blocks(slots):
    """At least one block per frame; the frames share the slots; no block
    beyond those a frame's units fill; one wave at 1080p."""
    for n in range(1, 6):
        for npx in (1, 7, 15, 16, 17, 48, 4096, 721 * 1283, 1080 * 1920):
            b = F.pointwise_blocks(n, npx, slots)
            assert 1 <= b <= max(1, slots // n)
            assert b == 1 or (b - 1) * T * PIX < npx
            if slots >= n and npx >= slots * T * PIX:
                assert b == slots // n
    assert F.pointwise_blocks(4, 1080 * 1920, 1056) == 264


@pytest.mark.parametrize("h", [1, 3, 1080])
@pytest.mark.parametrize("w", [1, 7, 15, 16, 17, 1283, 1920])
def test_partition_covers_each_byte_once(h, w):
    """Batches of N = 1..5 frames starting at several offsets within 16
    bytes (frame n at base + n H W 3, so frames of an odd byte count start
    anywhere): every byte written once, head and tail byte by byte, every
    unit's three vectors on 16 bytes and inside its own frame, each unit
    visited once by the grid at the wrapper's block count, and each pixel's
    gain row its own."""
    npx = h * w
    fbytes = 3 * npx
    for n in range(1, 6):
        slots = 1056 if h < 1080 else 528
        blocks = F.pointwise_blocks(n, npx, slots)
        for base in (0, 1, 7, 13):
            diff = np.zeros(base + n * fbytes + 1, np.int32)
            for f in range(n):
                start = base + f * fbytes
                head, units, tail = _partition(start, npx)
                # the edge pixels of block 0's first head + tail threads
                edge = np.concatenate([np.arange(head), npx - tail + np.arange(tail)])
                assert edge.size <= T
                np.add.at(diff, start + 3 * edge, 1)
                np.add.at(diff, start + 3 * edge + 3, -1)
                u = _units_of_blocks(blocks, units)
                assert np.array_equal(np.sort(u), np.arange(units))
                vec = start + 3 * head + 48 * u
                assert np.all(vec % 16 == 0)
                assert vec.size == 0 or (vec.min() >= start and vec.max() + 48 <= start + fbytes)
                np.add.at(diff, vec, 1)
                np.add.at(diff, vec + 48, -1)
                q0 = head + PIX * np.sort(u)
                if q0.size:
                    rows = _unit_rows(q0, w)
                    assert np.array_equal(rows, (q0[:, None] + np.arange(PIX)[None, :]) // w)
                    assert rows.max() < h
            cover = np.cumsum(diff)[:-1]
            assert np.all(cover[:base] == 0) and np.all(cover[base:] == 1), (n, base)


@pytest.mark.parametrize("in_base,out_base", [(0, 0), (1, 1), (5, 0), (0, 3), (9, 25)])
def test_store_path_follows_both_offsets(in_base, out_base):
    """Units store 16-byte vectors where the output's offset within 16 bytes
    equals the input's (then every store lies on 16 bytes), else byte by
    byte; the same choice holds for every frame of the batch."""
    for w, h, n in ((1283, 3, 3), (17, 5, 4), (16, 1, 2)):
        fbytes = 3 * h * w
        vec_out = {(in_base + f * fbytes) % 16 == (out_base + f * fbytes) % 16 for f in range(n)}
        assert len(vec_out) == 1
        if vec_out.pop():
            for f in range(n):
                head, units, _ = _partition(in_base + f * fbytes, h * w)
                assert np.all((out_base + f * fbytes + 3 * head + 48 * np.arange(units)) % 16 == 0)
