"""Work of one call of mantis shrimp with MST-L: the least time the card could
take, MST-L's product FLOPs, and the masked pos kernel's least time.

MST-L's FLOPs are counted from the published widths (dim 31, 2 stages of
2 levels; 31, 62, 124 channels; 4, 7 and 5 blocks) at the quarter-scale
frame padded to multiples of 8 (272 x 480 for a 1080p frame), two FLOPs
per multiply-add, as the plain composition states them: the two
embeddings; per block the mask branch's two 1x1 maps and its depthwise
5x5, q, k, the full C x C Gram, x Wv, the gated product (V * gate) M',
the FFN's two 1x1 maps, and the per-frame M' = A Wproj; the feature and
mask down-convolutions, the up-convolution and the fuse, the mapping. The
gated product is the 2 C^2 per pixel that MST++'s fold (x M with
M = Wv A Wproj) does not spend: x Wv is one product there, two here. This
is the count that ``torch.utils.flop_counter`` reads from the port's plain
forward (``tests/test_torch_mantis_mstl.py`` holds them equal). The other
operations (the pos and FFN depthwise taps, GELUs, LayerNorms, the gate's
sigmoid, residual adds, the resizes and the render) are counted as
float32 work outside the tensor cores; bytes are the frames read once and
the outputs written once, plus the weights.

The masked pos kernel (``msab_pos_masked_kernel<C>``, one launch per
block: 8 at 31 channels, 14 at 62 and 5 at 124 per forward) reads x
and the gate and writes its output (12 C bytes per pixel, the output's
second pass through L2 not counted), and does 2 C^2 (x Wv) + 2 C^2 (the
gated product) multiply-adds in 3xTF32 and 2 x 18 C taps of its two
depthwise 3x3s per pixel; its least time is the larger of bytes at
3.35 TB/s, three TF32 passes at 495 TFLOP/s and the taps at 67 TFLOP/s,
one entry per C (``msab_masked_least_s.<C>``).
"""

from __future__ import annotations

from portbench import peaks

DIM = 31
STAGE = 2
NUM_BLOCKS = (4, 7, 5)
WEIGHT_BYTES = 4 * 2_451_257  # the float32 parameters of the published model, read once per forward


def _block_products(hw: int, c: int) -> int:
    # mask branch 1x1 x 2 and dw 5x5; q, k, Gram; x Wv, (V gate) M'; FFN 2 x 8 C^2
    return hw * (4 * c * c + 50 * c + 6 * c * c + 4 * c * c + 16 * c * c) + 2 * c**3  # + M' = A Wproj


def _block_other(hw: int, c: int) -> int:
    # pos: two depthwise 3x3 on C; FFN: one on 4C (2 FLOPs per tap); GELUs
    # (C, 4C, 4C); LayerNorm (about 8 per element); the gate's sigmoid,
    # product and sum (about 6); residual adds
    return hw * (2 * 18 * c + 18 * 4 * c + (c + 4 * c + 4 * c) + 8 * c + 6 * c + 3 * c)


def levels(h: int, w: int) -> list[tuple[int, int, int]]:
    """(pixels, C, blocks) of each MSAB level of one forward, in order."""
    hw = (-(-h // 8) * 8) * (-(-w // 8) * 8)
    out = []
    for i in range(STAGE):
        out.append((hw >> (2 * i), DIM << i, NUM_BLOCKS[i]))
    out.append((hw >> (2 * STAGE), DIM << STAGE, NUM_BLOCKS[-1]))
    for i in range(STAGE):
        j = STAGE - 1 - i
        out.append((hw >> (2 * j), DIM << j, NUM_BLOCKS[j]))
    return out


def mstl_flops(h: int, w: int) -> dict:
    """``{"products": ..., "other": ...}`` FLOPs of one MST-L forward of an
    (h, w) frame."""
    hw0 = (-(-h // 8) * 8) * (-(-w // 8) * 8)
    prod = 2 * (2 * 9 * 3 * DIM * hw0) + 2 * 9 * DIM * DIM * hw0  # two embeddings, the mapping
    other = 0
    for hw, c, blocks in levels(h, w):
        prod += blocks * _block_products(hw, c)
        other += blocks * _block_other(hw, c)
    hw, c = hw0, DIM
    for _ in range(STAGE):
        prod += 2 * (16 * 2 * (hw // 4) * c * 2 * c)  # features and mask, 4x4 stride 2, C -> 2C
        c, hw = 2 * c, hw // 4
    for _ in range(STAGE):
        prod += 4 * hw * c * c + 4 * hw * c * c  # the 2x2 stride-2 up-convolution, then the 1x1 fuse at 4 hw
        c, hw = c // 2, hw * 4
    return {"products": prod, "other": other}


def masked_least_s(h: int, w: int) -> dict:
    """``{C: s}``: the masked pos kernel's least time over one forward's
    launches at each C."""
    out: dict[int, float] = {}
    for hw, c, blocks in levels(h, w):
        nbytes = 12 * c * hw
        products = 3 * 4 * c * c * hw
        taps = 2 * 18 * c * hw
        least = max(nbytes / peaks.HBM_BYTES_PER_S, products / peaks.TF32_FLOPS, taps / peaks.F32_FLOPS)
        out[c] = out.get(c, 0.0) + blocks * least
    return out


def per_call(species: str, n: int, h: int, w: int, config: dict) -> dict:
    """The least time of one call on ``n`` (h, w) uint8 frames, the MST-L
    FLOPs it runs and the masked kernel's least time by C."""
    ms = config["mantis_shrimp"]
    sh, sw = max(1, int(round(h * ms["hsi_scale"]))), max(1, int(round(w * ms["hsi_scale"])))
    f = mstl_flops(sh, sw)
    px, small = n * h * w, n * sh * sw
    bands = len(ms["bands"])
    products = n * f["products"] + small * 2 * 31 * bands  # the band weights contract the cube
    # the panorama's 4 cubic taps (8 per value), the area-down and the
    # linear-up of 10 maps, the render (about 200 per pixel: min-max,
    # percentile, barcode, three UV blurs, Sobel, the gains), sRGB both ways
    other = n * f["other"] + px * (3 * 8 + 3 * 2 + bands * 8 + 200 + 40)
    nbytes = px * 3 * 2 * 2 + n * WEIGHT_BYTES  # frame in, baseline and output out; weights per forward
    least = max(nbytes / peaks.HBM_BYTES_PER_S, products / peaks.TF32_FLOPS, other / peaks.F32_FLOPS)
    out = {"least_s": least, "mstl_flops": n * f["products"]}
    for c, s in masked_least_s(sh, sw).items():
        out[f"msab_masked_least_s.{c}"] = n * s
    return out
