"""Work of one call of honeybee with MST++: the least time the card could
take, and MST++'s product FLOPs.

MST++'s FLOPs are counted from the published widths (n_feat 31, 3 stages
of 2 levels; 31, 62, 124 channels) at the frame padded to multiples of 8:
the matrix products and dense convolutions of the forward, two FLOPs per
multiply-add, as the plain composition states them (per MSAB: q, k, the
full C x C Gram, the value map, the folded attention map, the FFN's two
1x1 maps; the per-frame fold M = Wv A Wproj). This is the count that
``torch.utils.flop_counter`` reads from the port's plain forward
once its weight layouts are made (``tests/test_portbench_work.py`` holds
them equal; a model's first forward also counts the one-time composition
of its up-fuse weights, 12,985,032 FLOPs). The other operations
(depthwise taps, GELUs, LayerNorms, residual adds, the render) are counted
as float32 work outside the tensor cores; bytes are the frames read once
and the outputs written once, plus the weights.
"""

from __future__ import annotations

from portbench import peaks

N_FEAT = 31
STAGES = 3
LEVELS = 2
WEIGHT_BYTES = 4 * 1_620_462  # the float32 parameters of the published model, read once per call


def _msab_products(hw: int, c: int) -> int:
    per_px = 26 * c * c  # q, k, Gram, x Wv, x M: 2 C^2 each; FFN: 2 x 8 C^2
    return hw * per_px + 4 * c**3  # + the fold Wv A Wproj, once per frame


def _msab_other(hw: int, c: int) -> int:
    # two depthwise 3x3 on C, one on 4C (2 FLOPs per tap), three GELUs,
    # a LayerNorm (about 8 per element), residual adds
    return hw * (2 * 18 * c + 18 * 4 * c + (c + c + 4 * c + 4 * c) + 8 * c + 3 * c)


def mstpp_flops(h: int, w: int) -> dict:
    """``{"products": ..., "other": ...}`` FLOPs of one MST++ forward of an
    (h, w) frame."""
    hp, wp = -(-h // 8) * 8, -(-w // 8) * 8
    hw0 = hp * wp
    conv3 = 9 * 2 * hw0 * N_FEAT * N_FEAT
    prod = 9 * 2 * hw0 * 3 * N_FEAT + conv3  # conv_in, conv_out
    other = 0
    for _ in range(STAGES):
        prod += 2 * conv3  # embedding, mapping
        c, hw = N_FEAT, hw0
        for _ in range(LEVELS):
            prod += _msab_products(hw, c)
            other += _msab_other(hw, c)
            prod += 16 * 2 * (hw // 4) * c * 2 * c  # 4x4 stride-2 down, C -> 2C
            c, hw = 2 * c, hw // 4
        prod += _msab_products(hw, c)
        other += _msab_other(hw, c)
        for _ in range(LEVELS):
            prod += 4 * hw * c * c + 4 * hw * c * c  # up to (dy, dx, C/2), then the 1x1 fuse at 4 hw
            c, hw = c // 2, hw * 4
            prod += _msab_products(hw, c)
            other += _msab_other(hw, c)
    return {"products": prod, "other": other}


def per_call(species: str, n: int, h: int, w: int, config: dict) -> dict:
    """The least time of one call on ``n`` (h, w) uint8 frames and the MST++
    FLOPs it runs."""
    f = mstpp_flops(h, w)
    px = n * h * w
    products = n * f["products"] + px * 2 * 31 * 3  # the cone catches contract the cube
    # render: / 255, clip, cube clip, white patch, 3 x 2 x 3 blur taps,
    # the opponent map (about 40), sRGB encode (about 20) per pixel
    other = n * f["other"] + px * (4 + 31 + 6 + 36 + 40 + 20)
    nbytes = px * 3 * 2 + WEIGHT_BYTES
    least = max(nbytes / peaks.HBM_BYTES_PER_S, products / peaks.TF32_FLOPS, other / peaks.F32_FLOPS)
    return {"least_s": least, "mstpp_flops": n * f["products"]}
