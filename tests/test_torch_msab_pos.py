"""MSAB pass B split in two: ``msab_pos_plain`` (``ops/fused_msab.py``)
against the JAX package's XLA ``MSMSA(x) + x``, and ``msab_apply_plain`` as
``ffn_plain`` of it, on the CPU.

Inputs of scale 0.5 and weights of scale 0.2 from
``np.random.default_rng(seed)``; frames of an odd width, so every depthwise
3x3 zero-pads its own input at each edge. Bar: <= 1e-4 max abs (both sides
float32, products at full float32 precision; the sums run in other
orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal_vision_tpu.models.mst_plus_plus import MSMSA
from animal_vision_tpu_torch.ops import fused_msab as M
from animal_vision_tpu_torch.ops import fused_mst

TOL = 1e-4


def _r(rng, *shape, scale=0.2):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _case(c, seed):
    """JAX ``MSMSA`` parameters and the port's ``MsabWeights`` (with an FFN)
    for the same random weights."""
    rng = np.random.default_rng(seed)
    heads = c // 31
    p = {"to_q": {"kernel": _r(rng, c, c)}, "to_k": {"kernel": _r(rng, c, c)}, "to_v": {"kernel": _r(rng, c, c)},
         "rescale": rng.uniform(0.5, 1.5, (heads, 1, 1)).astype(np.float32),
         "proj": {"kernel": _r(rng, c, c), "bias": _r(rng, c)},
         "pos_emb_0": {"kernel": _r(rng, 3, 3, 1, c)}, "pos_emb_2": {"kernel": _r(rng, 3, 3, 1, c)}}
    blk = M.MsabWeights(heads, _t(p["to_q"]["kernel"]), _t(p["to_k"]["kernel"]), _t(p["to_v"]["kernel"]),
                        _t(p["rescale"].reshape(-1)), _t(p["proj"]["kernel"]), _t(p["proj"]["bias"]),
                        _t(p["pos_emb_0"]["kernel"][:, :, 0]), _t(p["pos_emb_2"]["kernel"][:, :, 0]),
                        _t(1.0 + _r(rng, c)), _t(_r(rng, c)), _t(_r(rng, c, 4 * c)), _t(_r(rng, 3, 3, 4 * c)),
                        _t(_r(rng, 4 * c, c)))
    return rng, p, blk


def _attn(x, blk):
    g, sq, sk = M.attn_stats_plain(x, blk.wq, blk.wk, blk.heads)
    return M.attn_matrix(g, sq, sk, blk.rescale, blk.wv, blk.wproj)


@pytest.mark.parametrize("c", M.MSAB_CHANNELS)
def test_msab_pos_plain_vs_xla_msmsa(c):
    """res1 = MSMSA(x) + x: the attention product, the projection bias and
    the pos branch, at 2 frames of 6 x 7 pixels."""
    rng, params, blk = _case(c, 20 + c)
    x = _r(rng, 2, 6, 7, c, scale=0.5)
    with jax.default_matmul_precision("float32"):
        want = np.asarray(MSMSA(c, 31, c // 31).apply({"params": params}, jnp.asarray(x))) + x
    xt = _t(x)
    got = M.msab_pos_plain(xt, _attn(xt, blk), blk).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("c", M.MSAB_CHANNELS)
def test_msab_apply_plain_is_ffn_of_pos(c):
    """Pass B's plain version is ``ffn_plain`` of ``msab_pos_plain``, bit for
    bit: the card's two kernels compute the same two functions."""
    rng, _, blk = _case(c, 30 + c)
    x = _t(_r(rng, 1, 5, 9, c, scale=0.5))
    m = _attn(x, blk)
    want = fused_mst.ffn_plain(M.msab_pos_plain(x, m, blk), blk.ln_w, blk.ln_b, blk.w0, blk.dw, blk.w4)
    assert torch.equal(M.msab_apply_plain(x, m, blk), want)


def test_pos_tiles_fit_two_blocks_per_sm():
    """The pos kernel's tile at each C: two blocks fit the 115,712 bytes an
    H100 SM gives two blocks (228 KB less 1 KB reserved per block); a
    smaller limit raises and names C and the tile."""
    limit = 233472 - 2 * 1024
    assert [M.pos_tile_for(c, limit) for c in M.MSAB_CHANNELS] == [(8, 16), (8, 8), (4, 8)]
    assert [M.pos_smem_bytes(c, M.POS_TILES[c]) for c in M.MSAB_CHANNELS] == [106240, 95488, 114688]
    with pytest.raises(ValueError, match="C = 124 .* 4x8 tile"):
        M.pos_tile_for(124, 200 * 1024)


def test_stats_blocks_depend_on_pixels_only():
    """The stats kernel's first-stage blocks per frame and head: one per
    64-pixel tile up to 1024, so a 1080p frame has 1024 of them."""
    assert M.stats_blocks(1) == 1
    assert M.stats_blocks(64 * 5 + 1) == 6
    assert M.stats_blocks(1080 * 1920) == M.STATS_BLOCKS == 1024
    assert [M.stats_smem_bytes(c) for c in M.MSAB_CHANNELS] == [46080, 71680, 79872]
