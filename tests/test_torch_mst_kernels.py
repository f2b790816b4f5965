"""Each MST++ kernel's plain version (``ops/fused_msab.py``) against the JAX
package's Pallas function in interpret mode, on the CPU.

Inputs of scale 0.5 and weights of scale 0.2 from
``np.random.default_rng(seed)``, as ``tests/test_models_mst.py`` uses; the
JAX outputs are unpacked from (H, W/P, P*C) with the reshapes of that file.
Bar: <= 1e-4 max abs (both sides float32; the sums run in other orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal_vision_tpu.models.mst_plus_plus import MSAB as JMSAB
from animal_vision_tpu.ops import fused_msab as J
from animal_vision_tpu_torch.ops import fused_msab as M

TOL = 1e-4


def _r(rng, *shape, scale=0.2):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _packed(x, p):
    h, w, c = x.shape
    return jnp.asarray(x.reshape(h, w // p, p * c))


def _fold_stats(g_p, sq_p, sk_p, c, heads):
    """The packed stats of the JAX producers folded to (heads, 31, 31)
    Gram blocks and (C,) norms, as ``_attn_blockdiag`` folds them."""
    g_p, sq_p, sk_p = np.asarray(g_p), np.asarray(sq_p).reshape(-1), np.asarray(sk_p).reshape(-1)
    p = g_p.shape[0] // c
    g = sum(g_p[i * c:(i + 1) * c, i * c:(i + 1) * c] for i in range(p))
    d = c // heads
    blocks = np.stack([g[i * d:(i + 1) * d, i * d:(i + 1) * d] for i in range(heads)])
    return blocks, sq_p.reshape(p, c).sum(0), sk_p.reshape(p, c).sum(0)


def test_conv3x3_io_3_to_31():
    rng = np.random.default_rng(1)
    h, w = 12, 16
    x, wt = _r(rng, h, w, 3, scale=0.5), _r(rng, 3, 3, 3, 31)
    want = np.asarray(J.packed_conv3x3_io(_packed(x, 4), jnp.asarray(wt), 3, 31, 4)).reshape(h, w, 31)
    got = M.conv_plain(_t(x)[None], _t(wt))[0].numpy()
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("extra", ["none", "residual", "stats"])
def test_conv3x3_31(extra):
    rng = np.random.default_rng(2)
    h, w, c, p = 11, 16, 31, 4
    x, wt, res = _r(rng, h, w, c, scale=0.5), _r(rng, 3, 3, c, c), _r(rng, h, w, c, scale=0.5)
    wq, wk = _r(rng, c, c), _r(rng, c, c)
    if extra == "residual":
        want = J.packed_conv3x3(_packed(x, p), jnp.asarray(wt), c, p, residual=_packed(res, p))
        got = M.conv_plain(_t(x)[None], _t(wt), _t(res)[None])
    elif extra == "stats":
        stats_w = J.attn_stats_weights({"to_q": jnp.asarray(wq), "to_k": jnp.asarray(wk)}, c, p)
        want, *stats = J.packed_conv3x3(_packed(x, p), jnp.asarray(wt), c, p, stats_w=stats_w)
        got = M.conv_plain(_t(x)[None], _t(wt))
        for a, b in zip(M.attn_stats_plain(got, _t(wq), _t(wk), 1), _fold_stats(*stats, c, 1)):
            assert np.abs(a[0].numpy() - b).max() <= TOL * max(1.0, np.abs(b).max())
    else:
        want = J.packed_conv3x3(_packed(x, p), jnp.asarray(wt), c, p)
        got = M.conv_plain(_t(x)[None], _t(wt))
    assert np.abs(got[0].numpy() - np.asarray(want).reshape(h, w, c)).max() <= TOL


@pytest.mark.parametrize("c", [31, 62])
def test_down4x4(c):
    rng = np.random.default_rng(3 + c)
    p = J._pack_of(c)
    h, w = 10, 4 * p
    x, wt = _r(rng, h, w, c, scale=0.5), _r(rng, 4, 4, c, 2 * c)
    want = np.asarray(J.packed_down4x4(_packed(x, p), jnp.asarray(wt), c, p)).reshape(h // 2, w // 2, 2 * c)
    got = M.conv_plain(_t(x)[None], _t(wt))[0].numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL


def _up_case(c):
    """A decoder level whose up-conv bias's four (dy, dx) copies differ, and
    the JAX ``packed_up_fuse`` output for it."""
    rng = np.random.default_rng(4 + c)
    p, half = J._pack_of(c), c // 2
    h, w = 3, 4 * p
    fea, skip = _r(rng, h, w, c, scale=0.5), _r(rng, 2 * h, 2 * w, half, scale=0.5)
    wup, bup, fuse = _r(rng, c, 2, 2, half), _r(rng, 2, 2, half), _r(rng, c, half)
    assert np.abs(bup - bup.mean(axis=(0, 1))).max() > 0.01
    want = J.packed_up_fuse(_packed(fea, p), _packed(skip, 2 * p), jnp.asarray(wup.reshape(1, 1, c, 4 * half)),
                            jnp.asarray(bup.reshape(-1)), jnp.asarray(fuse.reshape(1, 1, c, half)), c, p)
    uw = M.up_fuse_weights(_t(wup), _t(bup), _t(fuse))
    return _t(fea)[None], _t(skip)[None], uw, np.asarray(want).reshape(2 * h, 2 * w, half)


@pytest.mark.parametrize("c", [124, 62])
def test_up_fuse(c):
    """``up_fuse_plain`` (two products from the raw weights of
    ``UpFuseWeights``) against the JAX ``packed_up_fuse``."""
    fea, skip, uw, want = _up_case(c)
    got = M.up_fuse_plain(fea, skip, uw)[0].numpy()
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("c", [124, 62])
def test_up_fuse_composed(c):
    """The kernel's composed product, [fea | skip] [wc[dy, dx] ; wskip] +
    bc[dy, dx] per output parity, in plain PyTorch against the JAX
    ``packed_up_fuse`` (which folds the same way)."""
    fea, skip, uw, want = _up_case(c)
    _, h, w, _ = fea.shape
    got = torch.empty(2 * h, 2 * w, c // 2)
    for dy in range(2):
        for dx in range(2):
            a = torch.cat([fea[0], skip[0, dy::2, dx::2]], dim=-1)
            got[dy::2, dx::2] = a @ torch.cat([uw.wc[dy, dx], uw.wskip]) + uw.bc[dy, dx]
    assert np.abs(got.numpy() - want).max() <= TOL


def _msab_case(c, seed):
    rng = np.random.default_rng(seed)
    heads = c // 31
    attn = {"to_q": _r(rng, c, c), "to_k": _r(rng, c, c), "to_v": _r(rng, c, c), "proj_kernel": _r(rng, c, c),
            "proj_bias": _r(rng, c), "rescale": rng.uniform(0.5, 1.5, (heads, 1, 1)).astype(np.float32),
            "pos_emb_0": _r(rng, 3, 3, 1, c), "pos_emb_2": _r(rng, 3, 3, 1, c)}
    ln = (1.0 + _r(rng, c), _r(rng, c))
    ffn = (_r(rng, 1, 1, c, 4 * c), _r(rng, 3, 3, 1, 4 * c), _r(rng, 1, 1, 4 * c, c))
    blk = M.MsabWeights(heads, _t(attn["to_q"]), _t(attn["to_k"]), _t(attn["to_v"]), _t(attn["rescale"].reshape(-1)),
                        _t(attn["proj_kernel"]), _t(attn["proj_bias"]), _t(attn["pos_emb_0"][:, :, 0]),
                        _t(attn["pos_emb_2"][:, :, 0]), _t(ln[0]), _t(ln[1]), _t(ffn[0][0, 0]),
                        _t(ffn[1][:, :, 0]), _t(ffn[2][0, 0]))
    return rng, attn, ln, ffn, blk


def _port_msab(x, blk):
    g, sq, sk = M.attn_stats_plain(x, blk.wq, blk.wk, blk.heads)
    return M.msab_apply_plain(x, M.attn_matrix(g, sq, sk, blk.rescale, blk.wv, blk.wproj), blk)


@pytest.mark.parametrize("c", M.MSAB_CHANNELS)
def test_msab_packed(c):
    """Stats, glue and apply against ``msab_packed`` at 5 rows and a width
    of 7 pixels. The JAX side pads W with zero columns to a multiple of P
    (4, 2, 1 pixels at C = 31, 62, 124), so the port runs the same padded
    frame; at C = 124 nothing is padded and the odd width goes through as
    it is."""
    rng, attn, ln, ffn, blk = _msab_case(c, 10 + c)
    p, h, w = J._pack_of(c), 5, 7
    x = _r(rng, h, w, c, scale=0.5)
    wp = -(-w // p) * p
    xpad = np.pad(x, ((0, 0), (0, wp - w), (0, 0)))
    want = np.asarray(J.msab_packed(_packed(xpad, p), attn, ln, ffn, heads=c // 31, c=c, p=p)).reshape(h, wp, c)
    got = _port_msab(_t(xpad)[None], blk)[0].numpy()
    assert np.abs(got - want).max() <= TOL
    if wp == w:
        assert np.abs(_port_msab(_t(x)[None], blk)[0].numpy() - want).max() <= TOL


def test_msab_odd_width_vs_xla_module():
    """At an odd width with zero padding at every edge (each depthwise 3x3
    pads its own input), the port equals the JAX module's XLA MSAB."""
    c = 62
    rng, attn, ln, ffn, blk = _msab_case(c, 7)
    x = _r(rng, 2, 5, 7, c, scale=0.5)
    params = {"attn_0": {"to_q": {"kernel": attn["to_q"]}, "to_k": {"kernel": attn["to_k"]},
                         "to_v": {"kernel": attn["to_v"]}, "rescale": attn["rescale"],
                         "proj": {"kernel": attn["proj_kernel"], "bias": attn["proj_bias"]},
                         "pos_emb_0": {"kernel": attn["pos_emb_0"]}, "pos_emb_2": {"kernel": attn["pos_emb_2"]}},
              "norm_0": {"scale": ln[0], "bias": ln[1]},
              "ff_0": {"net_0": {"kernel": ffn[0]}, "net_2": {"kernel": ffn[1]}, "net_4": {"kernel": ffn[2]}}}
    with jax.default_matmul_precision("float32"):
        want = np.asarray(JMSAB(c, 31, c // 31, 1).apply({"params": params}, jnp.asarray(x)))
    assert np.abs(_port_msab(_t(x), blk).numpy() - want).max() <= TOL
