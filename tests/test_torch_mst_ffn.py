"""MST-L's FFN (``ops/fused_mst.py``): the plain version against the JAX
package's Pallas ``fused_msab_ffn`` in interpret mode and against its XLA
``FeedForward``, on the CPU.

out = x + (LN -> 1x1 C->4C -> GELU -> depthwise 3x3 -> GELU -> 1x1 4C->C)
of x. Inputs of scale 1, LN scales around 1 and weights of
scale 0.2 at C = 31 from ``np.random.default_rng``, as
``tests/test_models_mst.py`` makes them; at C = 62 and 124 the two 1x1
weights shrink by sqrt(31 / C), as a 1/sqrt(fan in) initialisation does, so
that every level's output has the size of C = 31's. A batch of 2 at an even
and an odd shape, at each MST-L level. Bar: <= 2e-5 max abs, that file's
bar for the Pallas FFN."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal_vision_tpu.models.mst_plus_plus import FeedForward
from animal_vision_tpu.ops.fused_mst import fused_msab_ffn
from animal_vision_tpu_torch.ops import _build
from animal_vision_tpu_torch.ops import fused_mst as K

TOL = 2e-5
SHAPES = [(2, 16, 24), (2, 9, 13)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(c, shape):
    rng = np.random.default_rng(c + sum(shape))
    hidden = 4 * c
    scale = 0.2 * np.sqrt(31 / c)
    return (
        rng.normal(0, 1, (*shape, c)).astype(np.float32),
        rng.normal(1, 0.2, (c,)).astype(np.float32),
        rng.normal(0, 0.2, (c,)).astype(np.float32),
        rng.normal(0, scale, (c, hidden)).astype(np.float32),
        rng.normal(0, 0.3, (3, 3, hidden)).astype(np.float32),
        rng.normal(0, scale, (hidden, c)).astype(np.float32),
    )


def _port(args):
    return K.ffn_plain(*(torch.from_numpy(a) for a in args)).numpy()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("c", K.FFN_CHANNELS)
def test_ffn_plain_vs_pallas_interpret(c, shape):
    args = _inputs(c, shape)
    want = np.asarray(fused_msab_ffn(*(jnp.asarray(a) for a in args), h=shape[1], w=shape[2]))
    assert np.abs(_port(args) - want).max() <= TOL


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("c", K.FFN_CHANNELS)
def test_ffn_plain_vs_xla_feedforward(c, shape):
    """The XLA path zero-pads the hidden map at every edge, as the kernel
    does, so odd widths agree too."""
    x, g, b, w0, dw, w4 = args = _inputs(c, shape)
    params = {"net_0": {"kernel": w0[None, None]}, "net_2": {"kernel": dw[:, :, None, :]},
              "net_4": {"kernel": w4[None, None]}}
    want = np.asarray(jax.jit(FeedForward(c).apply)({"params": params}, x, g, b))
    assert np.abs(_port(args) - want).max() <= TOL


def test_ffn_on_cpu_takes_the_plain_version():
    """On the CPU the wrapper is the plain version, bit for bit, and counts
    no launch."""
    args = [torch.from_numpy(a) for a in _inputs(31, (1, 5, 7))]
    _build.reset_launches()
    assert torch.equal(K.ffn(*args), K.ffn_plain(*args))
    assert _build.LAUNCHES["ffn"] == 0


def test_ffn_checks_its_operands():
    x, g, b, w0, dw, w4 = (torch.from_numpy(a) for a in _inputs(31, (1, 4, 4)))
    with pytest.raises(ValueError, match="C in"):
        K.ffn(torch.zeros(1, 4, 4, 30), g, b, w0, dw, w4)
    with pytest.raises(ValueError, match="w0"):
        K.ffn(x, g, b, w0.t(), dw, w4)


H100_SMEM_FOR_TWO = 231_424  # an H100 SM's 233,472 bytes less two 1 KB block reservations


@pytest.mark.parametrize("c,tile,nbytes", [(31, (8, 16), 89_536), (62, (8, 16), 92_864), (124, (8, 8), 100_288)])
def test_tile_for(c, tile, nbytes):
    """The tile built for each C, its shared memory (``Ffn::SMEM_FLOATS``
    of ``csrc/fused_mst.cu``), two blocks of which fit an H100 SM."""
    assert K.tile_for(c, H100_SMEM_FOR_TWO) == tile
    assert K.smem_bytes(c, tile) == nbytes
    assert 2 * nbytes <= H100_SMEM_FOR_TWO


@pytest.mark.parametrize("c", K.FFN_CHANNELS)
def test_tile_for_raises_where_two_blocks_do_not_fit(c):
    th, tw = K.TILES[c]
    with pytest.raises(ValueError, match=f"C = {c} .* {th}x{tw} tile"):
        K.tile_for(c, 2 * K.smem_bytes(c, (th, tw)) - 4)


@pytest.mark.parametrize("line,opcode", [
    ("        /*0000*/                   MOV R1, c[0x0][0x28] ;            /* 0x00000a0000017a02 */", "MOV"),
    ("        /*3d10*/               @P0 HMMA.1688.F32.TF32 R44, R40, R36, RZ ;  /* 0x00000024282c023c */",
     "HMMA.1688.F32.TF32"),
    ("        /*49e0*/              @!P5 FADD R49, -R49, 1 ;", "FADD"),
    ("        /*16e0*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;", "BAR.SYNC.DEFER_BLOCKING"),
])
def test_sass_opcode(line, opcode):
    """``chip_smoke.py`` reads each SASS line's opcode past its predicate."""
    import chip_smoke

    assert chip_smoke.SASS_OPCODE.search(line).group(1) == opcode


@pytest.mark.parametrize("ops,steps", [
    (["LDS", "HMMA", "LOP3", "HMMA", "FFMA"], [{"instructions": 3, "hmma": 2}]),
    (["HMMA", "BAR.SYNC", "LDS", "HMMA", "IADD3", "HMMA", "MUFU.EX2"],
     [{"instructions": 1, "hmma": 1}, {"instructions": 3, "hmma": 2}]),
    (["LDS", "BAR.SYNC", "FFMA"], []),
])
def test_product_steps(ops, steps):
    """A product's static steps: from its first HMMA to its last between two
    barriers, in code order; regions without HMMA are no product."""
    import chip_smoke

    assert chip_smoke.product_steps(ops) == steps
