"""MST++ on row bands with halo recompute, on the kernels.

Counterpart of ``animal_vision_tpu/parallel/fused_shard.py``. Each rank of
the spatial axis (sp x tp folded into one, ``spatial_mesh``) owns
``Hp / spx`` rows of the frame padded to multiples of 8 and runs the
whole model on them:

- **Halo recompute.** Before each MST stage a rank gathers ``MARGIN`` = 48
  rows on each side from the ranks that own them (``comm.HaloPlan``: each
  rank sends each other rank the rows of its band inside that rank's
  extended range, so a band shorter than the margin takes rows from
  several owners), runs the stage on the extended band, and keeps its own
  rows. One stage reaches about 41 rows (3x3 embedding and mapping, 3
  rows per MSAB at each level, the stride-2 levels doubling them), so
  every owned row is exact. conv_in and conv_out take a 4-row halo.
- **Bands are cropped at the global edges.** A band extended by m rows
  covers rows ``[max(0, s - m), min(Hp, s + hl + m))``. At a global edge
  the kernels' own zero padding is then the global zero padding, which
  the TPU kernels get from a ``bounds`` operand instead; so the CUDA
  kernels take no bounds. Extended starts stay multiples of 4, so both
  stride-2 levels line up with the frame's.
- **Attention statistics over owned rows.** MSAB pass A's sums (the
  head-diagonal Gram and the norms, ``ops/fused_msab.attn_stats``) are
  taken over the rows the band owns and summed over the spatial group
  before ``attn_matrix``: the global statistics, up to summation order.

``band_forward`` is the band variant of ``MSTPlusPlus.forward``: it runs
the model's own ``_stage`` with the band's statistics (and FFN) hooks, on
the kernels for inference, or (``plain=True``) the plain versions on live
parameters, through which gradients flow, halo and statistics included.
With a ``TpSplit`` each FFN runs its share of the hidden channels between
Megatron's *f* and *g* (training); inference folds tp into the bands
instead.

``fused_sharded_forward`` takes the whole frame on every rank, splits the
batch over dp, runs this rank's band and returns the whole output on every
rank (one all-gather).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F

from animal_vision_tpu_torch.core import linalg
from animal_vision_tpu_torch.models.mst_plus_plus import _reflect_index, _stage
from animal_vision_tpu_torch.ops import fused_msab as K
from animal_vision_tpu_torch.parallel import comm
from animal_vision_tpu_torch.parallel.mesh import tp_slice

#: rows of halo recompute per stage exchange; one MST stage reaches ~41
#: rows, 48 keeps every extended start 4-row aligned
MARGIN = 48
#: rows of halo around conv_in and conv_out (reach 1 row, kept 4-aligned)
CONV_HALO = 4


def spatial_mesh(mesh_or_dims) -> tuple[int, int]:
    """The (dp, spx) grid of the band path for a ``Mesh`` or a (dp, sp, tp)
    tuple: sp x tp fused into one spatial axis in the same rank order (the
    JAX ``spatial_mesh``)."""
    if isinstance(mesh_or_dims, tuple):
        dp, sp, tp = mesh_or_dims
    else:
        dp, sp, tp = mesh_or_dims.dp, mesh_or_dims.sp, mesh_or_dims.tp
    return dp, sp * tp


def padded(n: int) -> int:
    """``n`` rounded up to a multiple of 8 (the model's reflect pad)."""
    return n + (8 - n % 8) % 8


def supports(mesh_or_dims, batch: int, h: int, w: int) -> bool:
    """Whether a (B, H, W) frame takes the band path: H padded to a
    multiple of 8 splits into 4-row-aligned bands over sp x tp, and B over
    dp (the JAX rule)."""
    dp, spx = spatial_mesh(mesh_or_dims)
    hp = padded(h)
    if batch % dp:
        return False
    return hp % spx == 0 and (hp // spx) % 4 == 0


@dataclass(frozen=True)
class Bands:
    """``n`` equal bands of ``hp`` rows, ``j`` this rank's, over the
    spatial group ``group`` (global ranks ``ranks`` in band order; None
    when ``n`` is 1)."""

    hp: int
    n: int
    j: int
    group: object
    ranks: tuple

    @property
    def own(self) -> tuple[int, int]:
        return self.rows(self.j)

    def rows(self, q: int) -> tuple[int, int]:
        hl = self.hp // self.n
        return q * hl, (q + 1) * hl

    def extended(self, q: int, m: int) -> tuple[int, int]:
        s, e = self.rows(q)
        return max(0, s - m), min(self.hp, e + m)

    def plan(self, m: int) -> comm.HaloPlan:
        return comm.HaloPlan([self.rows(q) for q in range(self.n)], [self.extended(q, m) for q in range(self.n)],
                             list(self.ranks), self.j)


@dataclass(frozen=True)
class TpSplit:
    """This rank's share ``t`` of ``size`` of each FFN's hidden channels,
    and the tp group the partial outputs are summed over."""

    group: object
    t: int
    size: int


def make_bands(hp: int, n: int, j: int, group) -> Bands:
    if hp % n or (hp // n) % 4:
        raise ValueError(f"{hp} rows do not split into {n} bands of a multiple of 4 rows")
    ranks = tuple(dist.get_process_group_ranks(group)) if n > 1 else ()
    return Bands(hp, n, j, group if n > 1 else None, ranks)


def pad_frames(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) reflect-padded to multiples of 8, as
    ``MSTPlusPlus.forward`` pads."""
    h, w = int(x.shape[1]), int(x.shape[2])
    hp, wp = padded(h), padded(w)
    if (hp, wp) != (h, w):
        x = x.index_select(1, _reflect_index(h, hp, x.device)).index_select(2, _reflect_index(w, wp, x.device))
    return x


def ffn_tp(x: torch.Tensor, blk: K.MsabWeights, tp: TpSplit) -> torch.Tensor:
    """``fused_mst.ffn_plain`` with the hidden channels split over tp:
    LN, then *f*, this rank's share of W0, GELU, the depthwise 3x3 and
    GELU, its share of W4, then *g* (the sum of the shares), plus the
    residual once."""
    sl = tp_slice(int(blk.w0.shape[1]), tp.size, tp.t)
    y = comm.copy_to_tp(F.layer_norm(x, (x.shape[-1],), blk.ln_w, blk.ln_b, eps=1e-5), tp.group)
    hid = F.gelu(K._dw3(F.gelu(linalg.frame_matmul(y, blk.w0[:, sl])), blk.dw[..., sl]))
    return comm.reduce_from_tp(linalg.frame_matmul(hid, blk.w4[sl]), tp.group) + x


def _band_stats(plain: bool, own, group):
    """``mst_plus_plus._stage``'s ``stats`` for a band whose own rows at
    level 0 are ``own``: pass A's sums over the own rows at each level,
    summed over ``group``."""
    base = K.attn_stats_plain if plain else K.attn_stats

    def at(level: int):
        lo, hi = own[0] >> level, own[1] >> level

        def stats(x, wq, wk, heads):
            g, sq, sk = base(x[:, lo:hi], wq, wk, heads)
            if group is None:
                return g, sq, sk
            n, c = sq.shape
            flat = comm.all_reduce_sum(torch.cat([g.reshape(n, -1), sq, sk], dim=1), group)
            return flat[:, :-2 * c].reshape(g.shape), flat[:, -2 * c:-c], flat[:, -c:]

        return stats

    return at


def band_forward(layouts: dict, xpad: torch.Tensor, bands: Bands, plain: bool = False,
                 tp: TpSplit | None = None) -> torch.Tensor:
    """MST++ on this rank's band: ``xpad`` (N, Hp, Wp, 3), the whole padded
    frames, and ``layouts`` (``MSTPlusPlus.weights`` or, to train, its live
    layouts) -> the output's own rows (N, Hp / n, Wp, 31), before the crop.
    The kernels, or with ``plain`` the plain versions (differentiable)."""
    if tp is not None and not plain:
        raise ValueError("a tp-split FFN runs the plain versions (the FFN kernel takes the whole hidden)")
    conv = K.conv_plain if plain else K.conv
    s, e = bands.own
    lo, hi = bands.extended(bands.j, CONV_HALO)
    feat = conv(xpad[:, lo:hi].contiguous(), layouts["conv_in"])[:, s - lo:e - lo]
    halo_m, halo_c = bands.plan(MARGIN), bands.plan(CONV_HALO)
    ffn = None if tp is None else (lambda y, blk: ffn_tp(y, blk, tp))
    body = feat
    for st in layouts["stages"]:
        lo = bands.extended(bands.j, MARGIN)[0]
        ext = comm.halo(body, halo_m) if bands.group is not None else body
        stats = _band_stats(plain, (s - lo, e - lo), bands.group)
        body = _stage(ext.contiguous(), st, plain, stats, ffn)[:, s - lo:e - lo]
    lo = bands.extended(bands.j, CONV_HALO)[0]
    ext = comm.halo(body, halo_c) if bands.group is not None else body
    return conv(ext.contiguous(), layouts["conv_out"])[:, s - lo:e - lo] + feat


def fused_sharded_forward(mesh, model, x: torch.Tensor) -> torch.Tensor:
    """The whole MST++ forward on the mesh's bands, with the kernels on the
    card: ``x`` (B, H, W, 3) float32, the same on every rank, on the
    model's device -> (B, H, W, 31) on every rank. The caller checks
    ``supports(mesh, B, H, W)``; raises otherwise."""
    b, h, w = (int(v) for v in x.shape[:3])
    if not supports(mesh, b, h, w):
        raise ValueError(f"a ({b}, {h}, {w}) frame does not split into the bands of {mesh.shape}")
    dp, spx = spatial_mesh(mesh)
    d, j = mesh.coords[0], mesh.spx_index
    bl = b // dp
    with torch.no_grad():
        xpad = pad_frames(x[d * bl:(d + 1) * bl].to(torch.float32))
        bands = make_bands(int(xpad.shape[1]), spx, j, mesh.groups["spx"])
        out = band_forward(model.weights(x.device), xpad, bands).contiguous()
        blocks = comm.all_gather(out, None)
    full = torch.cat([torch.cat(blocks[dd * spx:(dd + 1) * spx], dim=1) for dd in range(dp)], dim=0)
    return full[:, :h, :w]
