"""Transport between ranks: collectives, the halo exchange, Megatron's f and g.

No JAX counterpart: XLA inserts the JAX package's collectives (``psum``,
``ppermute``) and GSPMD its halos. Here each is a call on a
``torch.distributed`` process group.

Backend (``choose_backend``): NCCL only when every rank has a card of its
own; otherwise gloo. Gloo moves host tensors, so under gloo a CUDA tensor
goes to a pinned host buffer, through the exchange, and back to the card
(``_wire``/``_back``): the device-to-host copy waits for the work queued
before it. Under NCCL tensors move on the device. A failed or timed-out
collective raises; nothing falls back.

``TRAFFIC`` counts, per kind of call (``"p2p"``: halo rows and pipeline
activations; ``"all_reduce"``, ``"all_gather"``, ``"broadcast"``), in this
process since ``reset_traffic``: the calls, the bytes of this rank's
tensors handed to them (what a point-to-point call sends), and the host
milliseconds spent in them: under gloo the staging copies, the exchange
and the wait for peers (queued device work is drained before the clock
starts, so it is not counted); under NCCL the host time to enqueue.

The autograd functions make the band forward trainable: ``halo`` (the
gradient of a halo row goes back to the rank that owns the row and is
added into it), ``all_reduce_sum`` (sum forward, sum backward), and
Megatron's pair for a tensor-parallel FFN: ``copy_to_tp`` (*f*: identity
forward, all-reduce backward, at the FFN's input) and ``reduce_from_tp``
(*g*: all-reduce forward, identity backward, at its output). With *f* and
*g*, the replicated parameters get the same gradient on every tp rank;
an all-reduce alone in both directions would scale them by the tp size.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

KINDS = ("p2p", "all_reduce", "all_gather", "broadcast")
TRAFFIC = {k: {"bytes": 0, "calls": 0, "ms": 0.0} for k in KINDS}


def reset_traffic() -> None:
    for counts in TRAFFIC.values():
        counts.update(bytes=0, calls=0, ms=0.0)


def choose_backend(world: int, device: str | torch.device) -> str:
    """``"nccl"`` when ``device`` is CUDA and the host has a card for each
    of the ``world`` ranks, else ``"gloo"`` (on a host with one card, every
    rank shares it, which NCCL refuses)."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= world and dist.is_nccl_available():
        return "nccl"
    return "gloo"


def _staged(t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend() == "gloo"


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the backend moves it: a pinned host copy under gloo for a
    CUDA tensor (a synchronous copy), else ``t`` made contiguous."""
    if not _staged(t):
        return t.contiguous()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _back(host: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A received buffer on ``like``'s device (queued on the current stream;
    the pinned buffer stays reserved until the copy is done)."""
    return host.to(like.device, non_blocking=True) if host.device != like.device else host


def _empty_wire(shape, like: torch.Tensor) -> torch.Tensor:
    if _staged(like):
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(shape, dtype=like.dtype, device=like.device)


@contextlib.contextmanager
def _timed(kind: str, nbytes: int, like: torch.Tensor):
    if _staged(like):  # the staging copy waits for the queued work anyway: keep that out of the clock
        torch.cuda.current_stream(like.device).synchronize()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        counts = TRAFFIC[kind]
        counts["ms"] += (time.perf_counter() - t0) * 1e3
        counts["bytes"] += nbytes
        counts["calls"] += 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over ``group``, as a new tensor on ``t``'s device;
    every member gets the same bits."""
    if dist.get_world_size(group) == 1:
        return t.clone()
    with _timed("all_reduce", _nbytes(t), t):
        buf = _wire(t) if _staged(t) else t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        return _back(buf, t)


def all_gather(t: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Every member's ``t`` (all of one shape), in group order."""
    n = dist.get_world_size(group)
    if n == 1:
        return [t]
    with _timed("all_gather", _nbytes(t), t):
        wire = _wire(t)
        outs = [_empty_wire(t.shape, t) for _ in range(n)]
        dist.all_gather(outs, wire, group=group)
        return [_back(o, t) for o in outs]


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` of the global rank ``src`` on every member of ``group``,
    written into ``t`` in place and returned."""
    if dist.get_world_size(group) == 1:
        return t
    with _timed("broadcast", _nbytes(t) if dist.get_rank() == src else 0, t):
        wire = _wire(t)
        dist.broadcast(wire, src=src, group=group)
        if wire.data_ptr() != t.data_ptr():
            t.copy_(wire)
        return t


def swap(sends: dict[int, torch.Tensor], recvs: dict[int, tuple], like: torch.Tensor) -> dict[int, torch.Tensor]:
    """Point-to-point exchange on the world group: send ``sends[r]`` to
    global rank r and receive a tensor of shape ``recvs[r]`` (``like``'s
    dtype and device) from each r; posted as one batch (NCCL would deadlock
    on a pair's receive and send issued apart), then waited for."""
    nbytes = sum(_nbytes(t) for t in sends.values())
    with _timed("p2p", nbytes, like):
        wires = {r: _wire(t) for r, t in sends.items()}
        bufs = {r: _empty_wire(shape, like) for r, shape in recvs.items()}
        ops = [dist.P2POp(dist.irecv, b, r) for r, b in bufs.items()]
        ops += [dist.P2POp(dist.isend, w, r) for r, w in wires.items()]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return {r: _back(b, like) for r, b in bufs.items()}


# ---------------------------------------------------------------------------
# The halo exchange
# ---------------------------------------------------------------------------


def _overlap(a: tuple[int, int], b: tuple[int, int]) -> tuple[int, int] | None:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if lo < hi else None


class HaloPlan:
    """Who sends which rows to whom. Member q of a group (global rank
    ``ranks[q]``) owns rows ``own[q]`` of a frame (dim 1 of an
    (N, H, W, C) tensor; the members' rows tile the frame in group order)
    and needs rows ``need[q]``, which contain its own. ``me`` is this
    rank's member index. The rows it receives from each owner, in order,
    make up its extended band; several owners may contribute when a band
    is shorter than the halo."""

    def __init__(self, own: list[tuple[int, int]], need: list[tuple[int, int]], ranks: list[int], me: int):
        self.own, self.need, self.ranks, self.me = own, need, ranks, me
        s, e = own[me]
        lo, hi = need[me]
        if not lo <= s < e <= hi:
            raise ValueError(f"member {me} needs rows {need[me]}, which must contain its own {own[me]}")
        # rows of my extended band, from each owner in row order
        self.pieces = [(q, ov) for q in range(len(own)) if (ov := _overlap(need[me], own[q])) is not None]
        if self.pieces[0][1][0] != lo or self.pieces[-1][1][1] != hi or any(
                a[1][1] != b[1][0] for a, b in zip(self.pieces, self.pieces[1:])):
            raise ValueError(f"owned rows {own} do not tile the rows {need[me]} that member {me} needs")
        # rows of mine that each other member needs
        self.outgoing = [(q, ov) for q in range(len(own))
                         if q != me and (ov := _overlap(need[q], own[me])) is not None]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """My owned rows (N, e - s, ...) -> my extended band (N, hi - lo, ...)."""
        s = self.own[self.me][0]
        sends = {self.ranks[q]: x[:, a - s:b - s] for q, (a, b) in self.outgoing}
        recvs = {self.ranks[q]: (x.shape[0], b - a, *x.shape[2:]) for q, (a, b) in self.pieces if q != self.me}
        got = swap(sends, recvs, x) if sends or recvs else {}
        return torch.cat([x[:, a - s:b - s] if q == self.me else got[self.ranks[q]]
                          for q, (a, b) in self.pieces], dim=1)

    def scatter_add(self, g: torch.Tensor) -> torch.Tensor:
        """The transpose of ``gather``: the gradient of my extended band ->
        the gradient of my owned rows, each halo row's gradient sent back to
        its owner and added there."""
        s, e = self.own[self.me]
        lo = self.need[self.me][0]
        sends = {self.ranks[q]: g[:, a - lo:b - lo] for q, (a, b) in self.pieces if q != self.me}
        recvs = {self.ranks[q]: (g.shape[0], b - a, *g.shape[2:]) for q, (a, b) in self.outgoing}
        got = swap(sends, recvs, g) if sends or recvs else {}
        out = g[:, s - lo:e - lo].clone()
        for q, (a, b) in self.outgoing:
            out[:, a - s:b - s] += got[self.ranks[q]]
        return out


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan: HaloPlan):
        ctx.plan = plan
        return plan.gather(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.plan.scatter_add(g.contiguous()), None


def halo(x: torch.Tensor, plan: HaloPlan) -> torch.Tensor:
    """``plan.gather(x)``, differentiable."""
    return _Halo.apply(x, plan)


# ---------------------------------------------------------------------------
# Differentiable reductions
# ---------------------------------------------------------------------------


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group), None


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group), None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; its gradient is the sum of the
    members' gradients."""
    return _AllReduceSum.apply(x, group)


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *f*: ``x`` forward; backward, the sum over ``group`` of
    the members' gradients (each tp rank's share of the FFN's input
    gradient)."""
    return _CopyToTp.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *g*: the sum over ``group`` of the members' partial
    outputs forward; backward, the gradient as it is."""
    return _ReduceFromTp.apply(x, group)
