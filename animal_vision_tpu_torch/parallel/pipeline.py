"""Pipeline parallelism (pp): MST++'s stages over ranks, GPipe schedule.

Counterpart of ``animal_vision_tpu/parallel/pipeline.py``. Each rank of a
pp group holds one stage; microbatches stream through: at tick t, slot i
applies its stage to microbatch t - i, received from slot i - 1 (slot 0
reads the microbatches), and sends the result to slot i + 1. The last
slot's outputs are broadcast to every slot. Slots beyond the stage count
are identity slots (``real_flag`` 0). The bubble share is
(pp - 1) / (n_micro + pp - 1).

Each rank holds its own stage's weights, so the JAX package's stacking of
the stages along a sharded axis (a layout for ``shard_map``) is not carried
over. On the card every stage runs the MST++ kernels.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from animal_vision_tpu_torch.parallel import comm


@dataclass(frozen=True)
class PPMesh:
    """Slot ``index`` of a pipeline of ``size`` slots over ``group``
    (global ranks ``ranks``); ``index`` is None on a rank outside it."""

    size: int
    index: int | None
    group: object
    ranks: tuple


def make_pp_mesh(n: int | None = None) -> PPMesh:
    """A pipeline over the world's first ``n`` ranks (all when None).
    Collective: every rank of the world calls it."""
    world = dist.get_world_size()
    n = world if n is None else n
    if not 1 <= n <= world:
        raise ValueError(f"a pipeline of {n} slots over {world} ranks")
    ranks = tuple(range(n))
    group = dist.new_group(list(ranks)) if n < world else dist.group.WORLD
    rank = dist.get_rank()
    return PPMesh(n, rank if rank < n else None, group, ranks)


def bubble_share(pp: int, n_micro: int) -> float:
    """The idle share of a GPipe schedule: (pp - 1) / (n_micro + pp - 1)."""
    return (pp - 1) / (n_micro + pp - 1)


def pipeline_apply(stage_fn, rank_params, real_flag, microbatches: torch.Tensor, mesh: PPMesh) -> torch.Tensor:
    """Run ``stage_fn(rank_params, x)`` as this rank's slot of the pipeline.

    ``rank_params``: this slot's stage; ``real_flag``: 0 for an identity
    slot; ``microbatches``: (n_micro, ...) on every rank (slot 0 reads
    them). Stages keep a microbatch's shape. Returns the (n_micro, ...)
    outputs of the last slot on every rank."""
    if mesh.index is None:
        raise ValueError("this rank is not a slot of the pipeline")
    i, npp = mesh.index, mesh.size
    n_micro = int(microbatches.shape[0])
    outs = torch.empty_like(microbatches)
    for tick in range(n_micro + npp - 1):
        k = tick - i
        if not 0 <= k < n_micro:
            continue
        if i == 0:
            x = microbatches[k]
        else:
            x = comm.swap({}, {mesh.ranks[i - 1]: tuple(microbatches.shape[1:])}, microbatches)[mesh.ranks[i - 1]]
        y = stage_fn(rank_params, x) if real_flag else x
        if i < npp - 1:
            comm.swap({mesh.ranks[i + 1]: y}, {}, microbatches)
        else:
            outs[k] = y
    return comm.broadcast(outs, src=mesh.ranks[npp - 1], group=mesh.group)


def mst_plus_plus_pp_forward(model, mesh: PPMesh, x: torch.Tensor, n_micro: int = 4) -> torch.Tensor:
    """MST++ with its MST stages pipelined over the pp slots (slot i runs
    stage i; slots past the last stage pass their input on). conv_in,
    conv_out and the global residual run on every rank; the batch is split
    into ``n_micro`` microbatches. ``x`` (B, H, W, 3), the same on every
    rank, on the model's device -> (B, H, W, 31) on every rank; the
    kernels on the card."""
    from animal_vision_tpu_torch.models.mst_plus_plus import _stage
    from animal_vision_tpu_torch.ops import fused_msab as K
    from animal_vision_tpu_torch.parallel.fused_shard import pad_frames

    b, h, w = (int(v) for v in x.shape[:3])
    if mesh.index is None:
        raise ValueError("this rank is not a slot of the pipeline")
    if b % n_micro:
        raise ValueError(f"a batch of {b} does not split into {n_micro} microbatches")
    if mesh.size < model.stage:
        raise ValueError(f"{model.stage} stages need at least as many pipeline slots, got {mesh.size}")
    with torch.no_grad():
        p = model.weights(x.device)
        xp = pad_frames(x.to(torch.float32)).contiguous()
        feat = K.conv(xp, p["conv_in"])
        real = mesh.index < model.stage
        st = p["stages"][mesh.index] if real else None
        micro = feat.reshape(n_micro, b // n_micro, *feat.shape[1:])
        body = pipeline_apply(lambda q, t: _stage(t, q, False), st, real, micro, mesh)
        out = K.conv(body.reshape(feat.shape).contiguous(), p["conv_out"], residual=feat)
    return out[:, :h, :w]
