"""The dp / sp / tp rank grid, its process groups, and sharded inference.

Counterpart of ``animal_vision_tpu/parallel/mesh.py``. The JAX package
lays chips out as ``devices.reshape(dp, sp, tp)``; here the world's ranks
take the same order, ``rank = (d * sp + s) * tp + t`` (``rank_grid``), and
``make_mesh`` creates the process groups along each axis and the two
products the port needs (``spx``, the spatial axis with tp folded in, and
``dpsp``, the ranks that hold the same tp slice). Creating them is
collective: every rank calls ``make_mesh`` with the same arguments in the
same order.

- **dp**: frames; ``shard_batch`` gives this rank its slice of a batch.
- **sp**: rows. Inference runs MST++ on halo bands
  (``parallel/fused_shard.py``); training runs its differentiable band
  forward (``models/train.py:make_sharded_train_step``).
- **tp**: the FFN's hidden channels, as ``param_specs`` names them (the
  output axis of ``net_0``, the depthwise ``net_2``, the input axis of
  ``net_4``). Inference folds tp into the spatial axis, as the JAX package
  does; training splits the hidden channels, Megatron style.

``sharded_inference_fn`` takes the band path when MST++ and the frame
allow it (``fused_shard.supports``). Otherwise (a frame that does not
split into 4-row-aligned bands, or another model) every rank runs the
model whole on its dp slice of the batch (the whole batch when it does not
split over dp) and the slices are gathered: there is no GSPMD to partition
an arbitrary program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from animal_vision_tpu_torch.parallel import comm

#: the process groups of a mesh, each one member of a partition of the world
AXES = ("dp", "sp", "tp", "spx", "dpsp")


def rank_grid(dp: int, sp: int = 1, tp: int = 1) -> np.ndarray:
    """The (dp, sp, tp) array of global ranks (the JAX ``reshape`` order)."""
    return np.arange(dp * sp * tp).reshape(dp, sp, tp)


def _partition(grid: np.ndarray, axis: str) -> list[list[int]]:
    dp, sp, tp = grid.shape
    if axis == "dp":
        return [grid[:, s, t].tolist() for s in range(sp) for t in range(tp)]
    if axis == "sp":
        return [grid[d, :, t].tolist() for d in range(dp) for t in range(tp)]
    if axis == "tp":
        return [grid[d, s, :].tolist() for d in range(dp) for s in range(sp)]
    if axis == "spx":
        return [grid[d].ravel().tolist() for d in range(dp)]
    return [grid[:, :, t].ravel().tolist() for t in range(tp)]  # dpsp


@dataclass
class Mesh:
    """This rank's place in a (dp, sp, tp) grid and its process group along
    each of ``AXES`` (``groups[axis]``)."""

    dp: int
    sp: int
    tp: int
    rank: int
    groups: dict

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "sp": self.sp, "tp": self.tp}

    @property
    def coords(self) -> tuple[int, int, int]:
        """(d, s, t) of this rank."""
        d, rest = divmod(self.rank, self.sp * self.tp)
        return (d, *divmod(rest, self.tp))

    @property
    def spx(self) -> int:
        return self.sp * self.tp

    @property
    def spx_index(self) -> int:
        """This rank's place on the spatial axis with tp folded in."""
        return self.rank % self.spx


def make_mesh(dp: int | None = None, sp: int = 1, tp: int = 1) -> Mesh:
    """The (dp, sp, tp) mesh over the world's ranks; ``dp`` defaults to the
    ranks left after sp x tp. Collective: every rank calls it alike."""
    world = dist.get_world_size()
    if dp is None:
        if world % (sp * tp):
            raise ValueError(f"{world} ranks do not split into sp={sp} x tp={tp}")
        dp = world // (sp * tp)
    if dp * sp * tp != world:
        raise ValueError(f"dp={dp} x sp={sp} x tp={tp} != {world} ranks")
    grid = rank_grid(dp, sp, tp)
    groups = {axis: dist.new_subgroups_by_enumeration(_partition(grid, axis))[0] for axis in AXES}
    return Mesh(dp, sp, tp, dist.get_rank(), groups)


def shard_batch(mesh: Mesh, batch: torch.Tensor) -> torch.Tensor:
    """This rank's block of a (B, H, W, C) batch, as the JAX
    ``activation_spec`` places it: frames of its dp index, rows of its sp
    index. B must split over dp and H over sp."""
    b, h = int(batch.shape[0]), int(batch.shape[1])
    if b % mesh.dp or h % mesh.sp:
        raise ValueError(f"batch {tuple(batch.shape)} does not split over dp={mesh.dp} x sp={mesh.sp}")
    d, s, _ = mesh.coords
    bl, hl = b // mesh.dp, h // mesh.sp
    return batch[d * bl:(d + 1) * bl, s * hl:(s + 1) * hl]


def param_specs(model: torch.nn.Module) -> dict[str, tuple]:
    """The tp split of each parameter of an MST++ ``model``, by name: the
    axis of the FFN's hidden channels for ``net.0`` (the output axis of the
    1x1, dim 0 of its (4C, C, 1, 1) weight), ``net.2`` (the depthwise, dim
    0 of (4C, 1, 3, 3)) and ``net.4`` (the input axis of the 1x1, dim 1 of
    (C, 4C, 1, 1)), as ``("tp", dim)``; ``()`` (replicated) for the rest."""
    out = {}
    for name, _ in model.named_parameters():
        if ".fn.net.0." in name or ".fn.net.2." in name:
            out[name] = ("tp", 0)
        elif ".fn.net.4." in name:
            out[name] = ("tp", 1)
        else:
            out[name] = ()
    return out


def tp_slice(hidden: int, tp: int, t: int) -> slice:
    """The hidden channels of tp rank ``t`` of ``tp``: contiguous equal
    shares, as a sharded axis splits."""
    if hidden % tp:
        raise ValueError(f"{hidden} hidden channels do not split over tp={tp}")
    n = hidden // tp
    return slice(t * n, (t + 1) * n)


def sharded_inference_fn(mesh: Mesh, model: torch.nn.Module):
    """``run(x)``: (B, H, W, 3) float32 frames, the same on every rank ->
    the model's (B, H, W, C) output on every rank, without autograd. MST++
    takes the halo bands when ``fused_shard.supports``; anything else runs
    whole per dp slice (``replicated_forward``)."""
    from animal_vision_tpu_torch.models.mst_plus_plus import MSTPlusPlus
    from animal_vision_tpu_torch.parallel import fused_shard

    bands = isinstance(model, MSTPlusPlus)

    def run(x: torch.Tensor) -> torch.Tensor:
        b, h, w = (int(s) for s in x.shape[:3])
        with torch.no_grad():
            if bands and fused_shard.supports(mesh, b, h, w):
                return fused_shard.fused_sharded_forward(mesh, model, x)
            return replicated_forward(mesh, model, x)

    return run


def replicated_forward(mesh: Mesh, model: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``model(x)`` on every rank: each runs its dp slice whole and the
    slices are gathered over dp; a batch that does not split over dp runs
    whole on every rank."""
    b = int(x.shape[0])
    if mesh.dp == 1 or b % mesh.dp:
        return model(x)
    d = mesh.coords[0]
    bl = b // mesh.dp
    y = model(x[d * bl:(d + 1) * bl].contiguous())
    return torch.cat(comm.all_gather(y.contiguous(), mesh.groups["dp"]), dim=0)
