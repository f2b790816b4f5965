"""Rank functions of the multi-device tests (``tests/test_torch_parallel_*.py``).

Spawned ranks import this module by name and run one of its functions
(``parallel/launch.spawn``). It imports only torch, NumPy and the port:
never JAX, the JAX package or ``tests/conftest.py``. Each function asserts
that, and returns host data (NumPy arrays, numbers) for the test process
to hold against the port's unsharded path and the JAX package.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist

from animal_vision_tpu_torch.models import train
from animal_vision_tpu_torch.models.mst_plus_plus import MSTPlusPlus, load_shipped
from animal_vision_tpu_torch.parallel import comm, fused_shard, make_mesh, sharded_inference_fn
from animal_vision_tpu_torch.parallel.pipeline import make_pp_mesh, mst_plus_plus_pp_forward, pipeline_apply

LR, TOTAL, WARMUP = 2e-3, 20, 0  # warmup 0: the first update runs at the full rate


def no_jax() -> None:
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "animal_vision_tpu", "conftest"))
    if bad:
        raise AssertionError(f"a rank imported {bad[:5]}")


def _t(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# ---------------------------------------------------------------------------
# Band forward, fallback, halo autograd
# ---------------------------------------------------------------------------


def _grad_world_fn(x_full: torch.Tensor, bands: fused_shard.Bands, margin: int) -> torch.Tensor:
    """A function of the replicated frame whose output is replicated too:
    *f*, this rank's own rows, the halo gather, then each rank's extended
    band in its slot of a zero tensor and *g* (the sum over the group): the
    members' extended bands side by side. Its Jacobian on every rank is the
    whole function's, so ``gradcheck`` can run on every rank at once."""
    x = comm.copy_to_tp(x_full, bands.group)
    s, e = bands.own
    ext = comm.halo(x[:, s:e], bands.plan(margin))
    slots = []
    for q in range(bands.n):
        lo, hi = bands.extended(q, margin)
        shape = (x.shape[0], hi - lo, *x.shape[2:])
        slots.append(ext if q == bands.j else torch.zeros(shape, dtype=x.dtype, device=x.device))
    return comm.reduce_from_tp(torch.cat(slots, dim=1), bands.group)


def shard_checks(device, x: np.ndarray, fallback_shapes: list, grad_x: np.ndarray) -> dict:
    """Band forward (sp 2 x tp 2 and dp 2 x sp 2), the fallback, halo
    gradcheck and a band-sum loss's gradients, on a world of 4."""
    no_jax()
    torch.manual_seed(0)
    model = load_shipped(device)
    xt = _t(x, device)
    with torch.no_grad():
        want = model(xt, plain=True)
    out = {"rank": dist.get_rank()}
    for name, dims in (("sp2tp2", (1, 2, 2)), ("dp2sp2", (2, 2, 1))):
        mesh = make_mesh(*dims)
        if not fused_shard.supports(mesh, *x.shape[:3]):
            raise AssertionError(f"{name}: {x.shape} must take the band path")
        got = sharded_inference_fn(mesh, model)(xt)
        out[name] = got.cpu().numpy()
        out[f"{name}_err"] = float((got - want).abs().max())
    mesh = make_mesh(1, 2, 2)
    for shape in fallback_shapes:
        xf = _t(np.random.default_rng(sum(shape)).uniform(0, 1, shape).astype(np.float32), device)
        took_bands = fused_shard.supports(mesh, *shape[:3])
        with torch.no_grad():
            err = float((sharded_inference_fn(mesh, model)(xf) - model(xf)).abs().max())
        out[f"fallback{tuple(shape)}"] = (took_bands, err)

    # halo autograd: two ranks per sp group, bands of 4 rows, margins 6 and 2
    mesh = make_mesh(2, 2, 1)
    d, s, _ = mesh.coords
    xg = torch.from_numpy(grad_x).to(device).requires_grad_(True)
    bands = fused_shard.make_bands(int(xg.shape[1]), 2, s, mesh.groups["sp"])
    out["gradcheck"] = [torch.autograd.gradcheck(lambda v, m=m: _grad_world_fn(v, bands, m), (xg,), eps=1e-6,
                                                 atol=1e-8, rtol=1e-7) for m in (6, 2)]

    # a band-sum loss: the sum over the ranks of each rank's gradient equals
    # the unsharded gradient, for the frame and every parameter
    small = MSTPlusPlus(stage=1).to(device)
    small.load_state_dict({k: v for k, v in model.state_dict().items() if not k.startswith(("body.1", "body.2"))})
    wgen = np.random.default_rng(7)
    xl = _t(wgen.uniform(0, 1, (1, 32, 32, 3)).astype(np.float32), device).requires_grad_(True)
    wl = _t(wgen.normal(0, 1, (1, 32, 32, 31)).astype(np.float32), device)
    (small(xl, plain=True) * wl).sum().backward()
    want_g = {"x": xl.grad.clone(), **{n: p.grad.clone() for n, p in small.named_parameters()}}
    small.zero_grad()
    xl.grad = None
    pad = fused_shard.pad_frames(xl)
    bands = fused_shard.make_bands(32, 2, s, mesh.groups["sp"])
    r0, r1 = bands.own
    pred = fused_shard.band_forward(small._layouts(live=True), pad, bands, plain=True)
    (pred * wl[:, r0:r1]).sum().backward()
    got_g = {"x": xl.grad, **{n: p.grad for n, p in small.named_parameters()}}
    out["band_grad_rel"] = max(
        float((comm.all_reduce(got_g[k], mesh.groups["sp"]) - want_g[k]).abs().max() / want_g[k].abs().max())
        for k in want_g)
    return out


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


def pipeline_checks(device, micro: np.ndarray, x: np.ndarray) -> dict:
    """The toy stage x * a + b over a 2-slot pipeline (ranks 0 and 1), then
    MST++'s 3 stages over 4 slots, on a world of 4."""
    no_jax()
    out = {"rank": dist.get_rank()}
    pp2 = make_pp_mesh(2)
    if pp2.index is not None:
        params = [{"a": 2.0, "b": 0.0}, {"a": 1.0, "b": 3.0}][pp2.index]
        got = pipeline_apply(lambda p, t: t * p["a"] + p["b"], params, 1.0, _t(micro, device), pp2)
        out["toy"] = got.cpu().numpy()
    model = load_shipped(device)
    xt = _t(x, device)
    got = mst_plus_plus_pp_forward(model, make_pp_mesh(4), xt, n_micro=4)
    with torch.no_grad():
        want = model(xt)
    out["mst"] = got.cpu().numpy()
    out["mst_err"] = float((got - want).abs().max())
    return out


# ---------------------------------------------------------------------------
# Sharded train step
# ---------------------------------------------------------------------------


def _flat_params(model) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def train_checks(device, runs: list, rgb: np.ndarray, hsi: np.ndarray, steps: int, stage: int) -> list:
    """For each (name, (dp, sp, tp), init) of ``runs``, ``steps`` sharded
    steps from the seeded weights (or the state dict ``init``): the metrics
    of each step, the parameters after step 1 and the last (rank 0's), and
    whether every rank holds the same parameters."""
    no_jax()
    out = []
    for name, dims, init in runs:
        mesh = make_mesh(*dims)
        opt = train.make_optimizer(lr=LR, total_steps=TOTAL, warmup=WARMUP)
        state = train.init_state(MSTPlusPlus(stage=stage), opt, seed=0, device=device)
        if init is not None:
            state.model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
        run, place = train.make_sharded_train_step(mesh, opt, "mrae")
        state = place(state)
        metrics, params = [], {}
        for i in range(steps):
            state, m = run(state, rgb, hsi)
            metrics.append({k: float(v) for k, v in m.items()})
            if i in (0, steps - 1):
                params[i + 1] = {k: v.detach().cpu().numpy().copy() for k, v in state.model.named_parameters()}
        flat = _flat_params(state.model)
        same = all(torch.equal(flat, o) for o in comm.all_gather(flat))
        out.append({"name": name, "metrics": metrics, "params": params if dist.get_rank() == 0 else None,
                    "same": same, "step": state.step})
    return out


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def card_band_check(device, x: np.ndarray) -> dict:
    """sp 2 band forward with the kernels; the launch counts of this rank
    around it."""
    from animal_vision_tpu_torch.ops import _build

    no_jax()
    torch.backends.cuda.matmul.allow_tf32 = False
    model = load_shipped(device)
    run = sharded_inference_fn(make_mesh(sp=2), model)
    xt = _t(x, device)
    _build.reset_launches()
    got = run(xt)
    return {"out": got.cpu().numpy(), "launches": dict(_build.LAUNCHES), "backend": dist.get_backend(),
            "device": str(device)}


# ---------------------------------------------------------------------------
# Launch
# ---------------------------------------------------------------------------


def rank_info(device) -> dict:
    no_jax()
    return {"rank": dist.get_rank(), "world": dist.get_world_size(), "backend": dist.get_backend(),
            "device": str(device), "threads": torch.get_num_threads()}


def fail_on_rank_one(device) -> int:
    if dist.get_rank() == 1:
        raise ValueError("rank one fails on purpose")
    dist.barrier()  # rank 0 waits here for a peer that never comes
    return 0


def sleep_forever(device) -> int:
    import time

    time.sleep(3600)
    return 0
