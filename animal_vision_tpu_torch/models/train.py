"""MST++ training: objective, Adam with a warmup-cosine schedule, patch
sampling, synthetic scenes, and the train -> checkpoint -> resume -> eval
demo.

Counterpart of ``animal_vision_tpu/models/train.py``: the step on one
device (``make_train_step``) and over a dp / sp / tp mesh of ranks
(``make_sharded_train_step``, on ``parallel/``). The reference ships no
training code; the JAX package supplies an L1 / MRAE objective on random
crops with rot / flip augmentation (the reference eval harness's
``TrainDataset``), and Adam with ``optax.warmup_cosine_decay_schedule``.
Here the optimizer is ``torch.optim.Adam`` and the schedule a ``LambdaLR``
equal to optax's at every count; the step count, like optax's, starts at
0, so the first update runs at the schedule's first value (0 after a
warmup).

The forward of a train step composes the plain versions of the MST++
kernels on the live parameters (``MSTPlusPlus.forward(x, plain=True)``
under grad): the CUDA kernels have no backward, and the JAX trainer runs no
Pallas kernel either (``models/train.py:44-47``). Inference on the trained
weights (``convergence_demo``'s held-out evaluation, under
``torch.no_grad()``) runs the kernels on the card.

No ARAD data is in the repository, so, like the JAX package, training and
evaluation run on synthetic scenes whose ground truth is the analytic
3-lobe RGB -> 31-band converter (``spectral/classic.py``).
"""

from __future__ import annotations

import math
import os
import tempfile
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from animal_vision_tpu_torch.core import geometry
from animal_vision_tpu_torch.models import metrics
from animal_vision_tpu_torch.models.mst_plus_plus import MSTPlusPlus
from animal_vision_tpu_torch.models.zoo import init_weights
from animal_vision_tpu_torch.species import resolve_device
from animal_vision_tpu_torch.spectral.classic import classic_rgb_to_hsi

LOSSES = ("mrae", "l1")


@dataclass(frozen=True)
class Optimizer:
    """Adam (b1 0.9, b2 0.999, eps 1e-8) with optax's
    ``warmup_cosine_decay_schedule(0, lr, warmup, total_steps)``: the
    counterpart of the JAX ``make_optimizer``'s gradient transformation,
    which ``init_state`` builds over a model's parameters."""

    lr: float
    total_steps: int
    warmup: int

    def schedule(self, count: int) -> float:
        """The rate of update ``count`` (0 for the first): linear from 0 to
        ``lr`` over ``warmup`` counts, then a cosine decay to 0 at
        ``total_steps``, held there (optax's formulas, in float64)."""
        if count < self.warmup:
            frac = 1.0 - min(max(count, 0), self.warmup) / self.warmup
            return (0.0 - self.lr) * frac + self.lr
        decay = self.total_steps - self.warmup
        t = min(float(count - self.warmup), float(decay))
        return self.lr * (0.5 * (1.0 + math.cos(math.pi * t / decay)))

    def build(self, params) -> tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
        """(Adam, its schedule) over ``params``. The optimizer's base rate is
        1 and the schedule gives the rate itself, so the rate of each update
        is ``schedule(count)`` with no rescaling; step the schedule after
        each ``optimizer.step()``."""
        opt = torch.optim.Adam(params, lr=1.0, betas=(0.9, 0.999), eps=1e-8)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, self.schedule)


def make_optimizer(lr: float = 4e-4, total_steps: int = 300_000, warmup: int = 1000) -> Optimizer:
    if total_steps <= warmup:
        raise ValueError(f"total_steps ({total_steps}) must exceed warmup ({warmup}): the cosine decays over "
                         "total_steps - warmup counts")
    return Optimizer(lr, total_steps, warmup)


@dataclass
class TrainState:
    """The JAX ``TrainState`` (params, opt_state, step): the model holds the
    parameters, the optimizer its moments and count, the scheduler the
    schedule's count."""

    model: nn.Module
    optimizer: torch.optim.Adam
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0


def init_state(model: nn.Module, optimizer: Optimizer, seed: int = 0,
               device: str | torch.device | None = None) -> TrainState:
    """``model`` with weights drawn from ``torch.Generator().manual_seed(seed)``
    (``zoo.init_weights``), on ``device`` (the card when None), with a fresh
    optimizer and schedule."""
    device = resolve_device(device)
    model = init_weights(model, torch.Generator().manual_seed(seed)).to(device)
    return TrainState(model, *optimizer.build(model.parameters()))


def loss_fn(model: nn.Module, rgb: torch.Tensor, hsi: torch.Tensor, loss: str = "mrae"):
    """(value, pred): the reference's training objective, MRAE with the
    target clamped at 1e-3 below, or L1, of the differentiable forward."""
    pred = model(rgb, plain=True)
    if loss == "mrae":
        value = torch.mean(torch.abs(pred - hsi) / torch.clamp(hsi, min=1e-3))
    elif loss == "l1":
        value = torch.mean(torch.abs(pred - hsi))
    else:
        raise ValueError(f"loss must be one of {LOSSES}, got {loss!r}")
    return value, pred


def _on(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x) if isinstance(x, np.ndarray) else x,
                           dtype=torch.float32).to(device)


def make_train_step(loss: str = "mrae"):
    """``step(state, rgb, hsi) -> (state, metrics)``: one Adam update of
    ``state`` in place on a (B, P, P, 3) / (B, P, P, 31) batch (tensors or
    arrays), then the schedule's step. ``metrics`` holds the loss, RMSE and
    PSNR at data range 1 of the batch's prediction, as device scalars (no
    synchronisation)."""
    _check_loss(loss)

    def step(state: TrainState, rgb, hsi):
        device = next(state.model.parameters()).device
        rgb, hsi = _on(rgb, device), _on(hsi, device)
        state.optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            value, pred = loss_fn(state.model, rgb, hsi, loss)
            value.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        pred = pred.detach()
        return state, {"loss": value.detach(), "rmse": metrics.rmse(pred, hsi),
                       "psnr": metrics.psnr(pred, hsi, data_range=1.0)}

    return step


def _check_loss(loss: str) -> None:
    if loss not in LOSSES:
        raise ValueError(f"loss must be one of {LOSSES}, got {loss!r}")


def make_sharded_train_step(mesh, optimizer: Optimizer, loss: str = "mrae"):
    """The train step over a ``parallel.mesh.Mesh``: ``(run, place_state)``.

    ``run(state, rgb, hsi) -> (state, metrics)`` takes the whole
    (B, P, P, 3) / (B, P, P, 31) batch on every rank, like
    ``make_train_step``'s step, and leaves every rank's state equal:

    - dp: each rank takes its B / dp frames;
    - sp: each rank runs the plain band forward of
      ``parallel/fused_shard.py`` under autograd on Pp / sp rows (halo rows
      and the attention statistics' sum differentiable), and its loss is
      the sum over the rows it owns divided by the whole batch's count, so
      the ranks' losses add up to the batch's;
    - tp: each FFN runs this rank's share of the hidden channels
      (``parallel.mesh.param_specs``) between Megatron's *f* and *g*.

    Gradients are summed over dp x sp (the ranks of one tp index); those of
    the tp-split FFN weights, nonzero only on each rank's share, over the
    whole world. Every rank's Adam then steps the same gradients. Metrics
    are the batch's, as ``make_train_step`` reports them.

    ``place_state(state)`` gives every rank rank 0's parameters, optimizer
    state, schedule and step count, in a fresh Adam and schedule built by
    ``optimizer`` (the JAX ``place_state`` puts the state on the mesh)."""
    import torch.distributed as dist

    from animal_vision_tpu_torch.parallel import comm, fused_shard
    from animal_vision_tpu_torch.parallel.mesh import param_specs

    _check_loss(loss)
    d, s, t = mesh.coords
    tp = fused_shard.TpSplit(mesh.groups["tp"], t, mesh.tp) if mesh.tp > 1 else None

    def place_state(state: TrainState) -> TrainState:
        model = state.model
        params = list(model.parameters())
        with torch.no_grad():
            flat = comm.broadcast(torch.cat([p.reshape(-1) for p in params]), src=0)
            for p, v in zip(params, flat.split([p.numel() for p in params])):
                p.copy_(v.view_as(p))
        blob = [{"optimizer": state.optimizer.state_dict(), "scheduler": state.scheduler.state_dict(),
                 "step": int(state.step)}]
        if dist.get_rank() == 0:
            blob[0]["optimizer"]["state"] = {k: {n: v.cpu() if torch.is_tensor(v) else v for n, v in st.items()}
                                             for k, st in blob[0]["optimizer"]["state"].items()}
        dist.broadcast_object_list(blob, src=0)
        opt, sched = optimizer.build(model.parameters())
        opt.load_state_dict(blob[0]["optimizer"])
        sched.load_state_dict(blob[0]["scheduler"])
        return TrainState(model, opt, sched, blob[0]["step"])

    def run(state: TrainState, rgb, hsi):
        model = state.model
        device = next(model.parameters()).device
        rgb, hsi = _on(rgb, device), _on(hsi, device)
        b, h, w = (int(v) for v in rgb.shape[:3])
        if not fused_shard.supports((mesh.dp, mesh.sp, 1), b, h, w):
            raise ValueError(f"a ({b}, {h}, {w}) batch does not split over dp={mesh.dp} and into {mesh.sp} bands "
                             "of a multiple of 4 rows")
        bl = b // mesh.dp
        target = hsi[d * bl:(d + 1) * bl]
        xpad = fused_shard.pad_frames(rgb[d * bl:(d + 1) * bl])
        bands = fused_shard.make_bands(int(xpad.shape[1]), mesh.sp, s, mesh.groups["sp"])
        r0, r1 = bands.own
        r1 = min(r1, h)
        target = target[:, r0:r1]
        count = b * h * w * int(hsi.shape[-1])
        state.optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            pred = fused_shard.band_forward(model._layouts(live=True), xpad, bands, plain=True, tp=tp)
            pred = pred[:, :r1 - r0, :w]
            err = torch.abs(pred - target)
            if loss == "mrae":
                err = err / torch.clamp(target, min=1e-3)
            local = err.sum() / count
            local.backward()
        specs = param_specs(model)
        split = [p for n, p in model.named_parameters() if tp is not None and specs[n]]
        split_ids = {id(p) for p in split}
        rest = [p for p in model.parameters() if id(p) not in split_ids]
        for params, group in ((rest, mesh.groups["dpsp"]), (split, None)):
            if params:
                flat = comm.all_reduce(torch.cat([p.grad.reshape(-1) for p in params]), group)
                for p, g in zip(params, flat.split([p.numel() for p in params])):
                    p.grad.copy_(g.view_as(p))
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        with torch.no_grad():
            pred = pred.detach()
            sse = torch.zeros(2, b, dtype=torch.float32, device=device)
            sse[0, d * bl:(d + 1) * bl] = ((pred - target) ** 2).sum(dim=(1, 2, 3))
            clamped = torch.clamp(pred, 0.0, 1.0) - torch.clamp(target, 0.0, 1.0)
            sse[1, d * bl:(d + 1) * bl] = (clamped ** 2).sum(dim=(1, 2, 3))
            tot = comm.all_reduce(torch.cat([local.detach().reshape(1), sse.reshape(-1)]), mesh.groups["dpsp"])
            sse = tot[1:].reshape(2, b)
            per_image = count // b
        return state, {"loss": tot[0], "rmse": torch.sqrt(sse[0].sum() / count),
                       "psnr": torch.mean(10.0 * torch.log10(1.0 / (sse[1] / per_image)))}

    return run, place_state


# ---------------------------------------------------------------------------
# Patch sampling with the reference harness's augmentation semantics
# ---------------------------------------------------------------------------


def sample_patches(rng: np.random.Generator, rgb: np.ndarray, hsi: np.ndarray, patch: int, batch: int):
    """Random crops with random rot90 / flip pairs (TrainDataset's
    arguement(), test_develop_code/hsi_dataset.py:33-46), NumPy, the JAX
    package's draws."""
    h, w = rgb.shape[:2]
    out_r, out_h = [], []
    for _ in range(batch):
        y = int(rng.integers(0, h - patch + 1))
        x = int(rng.integers(0, w - patch + 1))
        r = rgb[y : y + patch, x : x + patch]
        s = hsi[y : y + patch, x : x + patch]
        k = int(rng.integers(0, 4))
        r, s = np.rot90(r, k), np.rot90(s, k)
        if rng.integers(0, 2):
            r, s = r[::-1], s[::-1]
        if rng.integers(0, 2):
            r, s = r[:, ::-1], s[:, ::-1]
        out_r.append(np.ascontiguousarray(r))
        out_h.append(np.ascontiguousarray(s))
    return np.stack(out_r), np.stack(out_h)


# ---------------------------------------------------------------------------
# Synthetic scenes, and the train -> checkpoint -> resume -> eval demo
# ---------------------------------------------------------------------------


def _with_cubes(rgbs: torch.Tensor) -> list[tuple[np.ndarray, np.ndarray]]:
    hsis = classic_rgb_to_hsi(rgbs)
    rgbs, hsis = rgbs.cpu().numpy(), hsis.cpu().numpy()
    return [(np.ascontiguousarray(rgbs[i]), np.ascontiguousarray(hsis[i], dtype=np.float32))
            for i in range(rgbs.shape[0])]


def synthetic_scenes(n: int, h: int, w: int, seed: int = 0, device: str | torch.device | None = None):
    """``n`` smooth random (rgb (h, w, 3), hsi (h, w, 31)) float32 scenes:
    uniform noise at an eighth of the size upsampled bilinearly with
    half-pixel centres (``core/geometry.resize``, what
    ``jax.image.resize(..., "linear")`` computes when it upsamples), and
    their cubes by the analytic converter, computed on ``device`` (the card
    when None)."""
    rng = np.random.default_rng(seed)
    lows = rng.uniform(0, 1, (n, max(2, h // 8), max(2, w // 8), 3)).astype(np.float32)
    low = torch.from_numpy(lows).to(resolve_device(device))
    return _with_cubes(geometry.resize(low, (h, w), "linear"))


def xgen_scenes(n: int, h: int, w: int, seed: int = 0, device: str | torch.device | None = None):
    """A held-out scene family disjoint from ``synthetic_scenes``: per
    channel a 1/f amplitude spectrum with random phase plus three solid
    rectangles (full-band content with edges), with the same analytic
    cubes; the RGB is made with NumPy as the JAX package makes it."""
    rng = np.random.default_rng(seed)
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    amp = 1.0 / np.maximum(np.hypot(fy, fx), 1.0 / max(h, w))
    rgbs = []
    for _ in range(n):
        chans = []
        for _c in range(3):
            phase = rng.uniform(0.0, 2.0 * np.pi, (h, w))
            img = np.fft.ifft2(amp * np.exp(1j * phase)).real
            img = (img - img.min()) / max(img.max() - img.min(), 1e-8)
            chans.append(img)
        rgb = np.stack(chans, axis=-1).astype(np.float32)
        for _k in range(3):  # sharp structure: random solid rectangles
            y0 = int(rng.integers(0, max(1, h - 8)))
            x0 = int(rng.integers(0, max(1, w - 8)))
            y1 = int(rng.integers(y0 + 4, min(h, y0 + max(8, h // 3)) + 1))
            x1 = int(rng.integers(x0 + 4, min(w, x0 + max(8, w // 3)) + 1))
            rgb[y0:y1, x0:x1] = rng.uniform(0.0, 1.0, 3).astype(np.float32)
        rgbs.append(np.clip(rgb, 0.0, 1.0))
    return _with_cubes(torch.from_numpy(np.stack(rgbs)).to(resolve_device(device)))


def convergence_demo(
    steps: int = 60,
    patch: int = 32,
    batch: int = 4,
    n_scenes: int = 4,
    scene_hw: tuple = (64, 64),
    stage: int = 1,
    lr: float = 2e-3,
    seed: int = 0,
    ckpt_dir: str | None = None,
    return_state: bool = False,
    device: str | torch.device | None = None,
):
    """Train a small MST++ on synthetic analytic-HSI scenes with the L1
    loss, checkpoint at the midpoint, restore into a fresh model, optimizer
    and schedule, train on, and score a held-out scene with the eval
    harness before and after (under ``torch.no_grad()``: on the card, the
    kernels). Returns the JAX demo's keys; with ``return_state`` also
    ``state``, ``module`` (the model) and ``held``."""
    from animal_vision_tpu_torch.models import eval as meval
    from animal_vision_tpu_torch.models.export import load_checkpoint, save_checkpoint

    device = resolve_device(device)
    h, w = scene_hw
    scenes = synthetic_scenes(n_scenes, h, w, seed, device)
    train_scenes, held = scenes[:-1], scenes[-1]
    opt = make_optimizer(lr=lr, total_steps=steps, warmup=max(1, steps // 20))
    state = init_state(MSTPlusPlus(stage=stage), opt, seed, device)
    step = make_train_step("l1")

    def eval_held(model):
        return meval.validate(meval.model_apply_fn(model), [held], crop=0)

    init_metrics = eval_held(state.model)
    rng = np.random.default_rng(seed + 1)
    losses = []

    def run(state, n):
        # every batch drawn first and moved in one copy; the losses stay on
        # the device until the end
        brs, bhs = [], []
        for _ in range(n):
            rgb, hsi = train_scenes[int(rng.integers(0, len(train_scenes)))]
            br, bh = sample_patches(rng, rgb, hsi, patch, batch)
            brs.append(br)
            bhs.append(bh)
        brs, bhs = torch.from_numpy(np.stack(brs)).to(device), torch.from_numpy(np.stack(bhs)).to(device)
        for i in range(n):
            state, m = step(state, brs[i], bhs[i])
            losses.append(m["loss"])
        return state

    state = run(state, steps // 2)
    with tempfile.TemporaryDirectory(prefix="avt_ckpt_") as tmp:
        path = os.path.join(ckpt_dir or tmp, "mid.pt")
        save_checkpoint(path, state)
        fresh = MSTPlusPlus(stage=stage).to(device)
        state = load_checkpoint(path, TrainState(fresh, *opt.build(fresh.parameters())))
    state = run(state, steps - steps // 2)

    final_metrics = eval_held(state.model)
    out_state = {"state": state, "module": state.model, "held": held} if return_state else {}
    return {
        **out_state,
        "psnr_init": float(init_metrics["psnr"]),
        "psnr_final": float(final_metrics["psnr"]),
        "mrae_init": float(init_metrics["mrae"]),
        "mrae_final": float(final_metrics["mrae"]),
        "loss_first": float(losses[0]),
        "loss_last": float(losses[-1]),
        "steps": steps,
        "resumed_step": int(state.step),
    }
