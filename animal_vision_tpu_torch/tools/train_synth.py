"""Train the full MST++ on the synthetic analytic-HSI curriculum, score it
with the held-out scenes and the eval protocol, and save a checkpoint.

Counterpart of ``tools/train_synth.py``, with its flags and defaults and
``--device`` (the card unless ``cpu``):

- ``--curriculum mixed`` (the default) trains on both scene families,
  ``train.synthetic_scenes`` (seed 0) and ``train.xgen_scenes`` (seed
  100), ``max(2, scenes // 2)`` each, and holds out the last of each;
  ``synth`` trains on ``scenes`` smooth scenes and holds out the last two;
- Adam with ``make_optimizer(lr, steps, warmup=max(10, steps // 50))`` and
  the L1 loss; the train forward is MST++'s plain composition under
  autograd (``train.make_train_step``), so no kernel is launched;
- the patches come in chunks of ``CHUNK`` draws from
  ``np.random.default_rng(1)``: per draw a scene index, then
  ``sample_patches``; each chunk goes to the device in one copy. The time
  budget is checked before each chunk, so a run ends at a chunk's end;
- the held-out scenes are scored per family by ``validate(..., crop=0)``
  before training, every ``EVAL_EVERY`` steps and at the end, through the
  kernels on the card (``torch.no_grad()``);
- then the eval protocol on ``synthetic_scenes`` (seed 7) and
  ``xgen_scenes`` (seed 11) (``protocols``); last, the ``TrainState`` is
  saved to ``--out`` by ``export.save_checkpoint``, which
  ``quality.load_pretrained(path=...)`` reads.

The JAX tool labels its two synth held-out scenes ``synth`` and ``xgen``
under ``--curriculum synth``; here they are ``synth`` and ``synth_2``.

Usage:
    python -m animal_vision_tpu_torch.tools.train_synth [--steps 3000] [--budget-s 1500] \\
        [--out PATH] [--device cpu]

The default ``--out`` is the shipped ``models/pretrained/synth_v1.pt``, as
the JAX tool's is its shipped checkpoint: pass another path to keep it.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from animal_vision_tpu_torch.models import eval as meval
from animal_vision_tpu_torch.models import export, quality
from animal_vision_tpu_torch.models import train as T
from animal_vision_tpu_torch.models.mst_plus_plus import SHIPPED, MSTPlusPlus
from animal_vision_tpu_torch.species import resolve_device

CHUNK = 100
EVAL_EVERY = 500
PROTOCOL = (2, (288, 320))  # scenes per family and their size: eval_protocol_fixtures' defaults
PROTOCOL_SEEDS = {"synth": 7, "xgen": 11}


def split_scenes(curriculum: str, n: int, hw: int, device, synth_fn=None, xgen_fn=None):
    """(training scenes, [(family, held-out scene), ...]) as the JAX tools
    make and split them; ``synth_fn`` and ``xgen_fn`` default to the
    port's ``train.synthetic_scenes`` and ``train.xgen_scenes``."""
    synth_fn = synth_fn or T.synthetic_scenes
    xgen_fn = xgen_fn or T.xgen_scenes
    if curriculum == "mixed":
        half = max(2, n // 2)
        synth = synth_fn(half, hw, hw, seed=0, device=device)
        xgen = xgen_fn(half, hw, hw, seed=100, device=device)
        return synth[:-1] + xgen[:-1], [("synth", synth[-1]), ("xgen", xgen[-1])]
    scenes = synth_fn(n, hw, hw, seed=0, device=device)
    return scenes[:-2], [("synth", scenes[-2]), ("synth_2", scenes[-1])]


def draw_chunk(rng: np.random.Generator, scenes: list, n: int, patch: int, batch: int):
    """``n`` batches drawn as the JAX tools draw them, stacked:
    (n, batch, patch, patch, 3) and (n, batch, patch, patch, 31)."""
    brs, bhs = [], []
    for _ in range(n):
        rgb, hsi = scenes[int(rng.integers(0, len(scenes)))]
        br, bh = T.sample_patches(rng, rgb, hsi, patch, batch)
        brs.append(br)
        bhs.append(bh)
    return np.stack(brs), np.stack(bhs)


def train_chunks(state, rng, scenes, args, t0: float, chunk: int, after_chunk=None) -> dict:
    """The JAX tools' loop: while fewer than ``args.steps`` steps are done
    and ``args.budget_s`` has not passed since ``t0``, a chunk of ``chunk``
    L1 steps; ``after_chunk(done)`` runs after each. Returns the steps
    done, every step's loss, each chunk's mean loss and its ms per step
    (the copy to the device and the steps, ended by reading the losses)."""
    step = T.make_train_step("l1")
    device = next(state.model.parameters()).device
    done, losses, chunk_loss, chunk_ms = 0, [], [], []
    while done < args.steps and time.time() - t0 < args.budget_s:
        brs, bhs = draw_chunk(rng, scenes, chunk, args.patch, args.batch)
        t_chunk = time.perf_counter()
        brs, bhs = torch.from_numpy(brs).to(device), torch.from_numpy(bhs).to(device)
        values = []
        for i in range(chunk):
            state, m = step(state, brs[i], bhs[i])
            values.append(m["loss"])
        values = torch.stack(values).tolist()
        chunk_ms.append((time.perf_counter() - t_chunk) * 1e3 / chunk)
        done += chunk
        losses += values
        chunk_loss.append(float(np.mean(values)))
        print(f"  step {done}: loss {values[-1]:.4f} ({time.time() - t0:.0f}s)", flush=True)
        if after_chunk is not None:
            after_chunk(done)
    return {"steps": done, "losses": losses, "chunk_loss": chunk_loss, "chunk_ms_per_step": chunk_ms,
            "ms_per_step_median": float(np.median(chunk_ms)) if chunk_ms else None}


def protocols(apply_fn, device) -> tuple[str, dict]:
    """(route, {family: MRAE / RMSE / PSNR}) of the eval protocol on both
    scene families: through ``.jpg``/``.mat`` files
    (``quality.eval_protocol_fixtures``) where cv2 and h5py import, else in
    memory (``quality.eval_protocol_in_memory``: the RGB rounded to uint8,
    no JPEG round trip), which this prints."""
    route = quality.protocol_route()
    if route == "in_memory":
        print("eval protocol scored in memory: cv2 or h5py cannot be imported here, so the scenes' RGB is "
              "rounded to uint8 with no JPEG round trip and no .mat file", flush=True)
    score = quality.eval_protocol_fixtures if route == "files" else quality.eval_protocol_in_memory
    n, hw = PROTOCOL
    out = {}
    for family, scene_fn in (("synth", T.synthetic_scenes), ("xgen", T.xgen_scenes)):
        out[family] = score(apply_fn, n_scenes=n, hw=hw, seed=PROTOCOL_SEEDS[family], scene_fn=scene_fn,
                            device=device)
    return route, out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="train MST++ on the synthetic curriculum")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--budget-s", type=float, default=1500.0)
    ap.add_argument("--patch", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--scenes", type=int, default=24)
    ap.add_argument("--scene-hw", type=int, default=160)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default=str(SHIPPED))
    ap.add_argument("--curriculum", choices=("synth", "mixed"), default="mixed")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    t0 = time.time()
    print("generating scenes...", flush=True)
    train_scenes, held = split_scenes(args.curriculum, args.scenes, args.scene_hw, device)
    opt = T.make_optimizer(lr=args.lr, total_steps=args.steps, warmup=max(10, args.steps // 50))
    state = T.init_state(MSTPlusPlus(), opt, seed=0, device=device)
    apply_fn = meval.model_apply_fn(state.model)
    held_log = []

    def eval_held(done: int) -> None:
        scores = {family: meval.validate(apply_fn, [scene], crop=0) for family, scene in held}
        held_log.append({"step": done, **scores})
        psnr, mrae = (float(np.mean([s[k] for s in scores.values()])) for k in ("psnr", "mrae"))
        print(f"  held-out: psnr {psnr:.2f} mrae {mrae:.4f} ("
              + ", ".join(f"{f} {s['psnr']:.2f} dB" for f, s in scores.items()) + f"; step {done})", flush=True)

    def after_chunk(done: int) -> None:
        if done % EVAL_EVERY == 0 or done >= args.steps:
            eval_held(done)

    eval_held(0)
    print(f"setup {time.time() - t0:.0f}s; training...", flush=True)
    t_train = time.time()
    run = train_chunks(state, np.random.default_rng(1), train_scenes, args, t0, CHUNK, after_chunk)
    train_s = time.time() - t_train

    final = {}
    for family, scene in held:
        final[family] = meval.validate(apply_fn, [scene], crop=0)
        print(f"final held-out [{family}] psnr {final[family]['psnr']:.2f} dB", flush=True)

    route, proto = protocols(apply_fn, device)
    for family, scores in proto.items():
        print(f"eval protocol ({family}): {scores}", flush=True)

    out = os.path.abspath(args.out)
    export.save_checkpoint(out, state)
    print(f"saved {out}", flush=True)
    result = {"device": str(device), "curriculum": args.curriculum, "out": out, "protocol": route,
              "eval_protocol": proto, "held_out": final, "held_out_log": held_log, "train_s": train_s,
              "wall_s": time.time() - t0, **run}
    print(json.dumps({k: v for k, v in result.items() if k not in ("losses", "held_out_log")}), flush=True)
    return result


if __name__ == "__main__":
    main()
