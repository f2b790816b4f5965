"""Fine-tune MST++ weights on the mixed curriculum; swap them in only if
they clear both quality gates.

Counterpart of ``tools/finetune_mixed.py``, with its flags and defaults
and ``--device`` (the card unless ``cpu``): the parameters (never the
schedule count, which would pin the rate at the end of a finished run's
cosine) are warm-started from ``--src``; then Adam with
``make_optimizer(lr, steps, warmup=max(10, steps // 20))`` and the L1
loss over both scene families (``train_synth.split_scenes("mixed", ...)``),
in chunks of ``CHUNK`` draws from ``np.random.default_rng(7)``, within
``--budget-s``; the eval protocol on both families before and after
(``train_synth.protocols``). The candidate is saved beside ``--src`` as
``synth_v1_mixed_candidate.pt`` and replaces ``--src`` only if its xgen
PSNR >= ``--min-xgen`` and its synth PSNR >= ``--min-synth`` on the
``.jpg``/``.mat`` protocol. A protocol scored in memory (a host without
cv2 or h5py: no JPEG round trip) never swaps, and the tool says so.

Usage:
    python -m animal_vision_tpu_torch.tools.finetune_mixed [--steps 600] [--budget-s 420] \\
        [--src PATH] [--device cpu]

The default ``--src`` is the shipped ``models/pretrained/synth_v1.pt``, as
the JAX tool's is its shipped checkpoint.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from animal_vision_tpu_torch.models import eval as meval
from animal_vision_tpu_torch.models import export
from animal_vision_tpu_torch.models import train as T
from animal_vision_tpu_torch.models.mst_plus_plus import SHIPPED, MSTPlusPlus, load_state
from animal_vision_tpu_torch.species import resolve_device
from animal_vision_tpu_torch.tools.train_synth import protocols, split_scenes, train_chunks

CHUNK = 50
CANDIDATE = "synth_v1_mixed_candidate.pt"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="fine-tune MST++ on the mixed curriculum behind quality gates")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--budget-s", type=float, default=420.0)
    ap.add_argument("--patch", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--scenes", type=int, default=24)
    ap.add_argument("--scene-hw", type=int, default=160)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--src", default=str(SHIPPED))
    ap.add_argument("--min-xgen", type=float, default=30.0)
    ap.add_argument("--min-synth", type=float, default=37.0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    t0 = time.time()
    print("generating mixed scenes...", flush=True)
    train_scenes, _ = split_scenes("mixed", args.scenes, args.scene_hw, device)
    opt = T.make_optimizer(lr=args.lr, total_steps=args.steps, warmup=max(10, args.steps // 20))
    state = T.init_state(MSTPlusPlus(), opt, seed=0, device=device)
    src = os.path.abspath(args.src)
    state.model.load_state_dict(load_state(src))
    print(f"warm-started params from {src} ({time.time() - t0:.0f}s)", flush=True)
    apply_fn = meval.model_apply_fn(state.model)

    route, start = protocols(apply_fn, device)
    print(f"start: synth {start['synth']} xgen {start['xgen']}", flush=True)
    run = train_chunks(state, np.random.default_rng(7), train_scenes, args, t0, CHUNK)
    _, final = protocols(apply_fn, device)
    print(f"final: synth {final['synth']} xgen {final['xgen']}", flush=True)

    cand = os.path.join(os.path.dirname(src), CANDIDATE)
    export.save_checkpoint(cand, state)
    print(f"candidate saved {cand}", flush=True)
    s1, x1 = final["synth"]["psnr"], final["xgen"]["psnr"]
    passed = x1 >= args.min_xgen and s1 >= args.min_synth
    swapped = passed and route == "files"
    if swapped:
        os.replace(cand, src)
        print(f"SWAPPED: {src} now holds the mixed fine-tune (synth {s1:.2f} dB, xgen {x1:.2f} dB)", flush=True)
    elif passed:
        print(f"KEPT {src}: the candidate (synth {s1:.2f}, xgen {x1:.2f} dB) was scored in memory, without the "
              "JPEG round trip the gates are set for, so it does not replace the weights", flush=True)
    else:
        print(f"KEPT {src} (candidate synth {s1:.2f}, xgen {x1:.2f} below gates "
              f"{args.min_synth}/{args.min_xgen})", flush=True)
    result = {"device": str(device), "src": src, "candidate": cand, "protocol": route, "start": start,
              "final": final, "gates_passed": passed, "swapped": swapped, "wall_s": time.time() - t0, **run}
    print(json.dumps({k: v for k, v in result.items() if k != "losses"}), flush=True)
    return result


if __name__ == "__main__":
    main()
