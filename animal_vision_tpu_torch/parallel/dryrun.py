"""The multi-device dry run: every parallel path once, on ranks that are processes.

Counterpart of the JAX ``__graft_entry__.py`` (``entry``, and
``dryrun_multichip``, ``:20-215``):

    python -m animal_vision_tpu_torch.parallel.dryrun --ranks 4 --device cuda

``dryrun_multichip(n, device)`` starts ``n`` ranks (``launch.spawn``) and
runs, in order on every rank: one MST++ train step on a dp x sp x tp mesh;
MST++'s stages as an n-slot pipeline against the unsharded forward; the
species fleet (dog, pig, rat, lion, on rank 0's process); the sp-sharded
256x512 forward; the band path on an sp x tp mesh; then goldfish whose
HSI provider is the sharded forward, 6 frames of 128x128 streamed through
``StreamingExecutor`` on every rank (the same frames in the same order,
so every rank reaches the collectives alike) against goldfish with the
unsharded provider, one 100x130 frame (no bucket path: the provider sees
goldfish's quarter-scale frame, padded to a multiple of 8 rows, on the
band path or whole as ``supports`` decides; the line names each) and one
300x400 frame under
``ANIMAL_VISION_MAX_PIXELS=50000`` (the degradation ladder). It prints one
summary line and returns it. With 2 ranks on one card the ranks share it
(gloo, host-staged transport).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from animal_vision_tpu_torch.species import resolve_device

#: the bars of the JAX dry run (MST++ forwards, max abs) and the LSB bar of the species
FORWARD_TOL = 1e-3
LSB_TOL = 1
FLEET = ("dog", "pig", "rat", "lion")


def entry(device: str | torch.device | None = None):
    """``(fn, (example,))``: the MST++ forward with the shipped weights on
    ``device`` (the card when None) and a (1, 128, 128, 3) frame."""
    from animal_vision_tpu_torch.models.mst_plus_plus import load_shipped

    device = resolve_device(device)
    model = load_shipped(device)

    def fn(x):
        with torch.no_grad():
            return model(x)

    example = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 128, 128, 3)).astype(np.float32))
    return fn, (example.to(device),)


def _max_lsb(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def _err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def _rank_run(device: torch.device, n: int) -> dict:
    """One rank's dry run; returns its readings (rank 0's are printed)."""
    import torch.distributed as dist

    from animal_vision_tpu_torch.models import train as mtrain
    from animal_vision_tpu_torch.models.mst_plus_plus import MSTPlusPlus, load_shipped
    from animal_vision_tpu_torch.models.providers import MST_LAMBDAS, attach_mst, make_mst_hsi_provider
    from animal_vision_tpu_torch.parallel import make_mesh, sharded_inference_fn
    from animal_vision_tpu_torch.parallel.fleet import render_fleet
    from animal_vision_tpu_torch.parallel.fused_shard import fused_sharded_forward, supports
    from animal_vision_tpu_torch.parallel.pipeline import make_pp_mesh, mst_plus_plus_pp_forward
    from animal_vision_tpu_torch.pipeline import StreamingExecutor
    from animal_vision_tpu_torch.species.uv.goldfish import Goldfish

    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)
    out: dict = {"rank": dist.get_rank(), "device": str(device)}

    # dp x sp x tp train step (sp 2 when n is even, tp 2 when n splits by 4)
    sp = 2 if n % 2 == 0 else 1
    tp = 2 if n % (sp * 2) == 0 else 1
    mesh = make_mesh(sp=sp, tp=tp)
    dp = n // (sp * tp)
    opt = mtrain.make_optimizer(total_steps=100, warmup=2)
    state = mtrain.init_state(MSTPlusPlus(), opt, seed=0, device=device)
    step, place = mtrain.make_sharded_train_step(mesh, opt)
    state = place(state)
    batch = max(2, dp) * 2
    rgb = rng.uniform(0, 1, (batch, 32, 32, 3)).astype(np.float32)
    hsi = rng.uniform(0.05, 1, (batch, 32, 32, 31)).astype(np.float32)
    state, metrics = step(state, rgb, hsi)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"train step loss {loss}")
    out.update(mesh=(dp, sp, tp), step=state.step, loss=loss, psnr=float(metrics["psnr"]))
    del state

    # pp: MST++'s 3 stages over n slots (identity slots past the third)
    model = load_shipped(device)
    x = torch.from_numpy(rng.uniform(0, 1, (n, 16, 16, 3)).astype(np.float32)).to(device)
    with torch.no_grad():
        got = mst_plus_plus_pp_forward(model, make_pp_mesh(n), x, n_micro=n)
        out["pp_err"] = _err(got, model(x))

    # ep analogue: the species fleet, one process
    frame = rng.integers(0, 255, (32, 48, 3)).astype(np.uint8)
    if dist.get_rank() == 0:
        fleet = render_fleet(frame, FLEET, [device])
        if any(o.dtype != np.uint8 or o.shape != frame.shape for _, o in fleet.values()):
            raise AssertionError("fleet outputs are not uint8 frames")
        out["fleet"] = len(fleet)

    # sp-sharded 256x512 inference (sp 4 when n splits by 4)
    sp_n = 4 if n % 4 == 0 else sp
    bsp = max(1, n // sp_n)
    xs = torch.from_numpy(rng.uniform(0, 1, (bsp, 256, 512, 3)).astype(np.float32)).to(device)
    sp_mesh = make_mesh(sp=sp_n, tp=1)
    with torch.no_grad():
        out["sp_err"] = _err(sharded_inference_fn(sp_mesh, model)(xs), model(xs))

    # the band path on an sp x tp mesh
    fsp = 2 if n % 2 == 0 else 1
    ftp = 2 if n % 4 == 0 else 1
    fmesh = make_mesh(sp=fsp, tp=ftp)
    fdp = n // (fsp * ftp)
    xf = torch.from_numpy(rng.uniform(0, 1, (fdp, 48, 64, 3)).astype(np.float32)).to(device)
    if not supports(fmesh, fdp, 48, 64):
        raise AssertionError("48x64 must take the band path")
    with torch.no_grad():
        out["fused_err"] = _err(fused_sharded_forward(fmesh, model, xf), model(xf))
    out["fused_mesh"] = (fsp, ftp)

    # UV + MST++ stream: goldfish with the sharded provider on every rank
    stp = 2 if n % (sp_n * 2) == 0 else 1
    smesh = make_mesh(sp=sp_n, tp=stp)
    srun = sharded_inference_fn(smesh, model)
    local = make_mst_hsi_provider(model, device=device)
    paths: list = []  # "HxW bands|whole" of each sharded provider call

    def sharded_provider(frames: torch.Tensor, plain: bool = False) -> torch.Tensor:
        x = torch.clamp(frames.to(torch.float32), 0.0, 1.0).reshape(-1, *frames.shape[-3:])
        if plain:
            cube = local(x, plain=True)
        else:
            b, h, w = x.shape[:3]
            paths.append(f"{h}x{w} {'bands' if supports(smesh, b, h, w) else 'whole'}")
            cube = srun(x)
        return torch.clamp(cube, min=0.0).reshape(*frames.shape[:-1], cube.shape[-1])

    gf_sharded = Goldfish(device).use_hsi_provider(sharded_provider, lambdas=MST_LAMBDAS)
    gf_single = attach_mst(Goldfish(device), model)
    # 128x128: the provider's quarter-scale 32x32 frames split into bands (at
    # JAX's 96x128 the 24x32 frames would run whole)
    stream = [rng.integers(0, 256, (128, 128, 3), dtype=np.uint8) for _ in range(6)]
    outs: list = []
    n_done = StreamingExecutor(gf_sharded, batch=2, split=False).run(iter(stream), outs.append)
    if n_done != len(stream):
        raise AssertionError(f"streamed {n_done} of {len(stream)} frames")
    out["stream_frames"] = n_done
    out["stream_lsb"] = max(_max_lsb(g, gf_single.visualize(f)[1]) for g, f in zip(outs, stream))

    out["stream_provider"] = sorted(set(paths))
    paths.clear()
    # an odd shape (no bucket path) and the ladder
    odd = rng.integers(0, 256, (100, 130, 3), dtype=np.uint8)
    out["odd_lsb"] = _max_lsb(gf_sharded.visualize(odd)[1], gf_single.visualize(odd)[1])
    out["odd_provider"] = sorted(set(paths))
    paths.clear()
    big = rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)
    os.environ["ANIMAL_VISION_MAX_PIXELS"] = "50000"
    try:
        got_lad, want_lad = gf_sharded.visualize(big)[1], gf_single.visualize(big)[1]
    finally:
        os.environ.pop("ANIMAL_VISION_MAX_PIXELS", None)
    if got_lad.shape != big.shape:
        raise AssertionError(f"ladder output {got_lad.shape}")
    out["ladder_lsb"] = _max_lsb(got_lad, want_lad)
    out["ladder_provider"] = sorted(set(paths))
    out["sp_n"], out["stp"] = sp_n, stp

    bad = {k: out[k] for k in ("pp_err", "sp_err", "fused_err") if not out[k] < FORWARD_TOL}
    bad.update({k: out[k] for k in ("stream_lsb", "odd_lsb", "ladder_lsb") if out[k] > LSB_TOL})
    if bad:
        raise AssertionError(f"rank {out['rank']}: over the bars: {bad}")
    return out


def summary_line(r: dict, n: int) -> str:
    dp, sp, tp = r["mesh"]
    fsp, ftp = r["fused_mesh"]
    return (f"dryrun_multichip ok: {n} ranks on {r['device']}, mesh dp={dp} sp={sp} tp={tp}, step={r['step']}, "
            f"loss={r['loss']:.4f}, psnr={r['psnr']:.2f}, pp={n}-slot pipeline maxerr={r['pp_err']:.2e}, "
            f"ep fleet={r['fleet']} species, sp{r['sp_n']} 256x512 inference maxerr={r['sp_err']:.2e}, "
            f"band path (sp{fsp}xtp{ftp} bands) maxerr={r['fused_err']:.2e}, "
            f"UV+MST stream (sp{r['sp_n']}xtp{r['stp']} provider, {r['stream_frames']} frames via executor) "
            f"maxdiff={r['stream_lsb']} LSB (provider {', '.join(r['stream_provider'])}), "
            f"sharded-provider odd shape (100x130) maxdiff={r['odd_lsb']} LSB (provider {', '.join(r['odd_provider'])}), "
            f"ladder(300x400->50kpx budget) maxdiff={r['ladder_lsb']} LSB (provider {', '.join(r['ladder_provider'])})")


def dryrun_multichip(n_devices: int, device: str | torch.device | None = None, timeout: float = 600.0) -> str:
    """Run the dry run on ``n_devices`` ranks on ``device`` (the card when
    None); print and return the summary line. Raises if a rank fails or a
    reading is over its bar."""
    from animal_vision_tpu_torch.parallel.launch import spawn

    device = resolve_device(device)
    results = spawn(_rank_run, n_devices, device, timeout=timeout, n=n_devices)
    line = summary_line(results[0], n_devices)
    print(line, flush=True)
    return line


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Every multi-device path once, on ranks that are processes.")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds the whole run may take")
    args = ap.parse_args(argv)
    dryrun_multichip(args.ranks, args.device, args.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
