#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``animal_vision_tpu_torch`` on the card in phases, each of which
raises on failure:

1. device: card name, count, power limit; TF32 off for matrix products and
   convolutions (the cat's warp and zoom are full float32);
2. build: compiles every ``csrc/*.cu`` kernel library (one nvcc per source,
   all at once) and prints ptxas' register and shared-memory report;
3. kernels: every kernel of the main path against its plain PyTorch version
   on the card at 1080x1920 and 721x1283: the three non-UV kernels on two
   random frames plus a frame of 0/1 values (so both branches of the
   per-frame scale run), <= 1 LSB; the UV blur on 3 float32 frames in
   [0, 1] with 1 or 3 channels and ksize 3..37, <= 1e-5; the four MST++
   kernels at the three levels of a 1080x1920 frame and of 4 frames of
   272x480 (kestrel's and goldfish's 0.25-scale operating point), random
   weights of scale 0.2: conv and up_fuse <= 1e-4, stats <= 1e-5 of max |G|,
   apply <= 5e-4; MST-L's FFN kernel at the same levels and at 721x1283
   with C = 31, weights of scale 0.2, <= 1e-4; then each kernel's time
   (CUDA events), its plain version's time, its bound, and a library
   reference for the UV blur (reflect pad + two depthwise convolutions)
   and the MST++ convolution (``F.conv2d`` on channels-last tensors);
4. main path: ``get_animal(name).visualize(frame)`` and
   ``visualize_batch_device`` (4 frames already on the card) at 1080p, first
   for the 20 non-UV species, then for the ported UV species, with the
   launch counters set to 0 before and read after each of the two runs;
   each non-UV species against its plain composition on the card (<= 1 LSB)
   and against the CPU path on a small frame (<= 1 LSB), each UV species
   the same at >= 40 dB PSNR with its baseline within 1 LSB; then fps per
   species and each group's harmonic mean; then MST++ with the shipped
   weights: one 1080p forward, kestrel and goldfish with ``attach_mst``
   through both entry points and honeybee with the provider on a 1080p
   frame, counters around the run (14 conv, 15 stats, 15 apply, 6 up_fuse
   launches per forward), each against its plain version on the card
   (forward < 5e-4, species >= 40 dB, baselines <= 1 LSB), ms and fps;
   then MST-L (the zoo's ``"mst"``) with weights made from a seed: one
   1080p forward, kestrel and mantis shrimp with ``attach_model(..., "mst")``
   and mantis shrimp with ``attach_mst``, through both entry points,
   counters around the run (27 ``ffn`` launches per MST-L forward), each
   against its plain version on the card (forward within 5e-4 of max |y|,
   species >= 40 dB, baselines <= 1 LSB), ms and fps;
5. profile: ``torch.profiler`` device time by name beside the host-clock
   time for one non-UV species per kernel, the cat and the UV species,
   through each entry point, the 1080p MST++ forward, kestrel with MST++,
   the 1080p MST-L forward and mantis shrimp with MST-L;
6. summary: one JSON line with each kernel, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device. A detailed
report goes to ``chiprun_out/chip_smoke_report.json``.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 20261016
SHAPES = ((1080, 1920), (721, 1283))
MAIN_HW = (1080, 1920)
BATCH = 4
SMALL_HW = (64, 96)
TOL_LSB = 1
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, device memory
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
KERNEL_REPS = 100
PLAIN_REPS = 5
MAIN_REPS = 100
BLUR_KSIZES = (3, 7, 9, 13, 19, 37)
BLUR_CHANNELS = (1, 3)
BLUR_TOL = 1e-5  # max abs error on [0, 1] data
BLUR_REPS = 20
BLUR_PLAIN_REPS = 2
BLUR_REPRESENTATIVE = (19, 3)  # (ksize, C): kestrel's structure tensor at 1080p
UV_REPS = 10
UV_MIN_DB = 40.0
# one non-UV species per kernel, the cat's products, and the UV species
PROFILE_SPECIES = ("dog", "deer", "rat", "cat", "honeybee", "reindeer", "goldfish", "kestrel")
PROFILE_REPS = 5
# MST++: (padded frame, frames per call) of the two operating points
MST_POINTS = {"1080p": ((1080, 1920), 1), "272x480": ((272, 480), BATCH)}
MST_KERNEL_REPS = 10
MST_PLAIN_REPS = 2
MST_TOL = {"conv_kernel": 1e-4, "up_fuse_kernel": 1e-4, "msab_apply_kernel": 5e-4}
MST_STATS_REL_TOL = 1e-5  # of max |G|
MST_FORWARD_TOL = 5e-4
MST_FORWARD_REPS = 10
MST_SPECIES_REPS = 5
MST_PER_FORWARD = {"conv_kernel": 14, "attn_stats_kernel": 15, "msab_apply_kernel": 15, "up_fuse_kernel": 6}
# the 1080p case of each MST++ kernel that the summary line reports
MST_REPRESENTATIVE = {"conv_kernel": "31->31 k3", "attn_stats_kernel": "C=31", "msab_apply_kernel": "C=31",
                      "up_fuse_kernel": "62->31"}
# MST-L's FFN: (point, frames, h, w, C) of each case; the first two points'
# three levels, then 721x1283 at C = 31
FFN_CASES = tuple((point, n, h >> lvl, w >> lvl, c) for point, ((h, w), n) in MST_POINTS.items()
                  for lvl, c in enumerate((31, 62, 124))) + (("721x1283", 1, 721, 1283, 31),)
FFN_TOL = 1e-4
MSTL_FORWARD_REL_TOL = 5e-4  # of max |y|: the seeded model's output reaches the hundreds
MSTL_FORWARD_REPS = 5
MSTL_PER_FORWARD = 27
SOURCES = {
    "iso_u8": "animal_vision_tpu_torch/csrc/fused_nonuv.cu",
    "streak_u8": "animal_vision_tpu_torch/csrc/fused_nonuv.cu",
    "pointwise_u8": "animal_vision_tpu_torch/csrc/fused_nonuv.cu",
    "blur_uv": "animal_vision_tpu_torch/csrc/fused_blur.cu",
    "conv_kernel": "animal_vision_tpu_torch/csrc/fused_msab.cu",
    "attn_stats_kernel": "animal_vision_tpu_torch/csrc/fused_msab.cu",
    "msab_apply_kernel": "animal_vision_tpu_torch/csrc/fused_msab.cu",
    "up_fuse_kernel": "animal_vision_tpu_torch/csrc/fused_msab.cu",
    "ffn_kernel": "animal_vision_tpu_torch/csrc/fused_mst.cu",
}
REPLACES = {
    "iso_u8": "animal_vision_tpu/ops/fused_nonuv.py:199",
    "streak_u8": "animal_vision_tpu/ops/fused_nonuv.py:335",
    "pointwise_u8": "animal_vision_tpu/ops/fused_nonuv.py:530",
    "blur_uv": "animal_vision_tpu/ops/fused_blur.py:68",
    "conv_kernel": "animal_vision_tpu/ops/fused_msab.py:636",
    "attn_stats_kernel": "animal_vision_tpu/ops/fused_msab.py:192",
    "msab_apply_kernel": "animal_vision_tpu/ops/fused_msab.py:293",
    "up_fuse_kernel": "animal_vision_tpu/ops/fused_msab.py:848",
    "ffn_kernel": "animal_vision_tpu/ops/fused_mst.py:54",
}
REPORT = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke_report.json"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, device: torch.device, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls after
    ``warmup``; CUDA events on the card."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def max_lsb(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int16) - b.to(torch.int16)).abs().max().item())


def psnr_db(a: torch.Tensor, b: torch.Tensor) -> float:
    """PSNR of two uint8 images, in dB (inf when equal)."""
    mse = ((a.to(torch.float64) - b.to(torch.float64).to(a.device)) / 255.0).pow(2).mean().item()
    return float("inf") if mse == 0 else float(10.0 * np.log10(1.0 / mse))


def reset_counters() -> None:
    from animal_vision_tpu_torch.ops import fused_blur as B
    from animal_vision_tpu_torch.ops import fused_msab as M
    from animal_vision_tpu_torch.ops import fused_mst as T
    from animal_vision_tpu_torch.ops import fused_nonuv as F

    F.reset_launches()
    B.reset_launches()
    M.reset_launches()
    T.reset_launches()


def counters() -> dict:
    from animal_vision_tpu_torch.ops import fused_blur as B
    from animal_vision_tpu_torch.ops import fused_msab as M
    from animal_vision_tpu_torch.ops import fused_mst as T
    from animal_vision_tpu_torch.ops import fused_nonuv as F

    return {**F.LAUNCHES, **B.LAUNCHES, **M.LAUNCHES, **T.LAUNCHES}


@contextlib.contextmanager
def plain_forbidden_on_cuda():
    """Make every plain kernel version raise if a CUDA tensor reaches it."""
    from animal_vision_tpu_torch.ops import fused_blur as B
    from animal_vision_tpu_torch.ops import fused_msab as M
    from animal_vision_tpu_torch.ops import fused_mst as T
    from animal_vision_tpu_torch.ops import fused_nonuv as F

    names = ((F, "iso_u8_plain"), (F, "streak_u8_plain"), (F, "pointwise_u8_plain"), (B, "blur_uv_plain"),
             (M, "conv_plain"), (M, "attn_stats_plain"), (M, "msab_apply_plain"), (M, "up_fuse_plain"),
             (T, "ffn_plain"))
    saved = {n: getattr(mod, n) for mod, n in names}

    def guard(name, fn):
        def wrapped(img, *args, **kwargs):
            if img.is_cuda:
                raise AssertionError(f"{name} reached with a CUDA tensor")
            return fn(img, *args, **kwargs)
        return wrapped

    for mod, n in names:
        setattr(mod, n, guard(n, saved[n]))
    try:
        yield
    finally:
        for mod, n in names:
            setattr(mod, n, saved[n])


# ---------------------------------------------------------------------------
# Phases 1 and 2
# ---------------------------------------------------------------------------


def device_phase() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "card": card_line(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    log(f"[device] {info['kind']} x{info['count']}; nvidia-smi: {info['card']}")
    log(f"[device] torch {info['torch']} cuda {info['cuda']}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return info


def build_phase() -> dict:
    from animal_vision_tpu_torch.ops import _build

    t0 = time.perf_counter()
    reports = _build.build_all()
    seconds = time.perf_counter() - t0
    log(f"[build] {sorted(reports)} in {seconds:.2f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "ptxas info" in line and ("Compiling entry" in line or "Used" in line) or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    return {"seconds": seconds}


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_cases(h: int, w: int, device: torch.device, rng) -> list[dict]:
    """The main path's kernel calls at (h, w): 2 random frames + 1 frame of
    0/1 values per case, with the bytes and operations each call needs."""
    from animal_vision_tpu_torch.core import color
    from animal_vision_tpu_torch.ops import fused_nonuv as F
    from animal_vision_tpu_torch.species.nonuv import NONUV_SPECS, Cat

    def frames():
        x = np.concatenate([
            rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8),
            rng.integers(0, 2, (1, h, w, 3), dtype=np.uint8),
        ])
        return torch.from_numpy(x).to(device)

    def table(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    n = 3
    px = n * h * w
    io_bytes = px * 3 * 2
    cases = []

    def iso(name, mat, sigma, as_float):
        params = table(F.iso_params(mat, sigma))
        ksize = params.numel() - 9
        if as_float:
            ins = [(frames().to(torch.float32) / 255.0).contiguous() for _ in range(3)]
            scale = torch.ones(n, dtype=torch.float32, device=device)
            scales = [scale] * 3
        else:
            ins = [frames() for _ in range(3)]
            scales = [F.scale_of(x) for x in ins]
        cases.append(dict(
            name=name, kernel="iso_u8", ins=ins, scales=scales,
            run=lambda x, s: F.iso_u8(x, s, params), plain=lambda x, s: F.iso_u8_plain(x, s, params),
            bytes=px * 3 * (ins[0].element_size() + 1) + params.numel() * 4,
            ops=px * (18 + 12 * ksize + 6),
        ))

    def streak(name, chroma):
        spec = NONUV_SPECS[name]
        tab_np, mix_np, r = F.streak_tables(h, spec.effects[0].params, spec.alpha, spec.s_scale)
        tab, mix = table(tab_np), table(mix_np)
        radii = (tab_np != 0).sum(axis=1) - 1  # each row's own half width
        row_ops = 3 * (1 + 3 * radii) + 18 + (9 if chroma else 0) + 6
        ins = [frames() for _ in range(3)]
        cases.append(dict(
            name=f"{name} r={r}" + (f" chroma={chroma}" if chroma else ""), kernel="streak_u8",
            ins=ins, scales=[F.scale_of(x) for x in ins],
            run=lambda x, s: F.streak_u8(x, s, tab, mix, chroma),
            plain=lambda x, s: F.streak_u8_plain(x, s, tab, mix, chroma),
            bytes=io_bytes + (tab.numel() + mix.numel()) * 4,
            ops=int(n * w * row_ops.sum()),
        ))

    def pointwise(name, scone):
        spec = NONUV_SPECS[name]
        mat9 = table(color.collapse_lms_matrix(spec.alpha, spec.s_scale).reshape(9))
        gain = table(F.scone_gain(h, scone)) if scone else None
        ins = [frames() for _ in range(3)]
        cases.append(dict(
            name=name + (" gain" if scone else ""), kernel="pointwise_u8",
            ins=ins, scales=[F.scale_of(x) for x in ins],
            run=lambda x, s: F.pointwise_u8(x, s, mat9, gain),
            plain=lambda x, s: F.pointwise_u8_plain(x, s, mat9, gain),
            bytes=io_bytes + 36 + (h * 4 if scone else 0),
            ops=px * (18 + (1 if scone else 0) + 6),
        ))

    for name in ("dog", "lion"):
        spec = NONUV_SPECS[name]
        iso(name, color.collapse_lms_matrix(spec.alpha, spec.s_scale), spec.effects[0].params[0], False)
    iso("cat f32", Cat._merge_matrix().astype(np.float32), Cat.BLUR_SIGMA, True)
    streak("deer", None)
    streak("rabbit", NONUV_SPECS["rabbit"].effects[1].params[0])
    pointwise("pig", None)
    pointwise("rat", NONUV_SPECS["rat"].effects[0].params)
    return cases


def kernels_phase(device: torch.device, shapes=SHAPES, kernel_reps=KERNEL_REPS,
                  plain_reps=PLAIN_REPS) -> list[dict]:
    from animal_vision_tpu_torch.ops import fused_nonuv as F

    rng = np.random.default_rng(SEED)
    rows = []
    for h, w in shapes:
        for case in kernel_cases(h, w, device, rng):
            errs = [max_lsb(case["run"](x, s), case["plain"](x, s)) for x, s in zip(case["ins"], case["scales"])]
            sync(device)
            err = max(errs)
            if err > TOL_LSB:
                raise AssertionError(f"{case['kernel']} {case['name']} {h}x{w}: {err} LSB from its plain version")
            before = F.LAUNCHES[case["kernel"]]
            it = itertools.count()

            def kernel_call(case=case, it=it):
                i = next(it) % 3  # rotate 3 inputs: more than the L2 cache holds
                case["run"](case["ins"][i], case["scales"][i])

            ms = time_ms(kernel_call, kernel_reps, device)
            if device.type == "cuda" and F.LAUNCHES[case["kernel"]] == before:
                raise AssertionError(f"{case['kernel']} did not launch")
            plain_ms = time_ms(lambda case=case: case["plain"](case["ins"][0], case["scales"][0]),
                               plain_reps, device, warmup=1)
            bound_s = max(case["bytes"] / HBM_BYTES_PER_S, case["ops"] / F32_OPS_PER_S)
            row = dict(
                kernel=case["kernel"], case=case["name"], h=h, w=w, frames=3, max_lsb=err,
                ms=ms, plain_ms=plain_ms, bound_ms=bound_s * 1e3,
                bound_by="bytes" if case["bytes"] / HBM_BYTES_PER_S >= case["ops"] / F32_OPS_PER_S else "operations",
                bytes=case["bytes"], ops=case["ops"],
            )
            rows.append(row)
            log(f"[kernel] {row['kernel']:<13} {row['case']:<24} {h}x{w}x3 frames: "
                f"max {err} LSB, {ms:.4f} ms (plain {plain_ms:.3f} ms, bound {row['bound_ms']:.4f} ms "
                f"by {row['bound_by']}, {row['bound_ms'] / ms:.1%} of bound)")
            del case["ins"], case["scales"]
    return rows


def blur_phase(device: torch.device, shapes=SHAPES, ksizes=BLUR_KSIZES, channels=BLUR_CHANNELS,
               reps=BLUR_REPS, plain_reps=BLUR_PLAIN_REPS) -> list[dict]:
    """``blur_uv`` against ``blur_uv_plain``: 3 frames per launch, rotated
    over three copies; time, plain time, bound, and a library reference:
    ``F.pad(mode="reflect")`` and two depthwise ``F.conv2d`` (cuDNN, TF32
    off) on the same frames in NCHW, where the pad is below the frame size."""
    import torch.nn.functional as nnf

    from animal_vision_tpu_torch.core import blur
    from animal_vision_tpu_torch.ops import fused_blur as B

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    rows = []
    for h, w in shapes:
        for c in channels:
            ins = [torch.rand((3, h, w, c), generator=gen, device=device) for _ in range(3)]
            for k in ksizes:
                sigma = (k - 1) / 6.0
                if blur.uv_ksize(sigma) != k:
                    raise AssertionError(f"sigma {sigma} does not give ksize {k}")
                taps = blur.uv_taps(sigma, str(device))
                err = max((B.blur_uv(x, taps) - B.blur_uv_plain(x, taps)).abs().max().item() for x in ins)
                if not err <= BLUR_TOL:
                    raise AssertionError(f"blur_uv {h}x{w} C={c} k={k}: {err} from its plain version")
                before = B.LAUNCHES["blur_uv"]
                it = itertools.count()
                ms = time_ms(lambda: B.blur_uv(ins[next(it) % 3], taps), reps, device)
                if device.type == "cuda" and B.LAUNCHES["blur_uv"] == before:
                    raise AssertionError("blur_uv did not launch")
                plain_ms = time_ms(lambda: B.blur_uv_plain(ins[0], taps), plain_reps, device, warmup=1)
                r = k // 2
                library_ms = library_err = None
                if r < h and r < w:
                    nchw = ins[0].permute(0, 3, 1, 2).contiguous()
                    w_x = taps.view(1, 1, 1, k).expand(c, 1, 1, k).contiguous()
                    w_y = taps.view(1, 1, k, 1).expand(c, 1, k, 1).contiguous()

                    def library(nchw=nchw, w_x=w_x, w_y=w_y, r=r, c=c):
                        padded = nnf.pad(nchw, (r, r, r, r), mode="reflect")
                        return nnf.conv2d(nnf.conv2d(padded, w_x, groups=c), w_y, groups=c)

                    library_err = (library().permute(0, 2, 3, 1) - B.blur_uv_plain(ins[0], taps)).abs().max().item()
                    library_ms = time_ms(library, reps, device)
                    del nchw
                elems = 3 * h * w * c
                nbytes, ops = 2 * 4 * elems + 4 * k, 2 * 2 * k * elems
                bound_s = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
                row = dict(
                    kernel="blur_uv", case=f"C={c} k={k}", ksize=k, channels=c, h=h, w=w, frames=3,
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, library_max_abs_err=library_err,
                    bound_ms=bound_s * 1e3, bytes=nbytes, ops=ops,
                    bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations",
                )
                rows.append(row)
                lib = "n/a" if library_ms is None else f"{library_ms:.4f} ms"
                log(f"[kernel] blur_uv       {row['case']:<24} {h}x{w} 3 frames: max err {err:.3g}, {ms:.4f} ms "
                    f"(plain {plain_ms:.3f} ms, library {lib}, bound {row['bound_ms']:.4f} ms by {row['bound_by']}, "
                    f"{row['bound_ms'] / ms:.1%} of bound)")
            del ins
    return rows


def mst_kernel_cases(hw: tuple[int, int], n: int, device: torch.device, gen) -> list[dict]:
    """The MST++ kernel calls of one forward at a padded frame ``hw`` with
    ``n`` frames per call: inputs of scale 0.5 and weights of scale 0.2
    (``torch.randn`` on the card), with the bytes and float32 operations
    each call needs (a multiply-add is 2; each input read once, each output
    written once)."""
    import torch.nn.functional as nnf

    from animal_vision_tpu_torch.ops import fused_msab as M

    def randn(*shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    h, w = hw
    levels = [(h, w, 31), (h // 2, w // 2, 62), (h // 4, w // 4, 124)]
    cases = []

    def conv(name, lvl, cin, cout, k, residual):
        hh, ww, _ = levels[lvl]
        x, wt = randn(n, hh, ww, cin, scale=0.5), randn(k, k, cin, cout, scale=0.2)
        ho, wo = M.conv_out_hw(hh, ww, k)
        res = randn(n, ho, wo, cout, scale=0.5) if residual else None
        x_cl = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels-last
        w_cl = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        stride = 1 if k == 3 else 2

        def library():
            y = nnf.conv2d(x_cl, w_cl, stride=stride, padding=1)
            return y if res is None else y + res.permute(0, 3, 1, 2)

        out_px = n * ho * wo
        cases.append(dict(
            kernel="conv_kernel", case=name, run=lambda: M.conv(x, wt, res), plain=lambda: M.conv_plain(x, wt, res),
            library=library, library_out=lambda y: y.permute(0, 2, 3, 1),
            bytes=4 * (n * hh * ww * cin + out_px * cout * (2 if residual else 1) + wt.numel()),
            ops=out_px * cout * (2 * k * k * cin + (1 if residual else 0)),
        ))

    def stats(lvl):
        hh, ww, c = levels[lvl]
        x, wq, wk = randn(n, hh, ww, c, scale=0.5), randn(c, c, scale=0.2), randn(c, c, scale=0.2)
        px = n * hh * ww
        cases.append(dict(
            kernel="attn_stats_kernel", case=f"C={c}", run=lambda: M.attn_stats(x, wq, wk, c // 31),
            plain=lambda: M.attn_stats_plain(x, wq, wk, c // 31), library=None,
            bytes=4 * (px * c + 2 * c * c + n * (c * 31 + 2 * c)),
            ops=px * (2 * 2 * c * c + 2 * c * 31 + 2 * 2 * c),
        ))

    def apply(lvl):
        hh, ww, c = levels[lvl]
        x, m = randn(n, hh, ww, c, scale=0.5), randn(n, c, c, scale=0.2)

        def wt(*shape):
            return randn(*shape, scale=0.2)

        blk = M.MsabWeights(c // 31, wt(c, c), wt(c, c), wt(c, c), 1.0 + wt(c // 31), wt(c, c), wt(c), wt(3, 3, c),
                            wt(3, 3, c), 1.0 + wt(c), wt(c), wt(c, 4 * c), wt(3, 3, 4 * c), wt(4 * c, c))
        px = n * hh * ww
        weights = sum(t.numel() for t in blk[1:]) - 3 * c * c - c // 31  # wq, wk, wproj, rescale are unused
        cases.append(dict(
            kernel="msab_apply_kernel", case=f"C={c}", run=lambda: M.msab_apply(x, m, blk),
            plain=lambda: M.msab_apply_plain(x, m, blk), library=None,
            bytes=4 * (2 * px * c + n * c * c + weights),
            # x Wv, x M, W0, W4 products; the three depthwise 3x3s; GELU (1
            # each, 3 hidden-size passes of them), LayerNorm (about 8 per
            # channel) and the residual adds
            ops=px * (2 * c * c * 2 + 2 * 4 * c * c * 2 + 2 * 9 * (2 * c + 4 * c) + (c + 2 * 4 * c) + 8 * c + 4 * c),
        ))

    def up_fuse(lvl):
        hh, ww, c = levels[lvl]
        half = c // 2
        fea, skip = randn(n, hh, ww, c, scale=0.5), randn(n, 2 * hh, 2 * ww, half, scale=0.5)
        wup, bup, fuse = randn(c, 2, 2, half, scale=0.2), randn(2, 2, half, scale=0.2), randn(c, half, scale=0.2)
        out_px = n * 4 * hh * ww
        cases.append(dict(
            kernel="up_fuse_kernel", case=f"{c}->{half}", run=lambda: M.up_fuse(fea, skip, wup, bup, fuse),
            plain=lambda: M.up_fuse_plain(fea, skip, wup, bup, fuse), library=None,
            bytes=4 * (n * hh * ww * c + 2 * out_px * half + wup.numel() + bup.numel() + fuse.numel()),
            ops=out_px * half * (2 * c + 1) + out_px * 2 * c * half,
        ))

    conv("3->31 k3 (conv_in)", 0, 3, 31, 3, False)
    conv("31->31 k3", 0, 31, 31, 3, False)
    conv("31->31 k3 + residual", 0, 31, 31, 3, True)
    conv("31->62 k4 s2", 0, 31, 62, 4, False)
    conv("62->124 k4 s2", 1, 62, 124, 4, False)
    for lvl in range(3):
        stats(lvl)
        apply(lvl)
    up_fuse(2)
    up_fuse(1)
    return cases


def mst_error(kernel: str, got, want) -> tuple[float, float]:
    """(max abs error, the figure held to the kernel's tolerance): for the
    stats, the error of each output relative to its largest magnitude."""
    if kernel == "attn_stats_kernel":
        abs_err = max((a - b).abs().max().item() for a, b in zip(got, want))
        return abs_err, max((a - b).abs().max().item() / b.abs().max().item() for a, b in zip(got, want))
    err = (got - want).abs().max().item()
    return err, err


def mst_kernels_phase(device: torch.device, points=MST_POINTS, reps=MST_KERNEL_REPS,
                      plain_reps=MST_PLAIN_REPS) -> list[dict]:
    """Each MST++ kernel against its plain version on the same inputs; its
    time, the plain version's, its bound and, for the convolution, the
    library call's."""
    from animal_vision_tpu_torch.ops import fused_msab as M

    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    rows = []
    for point, (hw, n) in points.items():
        for case in mst_kernel_cases(hw, n, device, gen):
            kernel = case["kernel"]
            got, want = case["run"](), case["plain"]()
            sync(device)
            abs_err, err = mst_error(kernel, got, want)
            tol = MST_STATS_REL_TOL if kernel == "attn_stats_kernel" else MST_TOL[kernel]
            if not err <= tol:
                raise AssertionError(f"{kernel} {case['case']} at {point}: error {err} from its plain version "
                                     f"(tolerance {tol})")
            before = M.LAUNCHES[kernel]
            ms = time_ms(case["run"], reps, device)
            if device.type == "cuda" and M.LAUNCHES[kernel] == before:
                raise AssertionError(f"{kernel} did not launch")
            plain_ms = time_ms(case["plain"], plain_reps, device, warmup=1)
            library_ms = library_err = None
            if case["library"] is not None:
                library_err = (case["library_out"](case["library"]()) - want).abs().max().item()
                library_ms = time_ms(case["library"], reps, device)
            bound_s = max(case["bytes"] / HBM_BYTES_PER_S, case["ops"] / F32_OPS_PER_S)
            row = dict(
                kernel=kernel, case=case["case"], point=point, h=hw[0], w=hw[1], frames=n, max_abs_err=abs_err,
                err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, library_max_abs_err=library_err,
                bound_ms=bound_s * 1e3, bytes=case["bytes"], ops=case["ops"],
                bound_by="bytes" if case["bytes"] / HBM_BYTES_PER_S >= case["ops"] / F32_OPS_PER_S else "operations",
            )
            rows.append(row)
            lib = "" if library_ms is None else f", library {library_ms:.4f} ms (err {library_err:.2g})"
            log(f"[kernel] {kernel:<17} {case['case']:<22} {point:<7} x{n}: err {err:.3g} (abs {abs_err:.3g}), "
                f"{ms:.4f} ms (plain {plain_ms:.3f} ms{lib}, bound {row['bound_ms']:.4f} ms by {row['bound_by']}, "
                f"{row['bound_ms'] / ms:.1%} of bound)")
            del case, got, want
    return rows


def ffn_phase(device: torch.device, cases=FFN_CASES, reps=MST_KERNEL_REPS, plain_reps=MST_PLAIN_REPS) -> list[dict]:
    """MST-L's ``ffn`` against ``ffn_plain`` at the MST-L levels of the two
    operating points and at 721x1283: inputs of scale 0.5, weights of scale
    0.2 (``torch.randn`` on the card); its time, the plain version's, its
    bound (no one PyTorch call computes the FFN: no library time). A
    multiply-add is 2 operations; per pixel the two 1x1 maps 16 C^2, the
    depthwise 72 C, GELU 1 per hidden value twice (8 C), LayerNorm about 8
    per channel, the residual 1."""
    from animal_vision_tpu_torch.ops import fused_mst as T

    gen = torch.Generator(device=device).manual_seed(SEED + 9)

    def randn(*shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    rows = []
    for point, n, h, w, c in cases:
        x = randn(n, h, w, c, scale=0.5)
        ws = (1.0 + randn(c, scale=0.2), randn(c, scale=0.2), randn(c, 4 * c, scale=0.2), randn(3, 3, 4 * c, scale=0.2),
              randn(4 * c, c, scale=0.2))
        got, want = T.ffn(x, *ws), T.ffn_plain(x, *ws)
        sync(device)
        err = (got - want).abs().max().item()
        if not err <= FFN_TOL:
            raise AssertionError(f"ffn C={c} {h}x{w} x{n}: {err} from its plain version (tolerance {FFN_TOL})")
        del got, want
        before = T.LAUNCHES["ffn"]
        ms = time_ms(lambda: T.ffn(x, *ws), reps, device)
        if device.type == "cuda" and T.LAUNCHES["ffn"] == before:
            raise AssertionError("ffn_kernel did not launch")
        plain_ms = time_ms(lambda: T.ffn_plain(x, *ws), plain_reps, device, warmup=1)
        px = n * h * w
        nbytes = 4 * (2 * px * c + sum(t.numel() for t in ws))
        ops = px * (16 * c * c + 72 * c + 8 * c + 8 * c + c)
        bound_s = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
        row = dict(
            kernel="ffn_kernel", case=f"C={c}", point=point, h=h, w=w, frames=n, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, library_ms=None, bound_ms=bound_s * 1e3, bytes=nbytes, ops=ops,
            bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations",
            tile=list(T.tile_for(c, T.smem_limit(torch.cuda.current_device()))) if device.type == "cuda" else None,
        )
        rows.append(row)
        log(f"[kernel] ffn_kernel        {row['case']:<22} {h}x{w} x{n}: err {err:.3g}, {ms:.4f} ms (plain "
            f"{plain_ms:.3f} ms, bound {row['bound_ms']:.4f} ms by {row['bound_by']}, "
            f"{row['bound_ms'] / ms:.1%} of bound, tile {row['tile']})")
        del x, ws
    return rows


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------


def counted_run(animals: dict, host: np.ndarray, frames: torch.Tensor, device: torch.device):
    """The run the launch counters are read around: the counters set to 0,
    then once through each entry point per species (``host[0]`` through
    ``visualize``, ``frames`` through ``visualize_batch_device``) with the
    plain versions barred from CUDA tensors, then the counters read.
    Returns (launches per species, outputs per species, launches)."""
    per_species = {}
    outputs = {}
    with plain_forbidden_on_cuda():
        reset_counters()
        for name, animal in animals.items():
            before = counters()
            base1, out1 = animal.visualize(host[0])
            base_b, out_b = animal.visualize_batch_device(frames)
            per_species[name] = {k: v - before[k] for k, v in counters().items()}
            outputs[name] = (base1, out1, base_b, out_b)
        sync(device)
        return per_species, outputs, counters()


def expected_kernel(name: str) -> str:
    from animal_vision_tpu_torch.species.nonuv import NONUV_SPECS

    if name == "cat":
        return "iso_u8"
    kinds = tuple(e.kind for e in NONUV_SPECS[name].effects if e.enabled)
    return {"blur": "iso_u8", "streak": "streak_u8"}.get(kinds[0] if kinds else "", "pointwise_u8")


def main_path_phase(device: torch.device, hw=MAIN_HW, batch=BATCH, reps=MAIN_REPS,
                    small_hw=SMALL_HW) -> dict:
    from animal_vision_tpu_torch.species import NON_UV_NAMES, get_animal

    rng = np.random.default_rng(SEED + 1)
    h, w = hw
    host = rng.integers(0, 256, (batch, h, w, 3), dtype=np.uint8)
    frames = torch.from_numpy(host).to(device)
    animals = {name: get_animal(name, device) for name in NON_UV_NAMES}
    sync(device)

    per_species_launches, outputs, launches = counted_run(animals, host, frames, device)
    log(f"[main] launches over the non-UV main-path run: {launches}")

    results = {}
    for name, animal in animals.items():
        want = expected_kernel(name)
        moved = per_species_launches[name]
        if device.type == "cuda" and (moved[want] != 2 or sum(moved.values()) != 2):
            raise AssertionError(f"{name}: expected 2 launches of {want}, counted {moved}")
        base1, out1, base_b, out_b = outputs[name]
        if out1.shape != (h, w, 3) or out1.dtype != np.uint8 or tuple(out_b.shape) != (batch, h, w, 3):
            raise AssertionError(f"{name}: output {out1.shape} {out1.dtype}, batch {tuple(out_b.shape)}")
        if name != "cat" and not (np.array_equal(base1, host[0]) and torch.equal(base_b, frames)):
            raise AssertionError(f"{name}: baseline is not the input frame")
        _, plain = animal.plain_transform((h, w, 3), np.uint8)(frames)
        err = max(max_lsb(out_b, plain), max_lsb(torch.from_numpy(out1), plain[0].cpu()))
        if name == "cat":
            err = max(err, max_lsb(torch.from_numpy(base1), base_b[0].cpu()))
        # a small frame against the CPU path (the plain versions)
        small = rng.integers(0, 256, (*small_hw, 3), dtype=np.uint8)
        ref_b, ref = get_animal(name, "cpu").visualize(small)
        got_b, got = animal.visualize(small)
        small_err = max(max_lsb(torch.from_numpy(got), torch.from_numpy(ref)),
                        max_lsb(torch.from_numpy(got_b), torch.from_numpy(ref_b)))
        if err > TOL_LSB or small_err > TOL_LSB:
            raise AssertionError(f"{name}: {err} LSB from the plain path at {h}x{w}, {small_err} at {small_hw}")

        def one(animal=animal):
            animal.visualize(host[0])

        def batched(animal=animal):
            animal.visualize_batch_device(frames)
            sync(device)

        vis = wall_ms(one, reps)
        bat = wall_ms(batched, reps)
        results[name] = dict(
            kernel=want, max_lsb_plain=err, max_lsb_cpu_small=small_err,
            visualize_ms=vis, visualize_fps=1e3 / vis["median"],
            batch_ms=bat, batch_fps=batch * 1e3 / bat["median"],
        )
        log(f"[main] {name:<9} {want:<13} max {err} LSB vs plain, {small_err} vs CPU at "
            f"{small_hw[0]}x{small_hw[1]}; visualize {results[name]['visualize_fps']:8.1f} fps "
            f"(median {vis['median']:.3f} ms, p90 {vis['p90']:.3f} ms), batch of {batch} on device "
            f"{results[name]['batch_fps']:8.1f} fps (median {bat['median']:.3f} ms, p90 {bat['p90']:.3f} ms, "
            f"n={bat['n']})")
    hm = len(results) / sum(1.0 / r["batch_fps"] for r in results.values())
    hm_vis = len(results) / sum(1.0 / r["visualize_fps"] for r in results.values())
    return dict(species=results, launches=launches, hm_fps=hm, hm_visualize_fps=hm_vis)


def uv_main_path_phase(device: torch.device, hw=MAIN_HW, batch=BATCH, reps=UV_REPS,
                       small_hw=SMALL_HW) -> dict:
    """The ported UV species through both entry points, counters around the
    run; each against its plain composition on the card and against the CPU
    path on a small frame (>= 40 dB, baselines within 1 LSB); fps."""
    from animal_vision_tpu_torch.species import PORTED_UV_NAMES, get_animal

    rng = np.random.default_rng(SEED + 3)
    h, w = hw
    host = rng.integers(0, 256, (batch, h, w, 3), dtype=np.uint8)
    frames = torch.from_numpy(host).to(device)
    animals = {name: get_animal(name, device) for name in PORTED_UV_NAMES}
    sync(device)

    per_species_launches, outputs, launches = counted_run(animals, host, frames, device)
    log(f"[main] launches over the UV main-path run: {launches}")

    results = {}
    for name, animal in animals.items():
        moved = per_species_launches[name]
        if device.type == "cuda" and (moved["blur_uv"] < 2 or sum(moved.values()) != moved["blur_uv"]):
            raise AssertionError(f"{name}: expected blur_uv launches only, counted {moved}")
        base1, out1, base_b, out_b = outputs[name]
        if out1.shape != (h, w, 3) or out1.dtype != np.uint8 or tuple(out_b.shape) != (batch, h, w, 3):
            raise AssertionError(f"{name}: output {out1.shape} {out1.dtype}, batch {tuple(out_b.shape)}")
        plain_base, plain = animal.plain_transform((h, w, 3), np.uint8)(frames)
        db = min(psnr_db(out_b, plain), psnr_db(torch.from_numpy(out1), plain[0]))
        lsb = max(max_lsb(out_b, plain), max_lsb(torch.from_numpy(out1).to(device), plain[0]))
        base_lsb = max(max_lsb(base_b, plain_base), max_lsb(torch.from_numpy(base1).to(device), plain_base[0]))
        batch_vs_frame = max_lsb(out_b[0], torch.from_numpy(out1).to(device))
        small = rng.integers(0, 256, (*small_hw, 3), dtype=np.uint8)
        ref_b, ref = get_animal(name, "cpu").visualize(small)
        got_b, got = animal.visualize(small)
        small_db = psnr_db(torch.from_numpy(got), torch.from_numpy(ref))
        small_lsb = max_lsb(torch.from_numpy(got), torch.from_numpy(ref))
        small_base_lsb = max_lsb(torch.from_numpy(got_b), torch.from_numpy(ref_b))
        if db < UV_MIN_DB or small_db < UV_MIN_DB or base_lsb > TOL_LSB or small_base_lsb > TOL_LSB:
            raise AssertionError(f"{name}: {db:.2f} dB from the plain path at {h}x{w} (baseline {base_lsb} LSB), "
                                 f"{small_db:.2f} dB from the CPU path at {small_hw} (baseline {small_base_lsb} LSB)")

        def one(animal=animal):
            animal.visualize(host[0])

        def batched(animal=animal):
            animal.visualize_batch_device(frames)
            sync(device)

        vis = wall_ms(one, reps)
        bat = wall_ms(batched, reps)
        results[name] = dict(
            blur_uv_launches=moved["blur_uv"], psnr_plain_db=db, max_lsb_plain=lsb, baseline_max_lsb_plain=base_lsb,
            max_lsb_batch_vs_frame=batch_vs_frame, psnr_cpu_small_db=small_db, max_lsb_cpu_small=small_lsb,
            baseline_max_lsb_cpu_small=small_base_lsb,
            visualize_ms=vis, visualize_fps=1e3 / vis["median"],
            batch_ms=bat, batch_fps=batch * 1e3 / bat["median"],
        )
        log(f"[main] {name:<9} blur_uv x{moved['blur_uv']:<3} {db:.2f} dB / max {lsb} LSB vs plain (baseline "
            f"{base_lsb} LSB), {small_db:.2f} dB / max {small_lsb} LSB vs CPU at {small_hw[0]}x{small_hw[1]}; "
            f"batch[0] vs visualize max {batch_vs_frame} LSB; visualize {results[name]['visualize_fps']:7.1f} fps "
            f"(median {vis['median']:.3f} ms, p90 {vis['p90']:.3f} ms), batch of {batch} on device "
            f"{results[name]['batch_fps']:7.1f} fps (median {bat['median']:.3f} ms, p90 {bat['p90']:.3f} ms, "
            f"n={bat['n']})")
    hm = len(results) / sum(1.0 / r["batch_fps"] for r in results.values())
    hm_vis = len(results) / sum(1.0 / r["visualize_fps"] for r in results.values())
    return dict(species=results, launches=launches, hm_fps=hm, hm_visualize_fps=hm_vis)


def mst_main_path_phase(device: torch.device, hw=MAIN_HW, batch=BATCH, reps=MST_FORWARD_REPS,
                        species_reps=MST_SPECIES_REPS) -> dict:
    """MST++ with the shipped weights through the entry points a user calls:
    ``load_shipped(device)`` on one 1080p frame; kestrel and goldfish with
    ``attach_mst`` through ``visualize`` and ``visualize_batch_device``;
    honeybee with ``hsi_provider`` through ``visualize``. The counters are
    set to 0 before that run and read after it; each item is one forward.
    Then each against its plain version on the card, and the times."""
    from animal_vision_tpu_torch.models.mst_plus_plus import load_shipped
    from animal_vision_tpu_torch.models.providers import attach_mst, make_mst_hsi_provider
    from animal_vision_tpu_torch.species.uv.goldfish import Goldfish
    from animal_vision_tpu_torch.species.uv.honeybee import HoneyBee
    from animal_vision_tpu_torch.species.uv.kestrel import Kestrel

    rng = np.random.default_rng(SEED + 4)
    h, w = hw
    host = rng.integers(0, 256, (batch, h, w, 3), dtype=np.uint8)
    frames = torch.from_numpy(host).to(device)
    x = (frames[:1].to(torch.float32) / 255.0).contiguous()
    model = load_shipped(device)
    animals = {"kestrel": attach_mst(Kestrel(device), model), "goldfish": attach_mst(Goldfish(device), model),
               "honeybee": HoneyBee(device, hsi_provider=make_mst_hsi_provider(model))}
    sync(device)

    items = {"forward": lambda: model(x)}
    for name in ("kestrel", "goldfish"):
        items[f"{name} visualize"] = lambda a=animals[name]: a.visualize(host[0])
        items[f"{name} batch{batch}"] = lambda a=animals[name]: a.visualize_batch_device(frames)
    items["honeybee visualize"] = lambda: animals["honeybee"].visualize(host[0])
    outputs, per_item = {}, {}
    with torch.no_grad(), plain_forbidden_on_cuda():
        reset_counters()
        for label, fn in items.items():
            before = counters()
            outputs[label] = fn()
            per_item[label] = {k: v - before[k] for k, v in counters().items() if k in MST_PER_FORWARD}
        sync(device)
        launches = counters()
    log(f"[main] launches over the MST++ main-path run ({len(items)} forwards): "
        f"{ {k: launches[k] for k in MST_PER_FORWARD} }")
    for label, moved in per_item.items():
        if device.type == "cuda" and moved != MST_PER_FORWARD:
            raise AssertionError(f"{label}: expected {MST_PER_FORWARD} MST++ launches per forward, counted {moved}")

    with torch.no_grad():
        got = outputs["forward"]
        want = model(x, plain=True)
        err = (got - want).abs().max().item()
        if not (got.shape == (1, h, w, 31) and torch.isfinite(got).all().item() and err < MST_FORWARD_TOL):
            raise AssertionError(f"MST++ forward at {h}x{w}: shape {tuple(got.shape)}, {err} from the plain forward")
        forward = wall_ms(lambda: (model(x), sync(device)), reps)
        plain_forward = wall_ms(lambda: (model(x, plain=True), sync(device)), 1)
    log(f"[main] MST++ {h}x{w} forward: max {err:.3g} from the plain forward; median {forward['median']:.2f} ms "
        f"(p90 {forward['p90']:.2f}), plain {plain_forward['median']:.1f} ms")
    result = dict(forward_max_abs_err=err, forward_ms=forward, plain_forward_ms=plain_forward, launches=launches,
                  per_forward=per_item, species={})

    for name, animal in animals.items():
        base1, out1 = outputs[f"{name} visualize"]
        plain_base, plain = animal.plain_transform((h, w, 3), np.uint8)(frames if name != "honeybee" else frames[:1])
        db = psnr_db(torch.from_numpy(out1), plain[0])
        base_lsb = max_lsb(torch.from_numpy(base1).to(device), plain_base[0])
        row = dict(psnr_plain_db=db, baseline_max_lsb_plain=base_lsb)
        if name != "honeybee":
            base_b, out_b = outputs[f"{name} batch{batch}"]
            db = min(db, psnr_db(out_b, plain))
            base_lsb = max(base_lsb, max_lsb(base_b, plain_base))
            bat = wall_ms(lambda a=animal: (a.visualize_batch_device(frames), sync(device)), species_reps)
            row.update(psnr_plain_db=db, baseline_max_lsb_plain=base_lsb, batch_ms=bat,
                       batch_fps=batch * 1e3 / bat["median"],
                       max_lsb_batch_vs_frame=max_lsb(out_b[0], torch.from_numpy(out1).to(device)))
        if db < UV_MIN_DB or base_lsb > TOL_LSB or out1.shape != (h, w, 3):
            raise AssertionError(f"{name} with MST++: {db:.2f} dB from the plain path (baseline {base_lsb} LSB)")
        vis = wall_ms(lambda a=animal: a.visualize(host[0]), species_reps)
        row.update(visualize_ms=vis, visualize_fps=1e3 / vis["median"])
        result["species"][name] = row
        bat = (f", batch of {batch} on device {row['batch_fps']:.2f} fps (median {row['batch_ms']['median']:.1f} ms)"
               if "batch_fps" in row else "")
        log(f"[main] {name:<9} + MST++ {row['psnr_plain_db']:.2f} dB vs plain (baseline {base_lsb} LSB); visualize "
            f"{row['visualize_fps']:.2f} fps (median {vis['median']:.1f} ms){bat}")
    return result


def mst_l_main_path_phase(device: torch.device, hw=MAIN_HW, batch=BATCH, reps=MSTL_FORWARD_REPS,
                          species_reps=MST_SPECIES_REPS) -> dict:
    """MST-L (the zoo's ``"mst"``, weights made from a seed) through the
    entry points a user calls: ``zoo.model_generator`` on one 1080p frame;
    kestrel and mantis shrimp with ``attach_model(..., "mst")`` and mantis
    shrimp with ``attach_mst`` (MST++, shipped weights) through
    ``visualize`` and ``visualize_batch_device``. The counters are set to 0
    before that run and read after it: 27 ``ffn`` launches per MST-L
    forward (one per frame), the MST++ counts per MST++ forward. Then each
    against its plain version on the card, and the times."""
    from animal_vision_tpu_torch.models import zoo
    from animal_vision_tpu_torch.models.mst_plus_plus import load_shipped
    from animal_vision_tpu_torch.models.providers import attach_model, attach_mst
    from animal_vision_tpu_torch.species.uv.kestrel import Kestrel
    from animal_vision_tpu_torch.species.uv.mantis_shrimp import MantisShrimp

    rng = np.random.default_rng(SEED + 6)
    h, w = hw
    host = rng.integers(0, 256, (batch, h, w, 3), dtype=np.uint8)
    frames = torch.from_numpy(host).to(device)
    x = (frames[:1].to(torch.float32) / 255.0).contiguous()
    model = zoo.model_generator("mst", device=device, seed=SEED)
    animals = {"kestrel+mst-l": attach_model(Kestrel(device), "mst"),
               "mantis_shrimp+mst-l": attach_model(MantisShrimp(device), "mst"),
               "mantis_shrimp+mst++": attach_mst(MantisShrimp(device), load_shipped(device))}
    sync(device)

    items = {"forward": (lambda: model(x), {"ffn": MSTL_PER_FORWARD})}
    for name, animal in animals.items():
        mst_pp = name.endswith("mst++")
        one = {**MST_PER_FORWARD, "ffn": 0} if mst_pp else {"ffn": MSTL_PER_FORWARD}
        many = one if mst_pp else {"ffn": MSTL_PER_FORWARD * batch}  # MST-L: one forward per frame
        items[f"{name} visualize"] = (lambda a=animal: a.visualize(host[0]), one)
        items[f"{name} batch{batch}"] = (lambda a=animal: a.visualize_batch_device(frames), many)
    outputs, per_item = {}, {}
    with torch.no_grad(), plain_forbidden_on_cuda():
        reset_counters()
        for label, (fn, _) in items.items():
            before = counters()
            outputs[label] = fn()
            per_item[label] = {k: v - before[k] for k, v in counters().items()}
        sync(device)
        launches = counters()
    log(f"[main] launches over the MST-L main-path run ({len(items)} items): "
        f"{ {k: launches[k] for k in ('ffn', *MST_PER_FORWARD)} }")
    for label, (_, want) in items.items():
        got = {k: per_item[label][k] for k in want}
        if device.type == "cuda" and got != want:
            raise AssertionError(f"{label}: expected {want} launches, counted {got}")

    with torch.no_grad():
        got = outputs["forward"]
        want = model(x, plain=True)
        err = (got - want).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        if not (got.shape == (1, h, w, 31) and torch.isfinite(got).all().item() and err <= MSTL_FORWARD_REL_TOL * scale):
            raise AssertionError(f"MST-L forward at {h}x{w}: shape {tuple(got.shape)}, {err} from the plain forward "
                                 f"(max |y| {scale})")
        forward = wall_ms(lambda: (model(x), sync(device)), reps)
        plain_forward = wall_ms(lambda: (model(x, plain=True), sync(device)), 1)
    log(f"[main] MST-L {h}x{w} forward: max {err:.3g} from the plain forward (max |y| {scale:.1f}); median "
        f"{forward['median']:.2f} ms (p90 {forward['p90']:.2f}), plain {plain_forward['median']:.1f} ms")
    result = dict(forward_max_abs_err=err, forward_max_abs=scale, forward_ms=forward, plain_forward_ms=plain_forward,
                  launches=launches, per_item=per_item, species={})

    for name, animal in animals.items():
        base1, out1 = outputs[f"{name} visualize"]
        base_b, out_b = outputs[f"{name} batch{batch}"]
        with torch.no_grad():
            plain_base, plain = animal.plain_transform((h, w, 3), np.uint8)(frames)
        db = min(psnr_db(torch.from_numpy(out1), plain[0]), psnr_db(out_b, plain))
        base_lsb = max(max_lsb(torch.from_numpy(base1).to(device), plain_base[0]), max_lsb(base_b, plain_base))
        if db < UV_MIN_DB or base_lsb > TOL_LSB or out1.shape != (h, w, 3) or tuple(out_b.shape) != (batch, h, w, 3):
            raise AssertionError(f"{name}: {db:.2f} dB from the plain path (baseline {base_lsb} LSB)")
        vis = wall_ms(lambda a=animal: a.visualize(host[0]), species_reps)
        bat = wall_ms(lambda a=animal: (a.visualize_batch_device(frames), sync(device)), species_reps)
        row = dict(psnr_plain_db=db, baseline_max_lsb_plain=base_lsb,
                   max_lsb_batch_vs_frame=max_lsb(out_b[0], torch.from_numpy(out1).to(device)),
                   visualize_ms=vis, visualize_fps=1e3 / vis["median"], batch_ms=bat,
                   batch_fps=batch * 1e3 / bat["median"])
        result["species"][name] = row
        log(f"[main] {name:<19} {db:.2f} dB vs plain (baseline {base_lsb} LSB), batch[0] vs visualize max "
            f"{row['max_lsb_batch_vs_frame']} LSB; visualize {row['visualize_fps']:.2f} fps (median "
            f"{vis['median']:.1f} ms), batch of {batch} on device {row['batch_fps']:.2f} fps (median "
            f"{bat['median']:.1f} ms)")
    return result


def wall_ms(fn, reps: int) -> dict:
    """Host-clock milliseconds of ``reps`` calls, each ending synchronized:
    median and p90 (the highest percentile with 10 samples beyond it at 100
    calls)."""
    fn()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
    return dict(median=float(np.median(samples)), p90=float(np.percentile(samples, 90)), n=reps)


# ---------------------------------------------------------------------------
# Phase 5
# ---------------------------------------------------------------------------


def profile_phase(device: torch.device, hw=MAIN_HW, batch=BATCH, names=PROFILE_SPECIES,
                  reps=PROFILE_REPS) -> dict:
    """Where the time of one species goes: ``torch.profiler`` device time by
    name (kernels, copies, reductions) over a few calls of each entry point,
    beside the host-clock time of the same window. The profiler's own cost
    is in the wall time. Then the same for the 1080p MST++ forward, kestrel
    with MST++, the 1080p MST-L forward and mantis shrimp with MST-L."""
    from torch.profiler import ProfilerActivity, profile

    from animal_vision_tpu_torch.models import zoo
    from animal_vision_tpu_torch.models.mst_plus_plus import load_shipped
    from animal_vision_tpu_torch.models.providers import attach_model, attach_mst
    from animal_vision_tpu_torch.species import get_animal
    from animal_vision_tpu_torch.species.uv.kestrel import Kestrel
    from animal_vision_tpu_torch.species.uv.mantis_shrimp import MantisShrimp

    rng = np.random.default_rng(SEED + 2)
    host = rng.integers(0, 256, (batch, *hw, 3), dtype=np.uint8)
    frames = torch.from_numpy(host).to(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    model = load_shipped(device)
    kestrel = attach_mst(Kestrel(device), model)
    x = (frames[:1].to(torch.float32) / 255.0).contiguous()
    groups = [(name, {"visualize": lambda a=get_animal(name, device): a.visualize(host[0]),
                      f"batch{batch}": lambda a=get_animal(name, device): a.visualize_batch_device(frames)})
              for name in names]
    groups.append(("mst++", {"forward": lambda: model(x)}))
    groups.append(("kestrel+mst", {"visualize": lambda: kestrel.visualize(host[0]),
                                   f"batch{batch}": lambda: kestrel.visualize_batch_device(frames)}))
    mst_l = zoo.model_generator("mst", device=device, seed=SEED)
    mantis = attach_model(MantisShrimp(device), "mst")
    groups.append(("mst-l", {"forward": lambda: mst_l(x)}))
    groups.append(("mantis+mst-l", {"visualize": lambda: mantis.visualize(host[0]),
                                    f"batch{batch}": lambda: mantis.visualize_batch_device(frames)}))
    out = {}
    for name, entries in groups:
        for label, fn in entries.items():
            with torch.no_grad():
                fn()
            sync(device)
            with torch.no_grad(), profile(activities=activities, acc_events=True) as prof:
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                sync(device)
                wall_us = (time.perf_counter() - t0) * 1e6 / reps
            by_name = {}
            for e in prof.key_averages():
                # device-side events only (kernels, copies, fills); CPU ops
                # report their kernels' time again, and CUPTI's own buffer
                # requests are the profiler's cost
                if e.device_type != torch.autograd.DeviceType.CUDA or e.key.startswith("Activity Buffer"):
                    continue
                us = e.self_device_time_total
                if us > 0:
                    by_name[e.key] = us / reps
            busy_us = sum(by_name.values())
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            out[f"{name} {label}"] = dict(wall_us=wall_us, device_us=busy_us, device_by_name=by_name)
            log(f"[profile] {name:<11} {label:<9} wall {wall_us:9.1f} us/call, device busy {busy_us:9.1f} us "
                f"({busy_us / wall_us:.1%}): " + "; ".join(f"{k[:48]} {v:.1f}" for k, v in top))
    return out


def summary(kernel_rows: list[dict], blur_rows: list[dict], mst_rows: list[dict], ffn_rows: list[dict],
            launches: dict) -> dict:
    """One entry per kernel: worst error over its cases and shapes; time,
    plain time, bound and library time of its heaviest main-path case at
    1080p. Launches come from the main-path run of the kernel's species."""
    representative = {"iso_u8": "dog", "streak_u8": "deer", "pointwise_u8": "rat gain"}
    out = []
    for kernel, case in representative.items():
        rows = [r for r in kernel_rows if r["kernel"] == kernel]
        rep = next(r for r in rows if r["case"].split(" r=")[0] == case and (r["h"], r["w"]) == MAIN_HW)
        out.append(dict(
            name=kernel, route="cuda", source=SOURCES[kernel], replaces=REPLACES[kernel],
            launches=launches[kernel], max_abs_err=max(r["max_lsb"] for r in rows),
            max_lsb=max(r["max_lsb"] for r in rows), case=f"{rep['case']} {rep['h']}x{rep['w']}x{rep['frames']}",
            ms=rep["ms"], plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
            bound_by=rep["bound_by"], library_ms=None,
        ))
    k, c = BLUR_REPRESENTATIVE
    rep = next(r for r in blur_rows if (r["ksize"], r["channels"], r["h"], r["w"]) == (k, c, *MAIN_HW))
    out.append(dict(
        name="blur_uv", route="cuda", source=SOURCES["blur_uv"], replaces=REPLACES["blur_uv"],
        launches=launches["blur_uv"], max_abs_err=max(r["max_abs_err"] for r in blur_rows),
        case=f"{rep['case']} {rep['h']}x{rep['w']}x{rep['frames']} frames",
        ms=rep["ms"], plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
        library_ms=rep["library_ms"],
    ))
    for kernel, case in MST_REPRESENTATIVE.items():
        rows = [r for r in mst_rows if r["kernel"] == kernel]
        rep = next(r for r in rows if r["case"] == case and r["point"] == "1080p")
        out.append(dict(
            name=kernel, route="cuda", source=SOURCES[kernel], replaces=REPLACES[kernel],
            launches=launches[kernel], max_abs_err=max(r["max_abs_err"] for r in rows),
            case=f"{rep['case']} {rep['h']}x{rep['w']}x{rep['frames']}",
            ms=rep["ms"], plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
            library_ms=rep["library_ms"],
            **({"max_rel_err": max(r["err"] for r in rows)} if kernel == "attn_stats_kernel" else {}),
        ))
    rep = next(r for r in ffn_rows if r["case"] == "C=31" and r["point"] == "1080p")
    out.append(dict(
        name="ffn_kernel", route="cuda", source=SOURCES["ffn_kernel"], replaces=REPLACES["ffn_kernel"],
        launches=launches["ffn_kernel"], max_abs_err=max(r["max_abs_err"] for r in ffn_rows),
        case=f"{rep['case']} {rep['h']}x{rep['w']}x{rep['frames']}",
        ms=rep["ms"], plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"], bound_by=rep["bound_by"], library_ms=None,
    ))
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script runs only on the card",
              file=sys.stderr)
        return 2
    import animal_vision_tpu_torch  # noqa: F401  (fails outside a checkout)

    t0 = time.perf_counter()
    device = torch.device("cuda")
    info = device_phase()
    build = build_phase()
    kernel_rows = kernels_phase(device)
    blur_rows = blur_phase(device)
    mst_rows = mst_kernels_phase(device)
    ffn_rows = ffn_phase(device)
    main_run = main_path_phase(device)
    uv_run = uv_main_path_phase(device)
    mst_run = mst_main_path_phase(device)
    mst_l_run = mst_l_main_path_phase(device)
    profile_run = profile_phase(device)
    if any(m.startswith("jax") or m == "animal_vision_tpu" or m.startswith("animal_vision_tpu.")
           for m in sys.modules):
        raise AssertionError("the port imported JAX or the JAX package")
    log(f"[main] 20-species harmonic mean at {MAIN_HW[0]}x{MAIN_HW[1]}, batch of {BATCH} on the device: "
        f"{main_run['hm_fps']:.1f} fps; through visualize (host round trip): "
        f"{main_run['hm_visualize_fps']:.1f} fps; card: {info['card']}")
    log(f"[main] {len(uv_run['species'])}-UV-species harmonic mean at {MAIN_HW[0]}x{MAIN_HW[1]}, batch of {BATCH} "
        f"on the device: {uv_run['hm_fps']:.1f} fps; through visualize: {uv_run['hm_visualize_fps']:.1f} fps")
    launches = {**main_run["launches"], "blur_uv": uv_run["launches"]["blur_uv"],
                **{k: mst_run["launches"][k] for k in MST_PER_FORWARD}, "ffn_kernel": mst_l_run["launches"]["ffn"]}
    kernels = summary(kernel_rows, blur_rows, mst_rows, ffn_rows, launches)
    REPORT.parent.mkdir(exist_ok=True)
    REPORT.write_text(json.dumps(dict(device=info, build=build, kernel_cases=kernel_rows, blur_cases=blur_rows,
                                      mst_cases=mst_rows, ffn_cases=ffn_rows, main_path=main_run,
                                      uv_main_path=uv_run, mst_main_path=mst_run, mst_l_main_path=mst_l_run,
                                      profile=profile_run,
                                      kernels=kernels["kernels"], seconds=time.perf_counter() - t0), indent=1))
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(info["card"])
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
