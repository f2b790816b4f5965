#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``animal_vision_tpu_torch`` on the card in phases, each of which
raises on failure:

1. device: card name, count, power limit; TF32 off for matrix products and
   convolutions (the cat's warp and zoom are full float32);
2. build: compiles every ``csrc/*.cu`` kernel library (one nvcc per source,
   all at once) and prints ptxas' register and shared-memory report; for
   the tensor-core kernels (``conv_kernel``, ``attn_stats_kernel``,
   ``msab_pos_kernel``, ``msab_pos_masked_kernel``, ``up_fuse_kernel``,
   ``ffn_kernel``) it prints each
   instance's registers, spills and dynamic shared memory and the count of
   ``HMMA`` instructions in its SASS (``cuobjdump --dump-sass``), and fails
   if one has none;
3. kernels: the non-UV kernels' threshold encode against the powf encode
   at all 2^32 float32 bit patterns (equal), then every kernel of the main
   path against its plain PyTorch version
   on the card at 1080x1920 and 721x1283: the three non-UV kernels on two
   random frames plus a frame of 0/1 values (so both branches of the
   per-frame scale run), <= 1 LSB; the UV blur on 3 float32 frames in
   [0, 1] with 1 or 3 channels and ksize 3..37, <= 1e-5; the four MST++
   kernels at the three levels of a 1080x1920 frame and of 4 frames of
   272x480 (kestrel's and goldfish's 0.25-scale operating point), random
   weights of scale 0.2: conv, up_fuse and pass B's first half alone
   (``msab_pos``) <= 1e-4, stats <= 1e-5 of max |G|, apply (``msab_pos``
   then ``ffn``) <= 5e-4; MST-L's masked pos kernel (``msab_pos`` with a
   (1, H, W, C) gate) at the three levels of one 272x480 frame, <= 1e-4;
   the FFN kernel at the launches of honeybee's MST++ (4 frames of 1080x1920
   and its levels) and of mantis's MST-L (one 272x480 frame and its levels)
   and at 721x1283 with C = 31, weights of scale 0.2, <= 1e-4, with the
   blocks of each instance that an SM holds; then each kernel's time
   (CUDA events around calls queued ahead of the card, so that no
   wrapper's host time shows), its plain version's time, its bound, and a library
   reference for the UV blur (reflect pad + two depthwise convolutions)
   and the MST++ convolution (``F.conv2d`` on channels-last tensors), each
   with the ratio of the kernel's time to it; ``conv``, ``attn_stats``,
   ``msab_pos``, ``msab_apply``, ``up_fuse`` (its weights composed by
   ``up_fuse_weights``, its operations those of the composed product) and
   ``ffn`` also get a second bound, for their 3xTF32 tensor-core products
   (the largest of 3 x product operations / 495 TFLOP/s, the other
   operations / 67 TFLOP/s and bytes / 3.35 TB/s), which is the
   ``bound_ms`` of their summary entries; then the ablation: the non-UV
   kernels taken apart (``csrc/nonuv_probe.cu``, the port of
   ``tools/exp_micro.py:28``) on 4 uint8 1080p frames: a copy, the sRGB
   curves by powf and by tables, a 3x3 mix, 12 and 28 W-taps, ms per
   frame; the table variants must give the powf variants' bytes; then the
   GELU probe (``csrc/gelu_probe.cu``, the port of
   ``tools/exp_vpu_bf16.py:55``): the degree-11 and degree-7 GELU
   polynomials, a 3x3 multiply-add stencil, one multiply-add and the erf
   GELU, each applied 32-256 times over a 4096x512 array in f32 and bf16,
   each kernel against its plain version after 1, 8 and all its
   applications on that array and on 2^20 points in [-8, 8] (f32 within
   1e-5 of min(1, max |y|), the stencil of max |y|; bf16 within 2^-6 of
   each |y|), ms, ns per element application, ratio to the multiply-add,
   bound (bf16 at its own rate, 133.8 TFLOP/s), the multiply-add's steady
   rate over 4096 applications, each instance's SASS opcodes, and
   max |degree-11 - erf| over the 2^20 points;
4. main path: ``get_animal(name).visualize(frame)`` and
   ``visualize_batch_device`` (4 frames already on the card) at 1080p, first
   for the 20 non-UV species, then for the 16 UV species (rat_uv on the
   same frames with two of the four darkened, so that its batch takes both
   its day and its night rendering, and each frame of its batch equal to
   the frame alone), with the
   launch counters set to 0 before and read after each of the two runs;
   each non-UV species against its plain composition on the card (<= 1 LSB)
   and against the CPU path on a small frame (<= 1 LSB), each UV species
   the same at >= 40 dB PSNR with its baseline within 1 LSB; then fps per
   species and each group's harmonic mean (the UV group's also without
   rat_uv, the 15 species of earlier runs); then MST++ with the shipped
   weights: one 1080p forward, kestrel and goldfish with ``attach_mst``
   through both entry points and honeybee with the provider on a 1080p
   frame, counters around the run (14 conv, 15 stats, 15 apply, 6 up_fuse
   and 15 ``ffn`` launches per forward: pass B's second half is the FFN
   kernel), each against its plain version on the card
   (forward < 5e-4, species >= 40 dB, baselines <= 1 LSB), ms and fps;
   then MST-L (the zoo's ``"mst"``) with weights made from a seed: one
   1080p forward, kestrel and mantis shrimp with ``attach_model(..., "mst")``
   and mantis shrimp with ``attach_mst``, through both entry points,
   counters around the run (27 ``ffn`` launches per MST-L forward), each
   against its plain version on the card (forward within 5e-4 of max |y|,
   species >= 40 dB, baselines <= 1 LSB), ms and fps;
   then the zoo's nine other methods (``zoo_phase``, seeded weights): each
   on the card against the CPU at 64x96 and 37x53 (within 1e-4 of max |y|),
   one 1080p forward (AWAN through ``predict_tiled``) with its FLOPs,
   share of 67 TFLOP/s, peak memory, busy share and top kernels, and
   kestrel with ``attach_model`` through both entry points (``blur_uv``
   launches counted, >= 40 dB against the CPU path, baseline <= 1 LSB,
   fps, peak memory), then one ``forward_ensemble("mean")`` at 272x480
   against the mean of its eight forwards;
   then host frames through the streaming executor (``stream_phase``):
   for the dog, deer, rat, cat and kestrel, 50 uint8 1080p frames through
   ``StreamingExecutor(batch=4, split=False)``, each equal to
   ``visualize_batch`` of its batch, through the native ring, the species'
   kernel launched for every batch, and in a profiled run the frames
   equal again and every frame copy pinned and on a stream apart from the
   kernels', the trace's memcpy records matched to the runtime's calls;
   streamed fps beside ``visualize`` and batch-on-card fps, the executor's
   stage split, page faults, the card's busy share, H2D and D2H GB/s;
   then the serving layer (``serve_phase``): the port's ASGI app on the
   card, served by its stdlib server on 127.0.0.1, with the service's cv2
   codec swapped for raw uint8 frames in data URIs (``raw_codec``; the
   card's machine has no cv2, so ``/getpic`` and ``/getgallery``, which draw
   with cv2, run in the CPU tests only and the log names them): the static
   routes and ``/gettip`` over TCP, then for the same five species 10
   ``/getframe`` requests and 10 frames over one ``/ws`` socket over TCP
   and 3 Socket.IO clients of 5 frames each in process, a bad frame first;
   every frame equal to ``visualize`` on the card bit for bit, the
   species' kernel launched per request as ``visualize`` launches it,
   every Socket.IO frame answered once, to its client, in order; ms per
   request (median, p90) beside ``visualize`` alone, the host's JSON and
   base64 work per frame and the stdlib server's read of one masked
   ``/ws`` frame;
   then MST++ training and evaluation (``train_phase``): the published
   model (seeded weights) for 20 Adam steps of 20 patches of 128x128 (the
   plain versions under autograd; no kernel launched), ms per step, peak
   memory, a profiled step's busy share and top kernels; a checkpoint at
   step 10 resumed into fresh objects equal to the uninterrupted run bit
   for bit; 3 steps on the card against the CPU; the trained model through
   the kernels at 544x960 (launches of a forward, < 5e-4 from plain,
   ``fused_vs_f32_psnr`` >= 40 dB, unlike the forward before training);
   the eval protocol of the shipped weights
   on in-memory scenes against the CPU (the ``.mat`` and ``.jpg`` I/O is
   named as CPU-tested only); the convergence demo's JAX bars;
   then the model side's entry points (``tools_phase``): the summary CLI
   over all 11 zoo methods at 256x256 on the card (exit 0, no ``FAILED``),
   each method's parameters and FLOPs equal to the CPU's (counted in a
   process of its own meanwhile); ``tools/train_synth.py`` for 300 steps
   (finite losses, the last chunk's below the first, the held-out PSNR
   above the initial forward's, no kernel launched by a step, the eval
   protocol in memory); its saved file reloaded by
   ``quality.load_pretrained`` through the kernels at 544x960 (the launches
   of a forward, < 5e-4 from plain); ``tools/finetune_mixed.py`` for 100
   steps on a copy of the shipped weights, kept (an in-memory protocol
   never swaps); the shipped ``synth_v1.pt`` unchanged;
   then the multi-device layer (``multidevice_phase``), its ranks as
   processes on the card (gloo, host-staged, when they share one): the
   MST++ band forward at 1080x1920 with sp 2 and at 544x960 with
   sp 2 x tp 2 (every rank launching every MST++ kernel, counters set to 0
   just before and read just after in each rank; < 5e-4 from the
   unsharded forward; ms beside it, halo bytes, transport ms), 1080x1920
   with sp 4 (no band path: run whole), the pp pipeline on 4 x 272x480,
   the sharded train step with dp 2 and sp 2 against one process, the
   fleet bit-equal to ``visualize``, and the dry run's summary line;
   then the library: the functions no species calls (band integrals,
   ``map_uv_purple_yellow``, the general Gaussian blurs, ``tapetum_bloom``,
   ``rod_vision``, ``unsharp_mask``, ``dog_bandpass``, ``remap_bilinear``,
   ``center_zoom``, the binocular warp, the LMS helpers) and the Mallett
   upsampler on the card against the port on the CPU (<= 1e-5), with
   ``unsharp_mask``'s and ``dog_bandpass``'s ``blur_uv`` launches counted;
5. profile: ``torch.profiler`` device time by name beside the host-clock
   time for one non-UV species per kernel (the pig and the rat for the
   pointwise kernel's two instances), the cat and the UV species,
   through each entry point, the 1080p MST++ forward, kestrel with MST++,
   the 1080p MST-L forward and mantis shrimp with MST-L;
6. degrade: ``visualize``'s degradation ladder. With
   ``ANIMAL_VISION_MAX_PIXELS=1000000`` the dog, the cat, rat_uv and
   kestrel on a 1080p frame take rung 1024, build no full-size program
   and equal the explicit composition (host area-down, ``visualize``, host
   linear-up) bit for bit; then, with a tensor holding all of the card's
   memory but 1 GiB, rat_uv on a 2160x3840 frame runs the device out of
   memory, goes down the ladder and equals the composition at the rung it
   took; with the memory released the same frame takes the exact path.
   After every other phase the count of frames served by the ladder must
   be 0;
7. summary: one JSON line with each kernel (``pointwise_u8`` with its
   share of the bytes bound and its ratio to the ablation's copy of the
   same number of frames; ``blur_uv`` with rat_uv's cases, C = 3 and
   k = 7 and 9 at 1080p; the GELU probe's ten cases, each with its
   launches from the probe's own run, as the probe runs on no species'
   path), then, as the last line,
   ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, without a CUDA device. A detailed
report goes to ``chiprun_out/chip_smoke_report.json``.
"""

from __future__ import annotations

import asyncio
import base64
import contextlib
import hashlib
import io
import itertools
import json
import os
import re
import resource
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from animal_vision_tpu_torch.utils.timing import time_ms

SEED = 20261016
SHAPES = ((1080, 1920), (721, 1283))
MAIN_HW = (1080, 1920)
BATCH = 4
SMALL_HW = (64, 96)
TOL_LSB = 1
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, device memory
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores
BF16_OPS_PER_S = 133.8e12  # H100 SXM, bf16 outside the tensor cores (NVIDIA H100 whitepaper)
TF32_OPS_PER_S = 495e12  # H100 SXM, dense TF32 on the tensor cores
# kernels whose products run in 3xTF32 on the tensor cores: the summary names
# (msab_apply_kernel: msab_pos_kernel, then ffn_kernel) and the built
# instances the build phase reports
TC_KERNELS = ("conv_kernel", "attn_stats_kernel", "msab_apply_kernel", "up_fuse_kernel", "ffn_kernel")
TC_INSTANCES = ("conv_kernel", "attn_stats_kernel", "msab_pos_kernel", "msab_pos_masked_kernel", "up_fuse_kernel",
                "ffn_kernel")
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
# one non-UV species per kernel (both of the pointwise kernel's), the cat's
# products, and the UV species
PROFILE_SPECIES = ("dog", "deer", "rat", "pig", "cat", "honeybee", "reindeer", "goldfish", "kestrel", "rat_uv")
PROFILE_REPS = 5
# MST++: (padded frame, frames per call) of the two operating points
MST_POINTS = {"1080p": ((1080, 1920), 1), "272x480": ((272, 480), BATCH)}
MST_KERNEL_REPS = 10
MST_PLAIN_REPS = 2
MST_TOL = {"conv_kernel": 1e-4, "up_fuse_kernel": 1e-4, "msab_pos_kernel": 1e-4, "msab_apply_kernel": 5e-4,
           "msab_pos_masked_kernel": 1e-4}
MST_STATS_REL_TOL = 1e-5  # of max |G|
MST_FORWARD_TOL = 5e-4
MST_FORWARD_REPS = 10
MST_SPECIES_REPS = 5
MST_PER_FORWARD = {"conv_kernel": 14, "attn_stats_kernel": 15, "msab_apply_kernel": 15, "up_fuse_kernel": 6}
# pass B's second half: one ffn_kernel launch per msab_apply
MST_FFN_PER_FORWARD = {"ffn": 15}
# the 1080p case of each MST++ kernel that the summary line reports
MST_REPRESENTATIVE = {"conv_kernel": "31->31 k3", "attn_stats_kernel": "C=31", "msab_apply_kernel": "C=31",
                      "up_fuse_kernel": "62->31"}
# The FFN kernel at the main paths' launches: (point, frames, h, w, C) of each
# case; honeybee's MST++ (4 frames of 1080x1920 per launch) and mantis's MST-L
# (one 272x480 frame per launch) at their three levels, then 721x1283 at C = 31
FFN_POINTS = {"honeybee": ((1080, 1920), BATCH), "mantis": ((272, 480), 1)}
FFN_CASES = tuple((point, n, h >> lvl, w >> lvl, c) for point, ((h, w), n) in FFN_POINTS.items()
                  for lvl, c in enumerate((31, 62, 124))) + (("721x1283", 1, 721, 1283, 31),)
FFN_TOL = 1e-4
MSTL_FORWARD_REL_TOL = 5e-4  # of max |y|: the seeded model's output reaches the hundreds
MSTL_FORWARD_REPS = 5
MSTL_PER_FORWARD = 27
# MST-L's masked pos kernel: (point, padded frame, frames per call) of its
# operating point, the quarter-scale 1080p frame, one frame per forward
MSTL_MASKED_POINT = ("272x480", (272, 480), 1)
# the non-UV ablation (csrc/nonuv_probe.cu): (name, curve, mix, taps) per variant
PROBE_FRAMES = 4
PROBE_VARIANTS = (("copy", 0, 0, 0), ("curves by powf", 1, 0, 0), ("curves by tables", 2, 0, 0),
                  ("tables + 3x3 mix", 2, 1, 0), ("tables + mix + 12 W-taps", 2, 1, 12),
                  ("tables + mix + 28 W-taps", 2, 1, 28), ("powf + 3x3 mix", 1, 1, 0),
                  ("powf + mix + 28 W-taps", 1, 1, 28))
PROBE_REPS = 50
# the GELU probe (csrc/gelu_probe.cu): applications after which each kernel
# is held against its plain version (``gelu_probe.excess``: float32 within
# 1e-5 of min(1, max |y|), the stencil of max |y|; bf16 within 2^-6 of each
# |y|), before the full count is timed; timed calls per case; the points of
# the deg-11 vs erf readout; operations per element and application (a
# multiply-add 2; erff counted as 1, so gelu_erf's bound is a lower bound);
# single_madd's applications for the steady rate of the float units
GELU_PROBE_CHECK_REPS = (1, 8)
GELU_PROBE_REPS = 20
GELU_ERF_POINTS = 1 << 20
GELU_PROBE_OPS = {"gelu_deg11": 31, "gelu_deg7": 19, "madd3x3": 17, "single_madd": 2, "gelu_erf": 5}
GELU_RATE_REPS = 4096
# the zoo's nine other methods: the card against the CPU at two small sizes
# (within 1e-4 of max |y|), one 1080p forward (AWAN through predict_tiled,
# tiles of 256 with overlap 64, 8 tiles per call), kestrel as the provider,
# and one self-ensemble at 272x480
ZOO_METHODS = ("hscnn_plus", "edsr", "hinet", "mprnet", "restormer", "mirnet", "hdnet", "hrnet", "awan")
ZOO_SMALL = ((64, 96), (37, 53))
ZOO_REL_TOL = 1e-4
ZOO_FORWARD_REPS = 5
ZOO_SPECIES_REPS = 3
ZOO_TILE = (256, 64, 8)  # (tile, overlap, tiles per call) of AWAN's 1080p point
ZOO_ENSEMBLE = ("mirnet", (272, 480))
ZOO_ENSEMBLE_REL_TOL = 1e-5
SOURCES = {
    "iso_u8": "animal_vision_tpu_torch/csrc/fused_nonuv.cu",
    "streak_u8": "animal_vision_tpu_torch/csrc/fused_nonuv.cu",
    "pointwise_u8": "animal_vision_tpu_torch/csrc/fused_nonuv.cu",
    "blur_uv": "animal_vision_tpu_torch/csrc/fused_blur.cu",
    "conv_kernel": "animal_vision_tpu_torch/csrc/fused_msab.cu",
    "attn_stats_kernel": "animal_vision_tpu_torch/csrc/fused_msab.cu",
    "msab_apply_kernel": "animal_vision_tpu_torch/csrc/fused_msab.cu",
    "msab_pos_masked_kernel": "animal_vision_tpu_torch/csrc/fused_msab.cu",
    "up_fuse_kernel": "animal_vision_tpu_torch/csrc/fused_msab.cu",
    "ffn_kernel": "animal_vision_tpu_torch/csrc/fused_mst.cu",
    "gelu_probe": "animal_vision_tpu_torch/csrc/gelu_probe.cu",
}
REPLACES = {
    "iso_u8": "animal_vision_tpu/ops/fused_nonuv.py:199",
    "streak_u8": "animal_vision_tpu/ops/fused_nonuv.py:335",
    "pointwise_u8": "animal_vision_tpu/ops/fused_nonuv.py:530",
    "blur_uv": "animal_vision_tpu/ops/fused_blur.py:68",
    "conv_kernel": "animal_vision_tpu/ops/fused_msab.py:636",
    "attn_stats_kernel": "animal_vision_tpu/ops/fused_msab.py:192",
    "msab_apply_kernel": "animal_vision_tpu/ops/fused_msab.py:293",
    "msab_pos_masked_kernel": "animal_vision_tpu/models/mst.py:44",  # MST-L's attention, plain XLA there
    "up_fuse_kernel": "animal_vision_tpu/ops/fused_msab.py:848",
    "ffn_kernel": "animal_vision_tpu/ops/fused_mst.py:54",
    "gelu_probe": "tools/exp_vpu_bf16.py:55",
}
# the degradation ladder: the budget part's species and pixel budget; the real
# OOM's frame and the device memory left free beside the tensor that holds
# the rest (rat_uv's exact path at 2160x3840 needs two 1.29 GB cubes)
DEGRADE_SPECIES = ("dog", "cat", "rat_uv", "kestrel")
DEGRADE_BUDGET = 1_000_000
OOM_HW = (2160, 3840)
OOM_FREE_BYTES = 1 << 30
# the library phase: frame size, and the bar of each function on the card
# against the port on the CPU
LIBRARY_HW = (540, 960)
LIBRARY_TOL = 1e-5
# the streaming phase: species (one per non-UV kernel, the cat, a UV
# species), frames per run (the last batch holds 2), timed runs
STREAM_SPECIES = ("dog", "deer", "rat", "cat", "kestrel")
STREAM_FRAMES = 50
STREAM_BATCH = 4
STREAM_RUNS = 3
# the serving phase: timed requests per species and route (and frames over
# one /ws socket), the Socket.IO clients and frames each, the raw codec's
# MIME type, the longest wait for a reply, and the routes not run on the card
SERVE_REPS = 10
SERVE_SIO = (3, 5)
SERVE_RAW_MIME = "application/x-raw-rgb"
SERVE_TIMEOUT_S = 120
SERVE_NOT_ON_CARD = {
    "/getpic": "compose_split draws its labels with cv2.putText (io/renderer.py)",
    "/getgallery": "build_labeled_grid resizes and labels its tiles with cv2 (io/gallery.py)",
}
# train_phase: the published MST++ on the reference harness's crop and batch
# (models/data.py's defaults), then the checks of models/train.py's slice
TRAIN_STEPS = 20
TRAIN_BATCH = 20
TRAIN_PATCH = 128
TRAIN_LR = 4e-4
TRAIN_SCENES = (8, 256, 256)  # synthetic_scenes (n, h, w) the patches are cut from
TRAIN_RESUME_AT = 10
TRAIN_TIMED_FROM = 5  # steps 5..20 in the step-time median and p90
TRAIN_CPU = (3, 2, 32)  # steps, batch, patch of the card-against-CPU run
TRAIN_LOSS_REL = 1e-4
TRAIN_RMS_OF_BOUND = 1e-4  # parameters: max within 2 x the rates' sum (Adam's sign flips), RMS within this of it
TRAIN_FORWARD_HW = (544, 960)
TRAIN_MIN_DB = 40.0
TRAIN_EVAL_SCENES = (2, 288, 320)  # per family: synthetic_scenes and xgen_scenes
TRAIN_EVAL_REL = 1e-4
TRAIN_DEMO_STEPS = 40
TRAIN_NOT_ON_CARD = {
    "load_mat_cube, save_mat_cube": "h5py is not installed on the card's machine (models/eval.py)",
    "load_rgb_minmax": "reads a .jpg with cv2 (models/eval.py)",
    "eval_protocol_fixtures": "writes .jpg with cv2 and .mat with h5py (models/quality.py)",
    "predict_image": "reads a .jpg with cv2 and writes a .mat with h5py (models/ensemble.py)",
}
TOOLS_SIZE = 256  # the summary CLI's default frame side
TOOLS_TRAIN = ("--steps", "300", "--budget-s", "60")  # train_synth's other flags at their defaults
TOOLS_FINETUNE = ("--steps", "100")
TOOLS_RELOAD_HW = (544, 960)
TOOLS_CPU_THREADS = 4  # the CPU counts' process, beside the card's
TOOLS_CPU_TIMEOUT_S = 240
TOOLS_CPU_FLOPS = r"""
import json, sys, torch
torch.set_num_threads(int(sys.argv[2]))
from animal_vision_tpu_torch.models import summary, zoo
size = int(sys.argv[1])
print(json.dumps({m: summary.summarize(m, size, size, "cpu") for m in zoo.available_models()}))
"""
MD_SP2_HW = (1080, 1920)  # 2 ranks, sp 2: bands of 540 rows
MD_SPTP_HW = (544, 960)  # 4 ranks, sp 2 x tp 2: bands of 136 rows
MD_FALLBACK_HW = (1080, 1920)  # 4 ranks, sp 4: 270-row bands are not 4-aligned, so the frame runs whole
MD_PP = (4, 272, 480)  # 4 ranks: MST++'s 3 stages and an identity slot, 4 microbatches
MD_PP_MICRO = 4
MD_REPS = 10
MD_PP_REPS = 5
MD_TRAIN = (3, 20, 128)  # steps, batch, patch of the sharded train steps (dp 2, then sp 2)
MD_KERNELS = ("conv_kernel", "attn_stats_kernel", "msab_apply_kernel", "up_fuse_kernel", "ffn")
MD_FLEET = ("dog", "pig", "rat", "lion")
MD_FLEET_REPS = 5
MD_TIMEOUT_S = 400
REPORT = Path(__file__).resolve().parent / "chiprun_out" / "chip_smoke_report.json"


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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
    from animal_vision_tpu_torch.ops import _build
    from animal_vision_tpu_torch.species import base

    _build.reset_launches()
    base.reset_rungs()


def no_rungs(phase: str) -> None:
    """Fail if ``visualize`` took the degradation ladder since the last
    reset: outside the degrade phase the ladder must not hide a failure."""
    from animal_vision_tpu_torch.species import base

    if base.rungs_taken():
        raise AssertionError(f"{phase}: the degradation ladder was taken: {base.RUNGS}")
    log(f"[{phase}] rungs taken: 0")
    base.reset_rungs()


def counters() -> dict:
    from animal_vision_tpu_torch.ops import _build

    return dict(_build.LAUNCHES)


@contextlib.contextmanager
def plain_forbidden_on_cuda():
    """Make every plain kernel version raise if a CUDA tensor reaches it."""
    from animal_vision_tpu_torch.ops import fused_blur as B
    from animal_vision_tpu_torch.ops import fused_msab as M
    from animal_vision_tpu_torch.ops import fused_mst as T
    from animal_vision_tpu_torch.ops import fused_nonuv as F

    names = ((F, "iso_u8_plain"), (F, "streak_u8_plain"), (F, "pointwise_u8_plain"), (B, "blur_uv_plain"),
             (M, "conv_plain"), (M, "attn_stats_plain"), (M, "msab_pos_plain"), (M, "msab_apply_plain"),
             (M, "up_fuse_plain"),
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
    tc = tensor_core_report(reports)
    for inst, row in tc.items():
        log(f"[build] {inst}: {row['registers']} registers, {row['spill_stores']}/{row['spill_loads']} bytes "
            f"spilled (stores/loads), {row['smem_bytes']} bytes of dynamic shared memory, {row['hmma']} HMMA of "
            f"{row['instructions']} instructions in its SASS"
            + "".join(f"; a product's steps {p['instructions']} instructions, {p['hmma']} HMMA"
                      for p in row.get("products", ())))
        if row["hmma"] == 0:
            raise AssertionError(f"{inst}: no HMMA instruction in its SASS")
    for kernel in TC_INSTANCES:
        if not any(inst.startswith(kernel) for inst in tc):
            raise AssertionError(f"{kernel}: no instance found in the built libraries")
    return {"seconds": seconds, "tensor_core_kernels": tc}


def instance_name(mangled: str) -> str:
    """``conv_kernel<4,2,62,124>`` from a mangled kernel name (the name
    itself when it is not one of the tensor-core kernels)."""
    m = re.search(r"\d+((?:conv|ffn|attn_stats|msab_pos|msab_pos_masked|up_fuse)_kernel)I((?:Li-?\d+E)+)E", mangled)
    if not m:
        return mangled
    return f"{m.group(1)}<{','.join(re.findall(r'Li(-?[0-9]+)E', m.group(2)))}>"


SASS_OPCODE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)")


def product_steps(ops: list[str]) -> list[dict]:
    """The static SASS of each tensor-core product of a kernel: between two
    barriers, the instructions from its first HMMA to its last (the unrolled
    steps: fragment loads, any splitting, the HMMAs) and its HMMAs, in code
    order."""
    steps, region = [], []
    for op in ops + ["BAR"]:
        if not op.startswith("BAR"):
            region.append(op)
            continue
        at = [i for i, o in enumerate(region) if o.startswith("HMMA")]
        if at:
            steps.append(dict(instructions=at[-1] - at[0] + 1, hmma=len(at)))
        region = []
    return steps


def tensor_core_report(reports: dict) -> dict:
    """Per instance of the tensor-core kernels: ptxas' registers and spills
    (the build log), its dynamic shared memory (from the wrappers), the
    count of its SASS instructions and of HMMA among them, and for the FFN
    kernel each product's static steps (``product_steps``)."""
    from animal_vision_tpu_torch.ops import _build
    from animal_vision_tpu_torch.ops import fused_msab as M
    from animal_vision_tpu_torch.ops import fused_mst as T

    out = {}
    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    for name in ("fused_msab", "fused_mst"):
        current = None
        for line in reports[name].splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                inst = instance_name(m.group(1))
                current = inst if inst.startswith(TC_INSTANCES) else None
                if current:
                    out[current] = dict(registers=None, spill_stores=None, spill_loads=None, smem_bytes=None, hmma=0)
            elif current and "spill stores" in line:
                out[current].update({f"spill_{k}": int(v) for v, k in re.findall(r"(\d+) bytes spill (stores|loads)",
                                                                                 line)})
            elif current and "Used" in line:
                out[current]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
        sass = subprocess.run([str(cuobjdump), "--dump-sass", str(_build.library_path(name))], capture_output=True,
                              text=True, timeout=300, check=True).stdout
        current, ops = None, {}
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                current = instance_name(m.group(1))
                continue
            m = SASS_OPCODE.search(line)
            if current in out and m:
                ops.setdefault(current, []).append(m.group(1))
        for inst, seq in ops.items():
            out[inst]["hmma"] = sum(op.startswith("HMMA") for op in seq)
            out[inst]["instructions"] = len(seq)
            if inst.startswith("ffn_kernel"):
                out[inst]["products"] = product_steps(seq)
    for inst, row in out.items():
        args = [int(v) for v in inst[inst.index("<") + 1:-1].split(",")]
        if inst.startswith("ffn_kernel"):
            row["smem_bytes"] = T.smem_bytes(args[0], (args[1], args[2]))
        elif inst.startswith("attn_stats_kernel"):
            row["smem_bytes"] = M.stats_smem_bytes(args[0])
        elif inst.startswith(("msab_pos_kernel", "msab_pos_masked_kernel")):
            row["smem_bytes"] = M.pos_smem_bytes(args[0], M.POS_TILES[args[0]])
        elif inst.startswith("up_fuse_kernel"):
            row["smem_bytes"] = M.up_smem_bytes(args[0], M.UP_TILES[args[0]])
        else:
            row["smem_bytes"] = M.conv_smem_bytes(args[0], args[2], args[3])
    return out


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
    if device.type == "cuda":
        table = F.encode_table(device)
        exc = [(f"0x{int(np.float32(x).view(np.uint32)):08x}", int(table[255 + 256 + k].item()), k)
               for k, x in enumerate(table[255:255 + 256].tolist()) if not np.isnan(x)]
        t0 = time.perf_counter()
        bad, first = F.encode_check(device)
        log(f"[kernel] threshold encode vs powf encode at all 2^32 float32 bit patterns: {bad} mismatches "
            f"({time.perf_counter() - t0:.2f} s); exceptions kept (bits, code, count): {exc}")
        if bad:
            raise AssertionError(f"threshold encode differs from the powf encode at {bad} floats (first 0x{first:08x})")
    for h, w in shapes:
        for case in kernel_cases(h, w, device, rng):
            errs = [max_lsb(case["run"](x, s), case["plain"](x, s)) for x, s in zip(case["ins"], case["scales"])]
            sync(device)
            err = max(errs)
            if err > TOL_LSB:
                raise AssertionError(f"{case['kernel']} {case['name']} {h}x{w}: {err} LSB from its plain version")
            before = counters()[case["kernel"]]
            it = itertools.count()

            def kernel_call(case=case, it=it):
                i = next(it) % 3  # rotate 3 inputs: more than the L2 cache holds
                case["run"](case["ins"][i], case["scales"][i])

            ms = time_ms(kernel_call, kernel_reps, device)
            if device.type == "cuda" and counters()[case["kernel"]] == before:
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
                before = counters()["blur_uv"]
                it = itertools.count()
                ms = time_ms(lambda: B.blur_uv(ins[next(it) % 3], taps), reps, device)
                if device.type == "cuda" and counters()["blur_uv"] == before:
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
                    library_ratio=None if library_ms is None else ms / library_ms,
                    bound_ms=bound_s * 1e3, bytes=nbytes, ops=ops,
                    bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations",
                )
                rows.append(row)
                lib = "n/a" if library_ms is None else f"{library_ms:.4f} ms, {ms / library_ms:.3f}x its time"
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
            tc_ops=(out_px * cout * 2 * k * k * cin, out_px * cout * (1 if residual else 0)),
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
            tc_ops=(px * (4 * c * c + 2 * c * 31), px * 4 * c),
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
        pos_weights = c * c + c + 18 * c  # wv, bproj, pos0, pos2
        # pass B's first half alone (msab_pos_kernel, counted as
        # msab_apply_kernel): x Wv and x M; two depthwise 3x3s, one GELU and
        # three adds per channel
        cases.append(dict(
            kernel="msab_pos_kernel", counter="msab_apply_kernel", case=f"C={c}", run=lambda: M.msab_pos(x, m, blk),
            plain=lambda: M.msab_pos_plain(x, m, blk), library=None,
            bytes=4 * (2 * px * c + n * c * c + pos_weights),
            ops=px * (2 * c * c * 2 + 2 * 9 * 2 * c + c + 3 * c),
            tc_ops=(px * 4 * c * c, px * (2 * 9 * 2 * c + c + 3 * c)),
        ))
        # x Wv, x M, W0, W4 products; the three depthwise 3x3s; GELU (1
        # each, 3 hidden-size passes of them), LayerNorm (about 8 per
        # channel) and the residual adds
        ops = px * (2 * c * c * 2 + 2 * 4 * c * c * 2 + 2 * 9 * (2 * c + 4 * c) + (c + 2 * 4 * c) + 8 * c + 4 * c)
        cases.append(dict(
            kernel="msab_apply_kernel", case=f"C={c}", run=lambda: M.msab_apply(x, m, blk),
            plain=lambda: M.msab_apply_plain(x, m, blk), library=None,
            bytes=4 * (2 * px * c + n * c * c + weights),
            ops=ops, tc_ops=(px * 20 * c * c, ops - px * 20 * c * c),
        ))

    def up_fuse(lvl):
        hh, ww, c = levels[lvl]
        half = c // 2
        fea, skip = randn(n, hh, ww, c, scale=0.5), randn(n, 2 * hh, 2 * ww, half, scale=0.5)
        uw = M.up_fuse_weights(randn(c, 2, 2, half, scale=0.2), randn(2, 2, half, scale=0.2),
                               randn(c, half, scale=0.2))
        out_px = n * 4 * hh * ww
        # the composed product the kernel (and the JAX kernel) computes: one
        # product of depth C + C/2 per output pixel, plus the bias
        prod = out_px * half * 2 * (c + half)
        cases.append(dict(
            kernel="up_fuse_kernel", case=f"{c}->{half}", run=lambda: M.up_fuse(fea, skip, uw),
            plain=lambda: M.up_fuse_plain(fea, skip, uw), library=None,
            bytes=4 * (n * hh * ww * c + 2 * out_px * half + uw.wc.numel() + uw.bc.numel() + uw.wskip.numel()),
            ops=prod + out_px * half, tc_ops=(prod, out_px * half),
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


def masked_pos_cases(hw: tuple[int, int], n: int, device: torch.device, gen) -> list[dict]:
    """MST-L's masked pos kernel (``msab_pos`` with a gate) at the three
    levels of a padded frame ``hw`` with ``n`` frames per call: x, M' and a
    (1, H, W, C) gate of scale 0.5, weights of scale 0.2. Bytes as
    ``portbench/work/mantis_mstl.py`` counts them: x read, the output
    written and the gate read once per call (12 C per pixel of one frame),
    plus M' and the weights; x Wv and the gated product in 3xTF32, two
    depthwise 3x3s, one GELU, the gate's product and three adds per
    channel."""
    from animal_vision_tpu_torch.ops import fused_msab as M

    def randn(*shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    h, w = hw
    cases = []
    for hh, ww, c in ((h, w, 31), (h // 2, w // 2, 62), (h // 4, w // 4, 124)):
        x, m, gate = randn(n, hh, ww, c, scale=0.5), randn(n, c, c, scale=0.2), randn(1, hh, ww, c, scale=0.5)

        def wt(*shape):
            return randn(*shape, scale=0.2)

        blk = M.MsabWeights(c // 31, wt(c, c), wt(c, c), wt(c, c), 1.0 + wt(c // 31), wt(c, c), wt(c), wt(3, 3, c),
                            wt(3, 3, c), 1.0 + wt(c), wt(c), wt(c, 4 * c), wt(3, 3, 4 * c), wt(4 * c, c))
        px = n * hh * ww
        other = px * (2 * 9 * 2 * c + c + c + 3 * c)
        cases.append(dict(
            kernel="msab_pos_masked_kernel", counter="msab_masked_kernel", case=f"C={c} masked",
            run=lambda x=x, m=m, blk=blk, gate=gate: M.msab_pos(x, m, blk, gate),
            plain=lambda x=x, m=m, blk=blk, gate=gate: M.msab_pos_plain(x, m, blk, gate), library=None,
            bytes=4 * (2 * px * c + hh * ww * c + n * c * c + c * c + c + 18 * c),
            ops=px * 4 * c * c + other, tc_ops=(px * 4 * c * c, other),
        ))
    return cases


def tc_bound(nbytes: int, prod_ops: int, other_ops: int) -> dict:
    """The least time of a kernel whose products run in 3xTF32 on the tensor
    cores: the largest of three TF32 passes over the product operations at
    495 TFLOP/s, the other operations at 67 TFLOP/s (the float32 units run
    beside the tensor cores) and its bytes at 3.35 TB/s."""
    ops_s = max(3 * prod_ops / TF32_OPS_PER_S, other_ops / F32_OPS_PER_S)
    bytes_s = nbytes / HBM_BYTES_PER_S
    return dict(bound_tc_ms=max(ops_s, bytes_s) * 1e3, bound_tc_by="bytes" if bytes_s >= ops_s else "operations")


def mst_error(kernel: str, got, want) -> tuple[float, float]:
    """(max abs error, the figure held to the kernel's tolerance): for the
    stats, the error of each output relative to its largest magnitude."""
    if kernel == "attn_stats_kernel":
        abs_err = max((a - b).abs().max().item() for a, b in zip(got, want))
        return abs_err, max((a - b).abs().max().item() / b.abs().max().item() for a, b in zip(got, want))
    err = (got - want).abs().max().item()
    return err, err


def mst_kernels_phase(device: torch.device, points=MST_POINTS, reps=MST_KERNEL_REPS,
                      plain_reps=MST_PLAIN_REPS, masked=MSTL_MASKED_POINT) -> list[dict]:
    """Each MST++ kernel, then MST-L's masked pos kernel, against its plain
    version on the same inputs; its time, the plain version's, its bound
    and, for the convolution, the library call's."""
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    rows = []
    groups = [(point, hw, n, mst_kernel_cases) for point, (hw, n) in points.items()]
    groups.append((*masked, masked_pos_cases))
    for point, hw, n, make_cases in groups:
        for case in make_cases(hw, n, device, gen):
            kernel = case["kernel"]
            got, want = case["run"](), case["plain"]()
            sync(device)
            abs_err, err = mst_error(kernel, got, want)
            tol = MST_STATS_REL_TOL if kernel == "attn_stats_kernel" else MST_TOL[kernel]
            if not err <= tol:
                raise AssertionError(f"{kernel} {case['case']} at {point}: error {err} from its plain version "
                                     f"(tolerance {tol})")
            counter = case.get("counter", kernel)
            before = counters()[counter]
            ms = time_ms(case["run"], reps, device)
            if device.type == "cuda" and counters()[counter] == before:
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
            lib = "" if library_ms is None else f", library {library_ms:.4f} ms (err {library_err:.2g})"
            tc = ""
            if "tc_ops" in case:
                row.update(tc_bound(case["bytes"], *case["tc_ops"]))
                tc = (f", 3xTF32 bound {row['bound_tc_ms']:.4f} ms by {row['bound_tc_by']}: "
                      f"{row['bound_tc_ms'] / ms:.1%} of it")
                if library_ms is not None:
                    row["library_ratio"] = ms / library_ms
                    tc += f"; {ms / library_ms:.3f}x the library's time"
            rows.append(row)
            log(f"[kernel] {kernel:<17} {case['case']:<22} {point:<7} x{n}: err {err:.3g} (abs {abs_err:.3g}), "
                f"{ms:.4f} ms (plain {plain_ms:.3f} ms{lib}, f32 bound {row['bound_ms']:.4f} ms by "
                f"{row['bound_by']}, {row['bound_ms'] / ms:.1%} of it{tc})")
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
    from animal_vision_tpu_torch.ops import _build
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
        before = counters()["ffn"]
        ms = time_ms(lambda: T.ffn(x, *ws), reps, device)
        if device.type == "cuda" and counters()["ffn"] == before:
            raise AssertionError("ffn_kernel did not launch")
        plain_ms = time_ms(lambda: T.ffn_plain(x, *ws), plain_reps, device, warmup=1)
        px = n * h * w
        nbytes = 4 * (2 * px * c + sum(t.numel() for t in ws))
        prod_ops, other_ops = px * 16 * c * c, px * (72 * c + 8 * c + 8 * c + c)
        ops = prod_ops + other_ops
        bound_s = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
        row = dict(
            kernel="ffn_kernel", case=f"C={c}", point=point, h=h, w=w, frames=n, max_abs_err=err, ms=ms,
            plain_ms=plain_ms, library_ms=None, bound_ms=bound_s * 1e3, bytes=nbytes, ops=ops,
            bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S else "operations",
            tile=list(T.tile_for(c, _build.two_block_smem_limit(torch.cuda.current_device())))
            if device.type == "cuda" else None,
            blocks_per_sm=T.blocks_per_sm(c, torch.cuda.current_device()) if device.type == "cuda" else None,
            **tc_bound(nbytes, prod_ops, other_ops),
        )
        rows.append(row)
        log(f"[kernel] ffn_kernel        {row['case']:<22} {h}x{w} x{n}: err {err:.3g}, {ms:.4f} ms (plain "
            f"{plain_ms:.3f} ms, f32 bound {row['bound_ms']:.4f} ms by {row['bound_by']}, "
            f"{row['bound_ms'] / ms:.1%} of it, 3xTF32 bound {row['bound_tc_ms']:.4f} ms by {row['bound_tc_by']}, "
            f"{row['bound_tc_ms'] / ms:.1%} of it; tile {row['tile']}, {row['blocks_per_sm']} blocks per SM)")
        del x, ws
    return rows


def probe_lib():
    """``csrc/nonuv_probe.cu``'s library and its one entry point."""
    import ctypes

    from animal_vision_tpu_torch.ops import _build

    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.Library("nonuv_probe", {"av_nonuv_probe": [p, p, p, p, p, i, i, i, i, i, i, p]})


def ablation_phase(device: torch.device, hw=MAIN_HW, frames=PROBE_FRAMES, variants=PROBE_VARIANTS,
                   reps=PROBE_REPS) -> dict:
    """The non-UV kernels taken apart (``csrc/nonuv_probe.cu``, the port of
    ``tools/exp_micro.py:28``): each variant over ``frames`` uint8 frames
    of ``hw``, ms per launch and per frame (CUDA events). The table
    variants must give the powf variants' bytes exactly. Raises if a probe
    kernel does not build or launch."""
    from animal_vision_tpu_torch.core import color
    from animal_vision_tpu_torch.ops import fused_nonuv as F
    from animal_vision_tpu_torch.species.nonuv import NONUV_SPECS

    lib = probe_lib()
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    x = torch.randint(0, 256, (frames, *hw, 3), generator=gen, device=device, dtype=torch.uint8)
    scale = F.scale_of(x)
    spec = NONUV_SPECS["dog"]
    mat9 = torch.from_numpy(color.collapse_lms_matrix(spec.alpha, spec.s_scale).reshape(9).copy()).to(device)
    thr = F.encode_table(device)
    outs, rows = {}, []
    for name, curve, mix, k in variants:
        out = torch.empty_like(x)

        def run(out=out, curve=curve, mix=mix, k=k):
            lib.launch("av_nonuv_probe", None, device, x.data_ptr(), out.data_ptr(), scale.data_ptr(),
                       thr.data_ptr(), mat9.data_ptr(), curve, mix, k, frames, *hw)

        run()
        sync(device)
        ms = time_ms(run, reps, device)
        outs[(curve, mix, k)] = out
        rows.append(dict(variant=name, curve=("copy", "powf", "tables")[curve], mix=bool(mix), taps=k, frames=frames,
                         h=hw[0], w=hw[1], ms=ms, ms_per_frame=ms / frames))
        log(f"[ablation] {name:<28} {ms:.4f} ms per launch of {frames} frames, {ms / frames:.4f} ms per frame")
    for a, b in (((1, 0, 0), (2, 0, 0)), ((1, 1, 0), (2, 1, 0)), ((1, 1, 28), (2, 1, 28))):
        if a in outs and b in outs and not torch.equal(outs[a], outs[b]):
            raise AssertionError(f"probe variants {a} and {b} differ by up to {max_lsb(outs[a], outs[b])} LSB")
    return dict(variants=rows)


def probe_sass() -> dict:
    """Per kernel instance of ``csrc/gelu_probe.cu`` (``pointwise<case,T>``,
    ``madd3x3<T>``), the count of each SASS opcode in the built library."""
    from animal_vision_tpu_torch.ops import _build

    cuobjdump = Path(_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "--dump-sass", str(_build.library_path("gelu_probe"))],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    out, current = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(r"(pointwise|madd3x3)_kernelI(?:Li(\d+)E)?NS_\d+(F32|BF16)E", m.group(1))
            current = f"{k.group(1)}<{k.group(2) + ',' if k.group(2) else ''}{k.group(3)}>" if k else m.group(1)
            out[current] = {}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if current is not None and m:
            out[current][m.group(1)] = out[current].get(m.group(1), 0) + 1
    return out


def gelu_probe_phase(device: torch.device, reps=GELU_PROBE_REPS, n_points=GELU_ERF_POINTS) -> dict:
    """The GELU probe (``csrc/gelu_probe.cu``, the port of
    ``tools/exp_vpu_bf16.py:55``): its ten cases (five functions, f32 and
    bf16) on a (4096, 512) array in [-2, 2). First the probe's own run, one
    launch per case, whose counts are the launches. Then each kernel against
    its plain version on the card (``gelu_probe.excess``) after 1, 8 and all
    its applications, on that array and on ``n_points`` evenly spaced
    points in [-8, 8]. Then its time (CUDA events), ns per element
    application, ratio to ``single_madd`` of the same dtype and bound (the
    float32 rate for f32 and for gelu_erf, which computes in float; the
    bf16 rate for the other bf16 cases); ``single_madd``'s steady rate over
    ``GELU_RATE_REPS`` applications; the SASS opcodes of every instance; and
    max |gelu_deg11 - gelu_erf| over the [-8, 8] points."""
    from animal_vision_tpu_torch.ops import _build
    from animal_vision_tpu_torch.ops import gelu_probe as GP

    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    x32 = torch.rand(GP.SHAPE, generator=gen, device=device) * 4 - 2
    pts = torch.linspace(-8.0, 8.0, n_points, device=device).reshape(-1, GP.SHAPE[1])
    tags = {torch.float32: "f32", torch.bfloat16: "bf16"}
    inputs = {dt: x32.to(dt) for dt in tags}
    outs, launches = {}, {}
    for dt, x in inputs.items():
        _build.reset_launches()
        outs.update({(case, dt): GP.run(case, x) for case, _ in GP.CASES})
        sync(device)
        launches[dt] = counters()
    checks = {}
    for (case, dt), full in outs.items():
        rows_checked = []
        for where, x in (("[-2, 2)", inputs[dt]), ("[-8, 8]", pts.to(dt))):
            for n in (*GELU_PROBE_CHECK_REPS, GP.REPS[case]):
                got = full if where == "[-2, 2)" and n == GP.REPS[case] else GP.run(case, x, n)
                with torch.no_grad():
                    want = GP.run_plain(case, x, n)
                err, ratio = GP.excess(case, got, want)
                rows_checked.append(dict(input=where, reps=n, max_abs_err=err, ratio_to_bar=ratio,
                                         max_abs_y=want.float().abs().max().item()))
                if not ratio <= 1:
                    raise AssertionError(f"gelu probe {case} {tags[dt]} on {where} after {n} applications: "
                                         f"{err} from the plain version, {ratio} times its bar")
        checks[(case, dt)] = rows_checked
    rows = []
    for (case, dt), checked in checks.items():
        x, n = inputs[dt], GP.REPS[case]
        ms = time_ms(lambda c=case, x=x: GP.run(c, x), reps, device)
        plain_ms = time_ms(lambda c=case, x=x: GP.run_plain(c, x), 1, device, warmup=1)
        nbytes = 2 * x.numel() * x.element_size()
        ops = GELU_PROBE_OPS[case] * x.numel() * n
        rate = BF16_OPS_PER_S if dt == torch.bfloat16 and case != "gelu_erf" else F32_OPS_PER_S
        rows.append(dict(case=case, dtype=tags[dt], reps=n, shape=list(GP.SHAPE), launches=launches[dt][case],
                         max_abs_err=max(c["max_abs_err"] for c in checked),
                         ratio_to_bar=max(c["ratio_to_bar"] for c in checked), checks=checked, ms=ms,
                         plain_ms=plain_ms, ns_per_elem_app=ms * 1e6 / (x.numel() * n),
                         bound_ms=max(nbytes / HBM_BYTES_PER_S, ops / rate) * 1e3, bound_rate_ops_per_s=rate,
                         bound_by="bytes" if nbytes / HBM_BYTES_PER_S > ops / rate else "operations"))
    for r in rows:
        madd = next(q for q in rows if q["case"] == "single_madd" and q["dtype"] == r["dtype"])
        r["ratio_to_single_madd"] = r["ns_per_elem_app"] / madd["ns_per_elem_app"]
        r["bound_share"] = r["bound_ms"] / r["ms"]
        log(f"[gelu probe] {r['case']:<11} {r['dtype']:<4} {r['ms']:.4f} ms per call of {r['reps']} applications, "
            f"{r['ns_per_elem_app']:.4g} ns per element application ({r['ratio_to_single_madd']:.2f}x single_madd), "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, {r['bound_share']:.1%}); plain {r['plain_ms']:.1f} ms; "
            f"max err {r['max_abs_err']:.3g} ({r['ratio_to_bar']:.3g} of its bar) over 1, 8 and {r['reps']} "
            f"applications on [-2, 2) and [-8, 8]")
    steady = {}
    for dt, x in inputs.items():
        ms = time_ms(lambda x=x: GP.run("single_madd", x, GELU_RATE_REPS), reps, device)
        ops_per_s = 2 * x.numel() * GELU_RATE_REPS / (ms * 1e-3)
        steady[tags[dt]] = dict(reps=GELU_RATE_REPS, ms=ms, ops_per_s=ops_per_s, f32_peak_share=ops_per_s / F32_OPS_PER_S,
                                bf16_peak_share=ops_per_s / BF16_OPS_PER_S)
        log(f"[gelu probe] single_madd {tags[dt]} over {GELU_RATE_REPS} applications: {ms:.4f} ms, "
            f"{ops_per_s / 1e12:.2f} TFLOP/s ({ops_per_s / F32_OPS_PER_S:.1%} of the f32 peak, "
            f"{ops_per_s / BF16_OPS_PER_S:.1%} of the bf16 peak)")
    sass = probe_sass()
    float_ops = ("FFMA", "FMUL", "FADD", "FMNMX", "HFMA2", "HMUL2", "HADD2", "HMNMX2", "F2F", "PRMT", "MUFU")
    for inst, ops in sorted(sass.items()):
        shown = {op: c for op, c in ops.items() if op.split(".")[0] in float_ops}
        log(f"[gelu probe] SASS {inst}: {sum(ops.values())} instructions; "
            + ", ".join(f"{op} {c}" for op, c in sorted(shown.items())))
    deg11_vs_erf = (GP.run("gelu_deg11", pts, 1) - GP.run("gelu_erf", pts, 1)).abs().max().item()
    by = {(r["case"], r["dtype"]): r for r in rows}
    ratios = {tag: by[("gelu_erf", tag)]["ms"] / by[("gelu_deg11", tag)]["ms"] for tag in ("f32", "bf16")}
    bf16_speedup = {case: by[(case, "f32")]["ms"] / by[(case, "bf16")]["ms"] for case, _ in GP.CASES}
    log(f"[gelu probe] max |gelu_deg11 - gelu_erf| over {n_points} points in [-8, 8]: {deg11_vs_erf:.3g}; "
        f"erf / deg-11 time: f32 {ratios['f32']:.2f}, bf16 {ratios['bf16']:.2f}; f32 / bf16 time: "
        + ", ".join(f"{k} {v:.2f}" for k, v in bf16_speedup.items()))
    return dict(cases=rows, deg11_vs_erf_max_abs=deg11_vs_erf, erf_over_deg11_ms=ratios,
                f32_over_bf16_ms=bf16_speedup, steady_single_madd=steady, sass_opcodes=sass)


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------


def counted_run(animals: dict, host: np.ndarray, frames: torch.Tensor, device: torch.device, inputs=None):
    """The run the launch counters are read around: the counters set to 0,
    then once through each entry point per species (``host[0]`` through
    ``visualize``, ``frames`` through ``visualize_batch_device``, or the
    species' own (host, frames) in ``inputs``) with the plain versions
    barred from CUDA tensors, then the counters read.
    Returns (launches per species, outputs per species, launches)."""
    per_species = {}
    outputs = {}
    inputs = inputs or {}
    with plain_forbidden_on_cuda():
        reset_counters()
        for name, animal in animals.items():
            own_host, own_frames = inputs.get(name, (host, frames))
            before = counters()
            base1, out1 = animal.visualize(own_host[0])
            base_b, out_b = animal.visualize_batch_device(own_frames)
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
    """The 16 UV species through both entry points, counters around the
    run; each against its plain composition on the card and against the CPU
    path on a small frame (>= 40 dB, baselines within 1 LSB); fps. rat_uv
    gets the same frames with the second and fourth darkened to 5% (night
    by its median luma), so that its batch takes both renderings; each
    frame of its batch must equal the frame through ``visualize``."""
    from animal_vision_tpu_torch.species import PORTED_UV_NAMES, get_animal
    from animal_vision_tpu_torch.species.uv.rat_uv import RatUV

    rng = np.random.default_rng(SEED + 3)
    h, w = hw
    host = rng.integers(0, 256, (batch, h, w, 3), dtype=np.uint8)
    frames = torch.from_numpy(host).to(device)
    rat_host = host.copy()
    rat_host[1::2] = (rat_host[1::2] * 0.05).astype(np.uint8)
    rat_frames = torch.from_numpy(rat_host).to(device)
    nights = RatUV.is_night(rat_frames).flatten().tolist()
    if nights != [i % 2 == 1 for i in range(batch)]:
        raise AssertionError(f"rat_uv: night frames {nights}, expected every second one")
    inputs = {"rat_uv": (rat_host, rat_frames)}
    animals = {name: get_animal(name, device) for name in PORTED_UV_NAMES}
    sync(device)

    per_species_launches, outputs, launches = counted_run(animals, host, frames, device, inputs)
    log(f"[main] launches over the UV main-path run: {launches}")

    results = {}
    for name, animal in animals.items():
        own_host, own_frames = inputs.get(name, (host, frames))
        moved = per_species_launches[name]
        if device.type == "cuda" and (moved["blur_uv"] < 2 or sum(moved.values()) != moved["blur_uv"]):
            raise AssertionError(f"{name}: expected blur_uv launches only, counted {moved}")
        base1, out1, base_b, out_b = outputs[name]
        if out1.shape != (h, w, 3) or out1.dtype != np.uint8 or tuple(out_b.shape) != (batch, h, w, 3):
            raise AssertionError(f"{name}: output {out1.shape} {out1.dtype}, batch {tuple(out_b.shape)}")
        plain_base, plain = animal.plain_transform((h, w, 3), np.uint8)(own_frames)
        db = min(psnr_db(out_b, plain), psnr_db(torch.from_numpy(out1), plain[0]))
        lsb = max(max_lsb(out_b, plain), max_lsb(torch.from_numpy(out1).to(device), plain[0]))
        base_lsb = max(max_lsb(base_b, plain_base), max_lsb(torch.from_numpy(base1).to(device), plain_base[0]))
        batch_vs_frame = max_lsb(out_b[0], torch.from_numpy(out1).to(device))
        if name in inputs:
            # every frame of the batch against the frame alone, bit for bit
            for i in range(1, batch):
                batch_vs_frame = max(batch_vs_frame, max_lsb(out_b[i], torch.from_numpy(
                    animal.visualize(own_host[i])[1]).to(device)))
            if batch_vs_frame != 0:
                raise AssertionError(f"{name}: a frame of the batch is {batch_vs_frame} LSB from the frame alone")
        small = rng.integers(0, 256, (*small_hw, 3), dtype=np.uint8)
        ref_b, ref = get_animal(name, "cpu").visualize(small)
        got_b, got = animal.visualize(small)
        small_db = psnr_db(torch.from_numpy(got), torch.from_numpy(ref))
        small_lsb = max_lsb(torch.from_numpy(got), torch.from_numpy(ref))
        small_base_lsb = max_lsb(torch.from_numpy(got_b), torch.from_numpy(ref_b))
        if db < UV_MIN_DB or small_db < UV_MIN_DB or base_lsb > TOL_LSB or small_base_lsb > TOL_LSB:
            raise AssertionError(f"{name}: {db:.2f} dB from the plain path at {h}x{w} (baseline {base_lsb} LSB), "
                                 f"{small_db:.2f} dB from the CPU path at {small_hw} (baseline {small_base_lsb} LSB)")

        def one(animal=animal, own_host=own_host):
            animal.visualize(own_host[0])

        def batched(animal=animal, own_frames=own_frames):
            animal.visualize_batch_device(own_frames)
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
        frames_note = "batch vs visualize (all frames)" if name in inputs else "batch[0] vs visualize"
        log(f"[main] {name:<9} blur_uv x{moved['blur_uv']:<3} {db:.2f} dB / max {lsb} LSB vs plain (baseline "
            f"{base_lsb} LSB), {small_db:.2f} dB / max {small_lsb} LSB vs CPU at {small_hw[0]}x{small_hw[1]}; "
            f"{frames_note} max {batch_vs_frame} LSB; visualize {results[name]['visualize_fps']:7.1f} fps "
            f"(median {vis['median']:.3f} ms, p90 {vis['p90']:.3f} ms), batch of {batch} on device "
            f"{results[name]['batch_fps']:7.1f} fps (median {bat['median']:.3f} ms, p90 {bat['p90']:.3f} ms, "
            f"n={bat['n']})")

    def harmonic(names, key):
        return len(names) / sum(1.0 / results[n][key] for n in names)

    earlier = [n for n in results if n != "rat_uv"]
    return dict(species=results, launches=launches, hm_fps=harmonic(list(results), "batch_fps"),
                hm_visualize_fps=harmonic(list(results), "visualize_fps"),
                hm_fps_without_rat_uv=harmonic(earlier, "batch_fps"),
                hm_visualize_fps_without_rat_uv=harmonic(earlier, "visualize_fps"))


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

    expected = {**MST_PER_FORWARD, **MST_FFN_PER_FORWARD}
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
            per_item[label] = {k: v - before[k] for k, v in counters().items() if k in expected}
        sync(device)
        launches = counters()
    log(f"[main] launches over the MST++ main-path run ({len(items)} forwards): "
        f"{ {k: launches[k] for k in expected} }")
    for label, moved in per_item.items():
        if device.type == "cuda" and moved != expected:
            raise AssertionError(f"{label}: expected {expected} MST++ launches per forward, counted {moved}")

    with torch.no_grad():
        got = outputs["forward"]
        want = model(x, plain=True)
        err = (got - want).abs().max().item()
        if not (got.shape == (1, h, w, 31) and torch.isfinite(got).all().item() and err < MST_FORWARD_TOL):
            raise AssertionError(f"MST++ forward at {h}x{w}: shape {tuple(got.shape)}, {err} from the plain forward")
        forward = wall_ms(lambda: (model(x), sync(device)), reps)
        plain_forward = wall_ms(lambda: (model(x, plain=True), sync(device)), 1)
        # the host's part of each forward's weight lookup: the version stamp of every parameter on a cache hit
        lookup = wall_ms(lambda: model.weights(device), 200)
    log(f"[main] MST++ {h}x{w} forward: max {err:.3g} from the plain forward; median {forward['median']:.2f} ms "
        f"(p90 {forward['p90']:.2f}), plain {plain_forward['median']:.1f} ms; weight lookup "
        f"{lookup['median'] * 1e3:.1f} us (p90 {lookup['p90'] * 1e3:.1f})")
    result = dict(forward_max_abs_err=err, forward_ms=forward, plain_forward_ms=plain_forward,
                  weights_lookup_ms=lookup, launches=launches, per_forward=per_item, species={})

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
    before that run and read after it: 27 ``ffn``, ``attn_stats_kernel``
    and ``msab_masked_kernel`` launches per MST-L forward (one per frame),
    the MST++ counts per MST++ forward. Then each
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

    mstl = {k: MSTL_PER_FORWARD for k in ("ffn", "attn_stats_kernel", "msab_masked_kernel")}
    items = {"forward": (lambda: model(x), mstl)}
    for name, animal in animals.items():
        mst_pp = name.endswith("mst++")
        one = {**MST_PER_FORWARD, **MST_FFN_PER_FORWARD} if mst_pp else mstl
        many = one if mst_pp else {k: v * batch for k, v in mstl.items()}  # MST-L: one forward per frame
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


def zoo_views_mean(model, x: torch.Tensor) -> torch.Tensor:
    """The mean of ``model`` over the eight flip/transpose views of x, each
    output taken back through its view: the self-ensemble written out."""
    outs = []
    for xf, yf, tr in itertools.product((False, True), repeat=3):
        v = x.flip(2) if xf else x
        v = v.flip(1) if yf else v
        v = v.transpose(1, 2) if tr else v
        y = model(v.contiguous())
        y = y.transpose(1, 2) if tr else y
        y = y.flip(1) if yf else y
        outs.append(y.flip(2) if xf else y)
    return sum(outs) / len(outs)


def zoo_phase(device: torch.device, methods=ZOO_METHODS, hw=MAIN_HW, batch=BATCH, small=ZOO_SMALL,
              reps=ZOO_FORWARD_REPS, species_reps=ZOO_SPECIES_REPS, tiling=ZOO_TILE, ensemble=ZOO_ENSEMBLE) -> dict:
    """The zoo's nine other methods with seeded weights, through the entry
    points a user calls (``zoo.model_generator``, ``providers.attach_model``,
    ``tiling.predict_tiled``, ``ensemble.forward_ensemble``). For each: the
    forward on the card against the same model on the CPU at ``small``
    (within 1e-4 of max |y|; TF32 off); one 1080p forward (AWAN through
    ``predict_tiled``): its FLOPs (``FlopCounterMode``, as
    ``models/summary.py`` counts them: matrix products and convolutions),
    peak memory and output check from a first call, ms (median of the next
    ``reps``, host clock ended by a synchronize), the share of 67 TFLOP/s,
    and the device busy share from a profiled call; then kestrel with
    ``attach_model`` on ``batch`` 1080p frames through ``visualize`` and
    ``visualize_batch_device`` (the provider sees 270x480 frames), the
    ``blur_uv`` launches counted and the peak memory read around that run,
    fps, and the CPU path on a
    small frame at >= 40 dB with the baseline within 1 LSB, and the top
    kernels of one profiled batch. Last, one
    ``forward_ensemble("mean")`` at 272x480 against the mean of the eight
    forwards written out."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    from animal_vision_tpu_torch.models import ensemble as E
    from animal_vision_tpu_torch.models import tiling as TL
    from animal_vision_tpu_torch.models import zoo
    from animal_vision_tpu_torch.models.providers import attach_model
    from animal_vision_tpu_torch.species.uv.kestrel import Kestrel

    rng = np.random.default_rng(SEED + 13)
    h, w = hw
    host = rng.integers(0, 256, (batch, h, w, 3), dtype=np.uint8)
    frames = torch.from_numpy(host).to(device)
    x = (frames[:1].to(torch.float32) / 255.0).contiguous()
    small_host = rng.integers(0, 256, (*SMALL_HW, 3), dtype=np.uint8)
    tile, overlap, per_call = tiling
    result = {}
    for method in methods:
        t_method = time.perf_counter()
        model = zoo.model_generator(method, device=device, seed=SEED)
        cpu_model = zoo.model_generator(method, device="cpu", seed=SEED)
        errs = []
        with torch.no_grad():
            for sh, sw in small:
                xs = torch.from_numpy(rng.random((1, sh, sw, 3), dtype=np.float32))
                want = cpu_model(xs)
                got = model(xs.to(device)).cpu()
                scale = max(1.0, want.abs().max().item())
                err = (got - want).abs().max().item()
                if not (got.shape == (1, sh, sw, 31) and torch.isfinite(got).all().item() and err <= ZOO_REL_TOL * scale):
                    raise AssertionError(f"{method} at {sh}x{sw}: {err} from the CPU (max |y| {scale})")
                errs.append(dict(hw=[sh, sw], max_abs_err=err, max_abs=scale))
        del cpu_model

        if method == "awan":
            def apply_fn(t, m=model):
                return torch.cat([m(t[i:i + per_call]) for i in range(0, t.shape[0], per_call)])

            def forward(m=model):
                return TL.predict_tiled(apply_fn, x[0], tile=tile, overlap=overlap)[None]
        else:
            def forward(m=model):
                return m(x)
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        base_mem = torch.cuda.memory_allocated(device) if cuda else 0
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            y = forward()
            sync(device)
        flops = counter.get_total_flops()
        peak = torch.cuda.max_memory_allocated(device) - base_mem if cuda else 0
        if not (y.shape == (1, h, w, 31) and torch.isfinite(y).all().item()):
            raise AssertionError(f"{method} 1080p forward: shape {tuple(y.shape)} or not finite")
        del y
        with torch.no_grad():
            fw = wall_ms(lambda: (forward(), sync(device)), reps, warmup=False)
            with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
                t0 = time.perf_counter()
                forward()
                sync(device)
                wall_us = (time.perf_counter() - t0) * 1e6
        events = trace_device_events(prof)
        busy = busy_us(events) / wall_us
        tflops = flops / (fw["median"] * 1e-3) / 1e12
        row = dict(small=errs, forward_ms=fw, flops=flops, tflops=tflops, f32_peak_share=tflops * 1e12 / F32_OPS_PER_S,
                   peak_bytes=peak, device_busy_share=busy, tiled=method == "awan", top_kernels=top_kernels(events))
        log(f"[zoo] {method:<10} card vs CPU max {max(e['max_abs_err'] for e in errs):.3g} (of max |y| "
            f"{max(e['max_abs'] for e in errs):.3g}); {h}x{w}{' tiled' if method == 'awan' else ''}: median "
            f"{fw['median']:.1f} ms (p90 {fw['p90']:.1f}), {flops / 1e12:.3f} TFLOP, {tflops:.2f} TFLOP/s = "
            f"{row['f32_peak_share']:.1%} of 67, peak {peak / 2 ** 30:.2f} GiB, device busy {busy:.1%}; top kernels "
            + "; ".join(f"{k[:56]} {v:.1f} ms" for k, v in row["top_kernels"]))
        del model
        if cuda:
            torch.cuda.empty_cache()

        animal = attach_model(Kestrel(device), method)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        base_mem = torch.cuda.memory_allocated(device) if cuda else 0
        with torch.no_grad(), plain_forbidden_on_cuda():
            reset_counters()
            base1, out1 = animal.visualize(host[0])
            base_b, out_b = animal.visualize_batch_device(frames)
            sync(device)
            launches = counters()
        kestrel_peak = torch.cuda.max_memory_allocated(device) - base_mem if cuda else 0
        if cuda and launches["blur_uv"] == 0:
            raise AssertionError(f"kestrel+{method}: no blur_uv launch on the main path")
        no_rungs(f"zoo {method}")
        if out1.shape != (h, w, 3) or tuple(out_b.shape) != (batch, h, w, 3):
            raise AssertionError(f"kestrel+{method}: output shapes {out1.shape}, {tuple(out_b.shape)}")
        cpu_animal = attach_model(Kestrel("cpu"), method)
        with torch.no_grad():
            cpu_base, cpu_out = cpu_animal.visualize(small_host)
            card_base, card_out = animal.visualize(small_host)
        db = psnr_db(torch.from_numpy(card_out), torch.from_numpy(cpu_out))
        base_lsb = max_lsb(torch.from_numpy(card_base), torch.from_numpy(cpu_base))
        if db < UV_MIN_DB or base_lsb > TOL_LSB:
            raise AssertionError(f"kestrel+{method}: {db:.2f} dB from the CPU path (baseline {base_lsb} LSB)")
        del cpu_animal
        vis = wall_ms(lambda: animal.visualize(host[0]), species_reps)
        bat = wall_ms(lambda: (animal.visualize_batch_device(frames), sync(device)), species_reps)
        with torch.no_grad(), profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
            animal.visualize_batch_device(frames)
            sync(device)
        batch_top = top_kernels(trace_device_events(prof))
        no_rungs(f"zoo {method} timing")
        row.update(kestrel=dict(psnr_cpu_db=db, baseline_max_lsb_cpu=base_lsb, blur_uv_launches=launches["blur_uv"],
                                peak_bytes=kestrel_peak,
                                visualize_ms=vis, visualize_fps=1e3 / vis["median"], batch_ms=bat,
                                batch_fps=batch * 1e3 / bat["median"], batch_top_kernels=batch_top))
        log(f"[zoo] kestrel+{method:<10} {db:.2f} dB vs the CPU (baseline {base_lsb} LSB), blur_uv launches "
            f"{launches['blur_uv']}, peak {kestrel_peak / 2 ** 30:.2f} GiB; visualize {1e3 / vis['median']:.2f} fps, "
            f"batch of {batch} on device "
            f"{batch * 1e3 / bat['median']:.2f} fps (top kernels of a batch: "
            + "; ".join(f"{k[:56]} {v:.1f} ms" for k, v in batch_top) + f"); {time.perf_counter() - t_method:.1f} s")
        del animal
        if cuda:
            torch.cuda.empty_cache()
        result[method] = row

    method, (eh, ew) = ensemble
    model = zoo.model_generator(method, device=device, seed=SEED)
    xe = torch.from_numpy(rng.random((1, eh, ew, 3), dtype=np.float32)).to(device)
    with torch.no_grad():
        got = E.forward_ensemble(model, xe, "mean")
        want = zoo_views_mean(model, xe)
    err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item())
    if not (got.shape == (1, eh, ew, 31) and err <= ZOO_ENSEMBLE_REL_TOL * scale):
        raise AssertionError(f"forward_ensemble({method}) at {eh}x{ew}: {err} from the mean of its views")
    log(f"[zoo] forward_ensemble(mean) of {method} at {eh}x{ew}: max {err:.3g} from the mean of its 8 forwards")
    result["ensemble"] = dict(method=method, hw=[eh, ew], max_abs_err=err, max_abs=scale)
    return result


def wall_ms(fn, reps: int, warmup: bool = True) -> dict:
    """Host-clock milliseconds of ``reps`` calls, each ending synchronized,
    after one untimed call unless ``warmup`` is False: median and p90 (the
    highest percentile with 10 samples beyond it at 100 calls)."""
    if warmup:
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


def degrade_phase(device: torch.device, hw=MAIN_HW, names=DEGRADE_SPECIES, budget=DEGRADE_BUDGET,
                  oom_hw=OOM_HW, free_bytes=OOM_FREE_BYTES) -> dict:
    """The degradation ladder of ``visualize``. Budget part: with
    ``ANIMAL_VISION_MAX_PIXELS`` set, each species (a fresh instance) on a
    1080p frame takes rung 1024 (576x1024), builds no full-size program and
    equals the explicit composition (host area-down, ``visualize``, host
    linear-up) bit for bit. Real OOM: a tensor holds all of the card's free
    memory but ``free_bytes``; rat_uv on a 2160x3840 frame must go down the
    ladder and equal the composition at the rung it took; with the tensor
    released, the same frame must take the exact path."""
    import gc
    import os

    from animal_vision_tpu_torch.species import base
    from animal_vision_tpu_torch.species.nonuv import NONUV_SPECS, Cat, NonUVAnimal
    from animal_vision_tpu_torch.species.uv.kestrel import Kestrel
    from animal_vision_tpu_torch.species.uv.rat_uv import RatUV

    make = {"dog": lambda: NonUVAnimal(NONUV_SPECS["dog"], device), "cat": lambda: Cat(device),
            "rat_uv": lambda: RatUV(device), "kestrel": lambda: Kestrel(device)}
    rng = np.random.default_rng(SEED + 6)

    def composition(animal, image, side):
        h, w = image.shape[:2]
        sh, sw = base.rung_shape(h, w, side)
        b, o = animal.visualize(base.host_resize(image, sh, sw, "area"))
        return base.host_resize(b, h, w, "linear"), base.host_resize(o, h, w, "linear")

    def taken(before):
        moved = [side for side in base.RUNGS if base.RUNGS[side] != before[side]]
        if len(moved) != 1 or base.RUNGS[moved[0]] != before[moved[0]] + 1:
            raise AssertionError(f"expected one frame served at one rung, rungs {before} -> {base.RUNGS}")
        return moved[0]

    host = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    full = (*hw, 3)
    budget_rows = {}
    for name in names:
        animal = make[name]()
        before = dict(base.RUNGS)
        os.environ["ANIMAL_VISION_MAX_PIXELS"] = str(budget)
        try:
            t0 = time.perf_counter()
            got = animal.visualize(host)
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            del os.environ["ANIMAL_VISION_MAX_PIXELS"]
        side = taken(before)
        shapes = sorted({k[0] for k in animal._programs})
        want = composition(animal, host, side)
        equal = all(np.array_equal(g, x) for g, x in zip(got, want))
        if side != 1024 or full in shapes or not equal or got[1].shape != full:
            raise AssertionError(f"{name} under a budget of {budget} px: rung {side}, programs {shapes}, "
                                 f"equal to the composition: {equal}")
        budget_rows[name] = dict(rung=side, programs=shapes, equal=equal, first_call_ms=ms)
        log(f"[degrade] {name:<8} ANIMAL_VISION_MAX_PIXELS={budget} at {hw[0]}x{hw[1]}: rung {side} "
            f"({shapes}), equal to the composition bit for bit; first call {ms:.1f} ms")

    rat = make["rat_uv"]()
    big = rng.integers(0, 256, (*oom_hw, 3), dtype=np.uint8)
    gc.collect()
    sync(device)
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(device)
    hold = torch.empty(free - free_bytes, dtype=torch.uint8, device=device)
    left = torch.cuda.mem_get_info(device)[0]
    before = dict(base.RUNGS)
    t0 = time.perf_counter()
    got = rat.visualize(big)
    ladder_ms = (time.perf_counter() - t0) * 1e3
    side = taken(before)
    shapes = sorted({k[0] for k in rat._programs})
    del hold
    torch.cuda.empty_cache()
    want = composition(rat, big, side)
    equal = all(np.array_equal(g, x) for g, x in zip(got, want))
    if (*oom_hw, 3) in shapes or not equal or got[1].shape != (*oom_hw, 3):
        raise AssertionError(f"rat_uv on {oom_hw} with {left} bytes free: rung {side}, programs {shapes}, "
                             f"equal to the composition: {equal}")
    log(f"[degrade] rat_uv {oom_hw[0]}x{oom_hw[1]} with {left / 2**30:.3f} GiB of {total / 2**30:.1f} GiB free: "
        f"device OOM, rung {side} ({shapes}), equal to the composition bit for bit; {ladder_ms:.1f} ms")
    before = dict(base.RUNGS)
    t0 = time.perf_counter()
    exact = rat.visualize(big)
    exact_ms = (time.perf_counter() - t0) * 1e3
    if base.RUNGS != before or (*oom_hw, 3) not in {k[0] for k in rat._programs}:
        raise AssertionError(f"rat_uv on {oom_hw} with the memory released did not take the exact path")
    db = psnr_db(torch.from_numpy(got[1]), torch.from_numpy(exact[1]))
    log(f"[degrade] rat_uv {oom_hw[0]}x{oom_hw[1]} with the memory released: exact path, {exact_ms:.1f} ms; "
        f"the ladder's output {db:.2f} dB from it")
    base.reset_rungs()
    return dict(budget=budget, budget_species=budget_rows,
                oom=dict(hw=oom_hw, free_bytes=left, total_bytes=total, rung=side, programs=shapes, equal=equal,
                         ladder_ms=ladder_ms, exact_ms=exact_ms, psnr_vs_exact_db=db))


def library_phase(device: torch.device, hw=LIBRARY_HW, batch=BATCH // 2, tol=LIBRARY_TOL) -> dict:
    """The library functions that no species calls, and the Mallett
    upsampler, on the card against the port on the CPU (max abs error
    <= ``tol``), on a batch of float32 frames in [0, 1] (maps as one
    channel); ``unsharp_mask`` and ``dog_bandpass`` launch ``blur_uv``
    (1 and 2 launches), counted around their calls."""
    from animal_vision_tpu_torch.core import blur, color, effects, geometry
    from animal_vision_tpu_torch.spectral import bands, classic, mappers

    h, w = hw
    rng = np.random.default_rng(SEED + 7)
    x = torch.from_numpy(rng.random((batch, h, w, 3), dtype=np.float32))
    m = x[..., :1].contiguous()
    cube = torch.from_numpy(rng.random((batch, h // 4, w // 4, 81), dtype=np.float32))
    lam = np.linspace(300.0, 700.0, 81, dtype=np.float32)
    map_x = rng.uniform(-5, w + 5, (h, w)).astype(np.float32)
    map_y = rng.uniform(-5, h + 5, (h, w)).astype(np.float32)
    fns = {
        "integrate_band": (lambda c: bands.integrate_band(c, lam, 320.0, 400.0), cube),
        "integrate_uv": (lambda c: bands.integrate_uv(c, lam, 320.0, 400.0), cube),
        "map_uv_purple_yellow": (mappers.map_uv_purple_yellow, m),
        "gaussian_blur": (lambda t: blur.gaussian_blur(t, 1.3, 2.1), x),
        "gaussian_blur_hw": (lambda t: blur.gaussian_blur_hw(t, 1.7), x[..., 0].contiguous()),
        "tapetum_bloom": (effects.tapetum_bloom, x),
        "rod_vision": (effects.rod_vision, x),
        "unsharp_mask": (lambda t: effects.unsharp_mask(t, 1.0, 0.3), x),
        "dog_bandpass": (lambda t: effects.dog_bandpass(t, 0.8, 2.5), m),
        "remap_bilinear": (lambda t: geometry.remap_bilinear(t, map_x, map_y), x),
        "center_zoom": (lambda t: geometry.center_zoom(t, 1.37), x),
        "binocular_fov_warp": (lambda t: geometry.binocular_fov_warp(t, 100.0, 105.0, 40.0), x),
        "merge_l_m": (lambda t: color.merge_l_m(t, 0.58), x),
        "srgb_to_lms": (color.srgb_to_lms, x),
        "lms_to_rgb": (color.lms_to_rgb, x),
        "classic_rgb_to_hsi mallett": (lambda t: classic.classic_rgb_to_hsi(t, lam, mode="mallett"), x),
    }
    expected_launches = {"unsharp_mask": 1, "dog_bandpass": 2}
    rows = {}
    with plain_forbidden_on_cuda():
        for name, (fn, inp) in fns.items():
            before = counters()["blur_uv"]
            got = fn(inp.to(device))
            sync(device)
            launches = counters()["blur_uv"] - before
            want = fn(inp)
            err = (got.cpu() - want).abs().max().item()
            ms = time_ms(lambda fn=fn, t=inp.to(device): fn(t), 5, device)
            want_launches = expected_launches.get(name, 0) if device.type == "cuda" else 0
            if not err <= tol or launches != want_launches or got.shape != want.shape:
                raise AssertionError(f"{name}: {err} from the CPU, {launches} blur_uv launches, "
                                     f"shape {tuple(got.shape)}")
            rows[name] = dict(max_abs_err=err, blur_uv_launches=launches, ms=ms, shape=list(got.shape))
            log(f"[library] {name:<27} {tuple(inp.shape)} -> {tuple(got.shape)}: max {err:.3g} from the CPU, "
                f"blur_uv x{launches}, {ms:.3f} ms")
    return rows


# ---------------------------------------------------------------------------
# Phase 4b: host frames through the streaming executor
# ---------------------------------------------------------------------------


def trace_events(prof) -> list[dict]:
    """The events of a ``torch.profiler`` run, from its Chrome trace."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return json.loads(path.read_text())["traceEvents"]


def device_events(events: list[dict]) -> list[dict]:
    """The device-side events of a trace (kernels, memcpys, memsets): name,
    category, stream, start and duration in µs, bytes, correlation id."""
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            args = e.get("args", {})
            out.append(dict(name=e["name"], cat=e["cat"], stream=args.get("stream"), ts=float(e["ts"]),
                            dur=float(e["dur"]), bytes=int(args.get("bytes", 0)), correlation=args.get("correlation")))
    return out


def trace_device_events(prof) -> list[dict]:
    return device_events(trace_events(prof))


def top_kernels(events: list[dict], n: int = 3) -> list[tuple[str, float]]:
    """The ``n`` kernel names with the most device time in ``events``, with
    their summed milliseconds."""
    by = {}
    for e in events:
        if e["cat"] == "kernel":
            by[e["name"]] = by.get(e["name"], 0.0) + e["dur"] / 1e3
    return sorted(by.items(), key=lambda kv: -kv[1])[:n]


def busy_us(events: list[dict]) -> float:
    """Length of the union of the events' intervals (µs): the time the card
    was doing anything, however many streams ran at once."""
    total, end = 0.0, None
    for e in sorted(events, key=lambda e: e["ts"]):
        lo, hi = e["ts"], e["ts"] + e["dur"]
        if end is None or lo > end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total


def record_match(raw: list[dict], events: list[dict], within: tuple[float, float] | None = None) -> dict:
    """How a trace's device records match the runtime's calls, by
    correlation id, for the calls that start inside ``within`` (µs, the
    whole trace when None): memcpy calls and kernel launches, the count of
    each, the calls without a record (their order among the memcpy calls
    or launches and µs after the first), and the least and largest start of
    a memcpy record after its call (µs; below 0 where the device's clock
    runs ahead of the host's in the trace)."""
    lo, hi = within or (-np.inf, np.inf)
    calls = sorted((e for e in raw if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and "correlation" in e.get("args", {}) and lo <= float(e["ts"]) <= hi),
                   key=lambda e: float(e["ts"]))
    records = {e["correlation"]: e for e in events}

    def missing(group):
        return [dict(order=i, after_first_us=float(c["ts"]) - float(group[0]["ts"]))
                for i, c in enumerate(group) if c["args"]["correlation"] not in records]

    memcpys = [c for c in calls if c["name"].startswith("cudaMemcpy")]
    launches = [c for c in calls if "LaunchKernel" in c["name"]]
    lags = [records[c["args"]["correlation"]]["ts"] - float(c["ts"]) for c in memcpys
            if c["args"]["correlation"] in records]
    lost = missing(memcpys)
    return dict(memcpy_calls=len(memcpys), memcpy_records=len(memcpys) - len(lost), calls_without_record=lost,
                launches=len(launches), launches_without_record=missing(launches),
                record_lag_us=[min(lags), max(lags)] if lags else None)


def profiled_stream_run(ex, frames: list, wants: list, on_card: bool) -> dict:
    """``ex.run`` of ``frames`` twice in one ``torch.profiler`` session,
    the second inside a ``record_function`` range: the device events whose
    runtime calls lie in that range (the checked run), its wall µs, whether
    every frame of it equals ``wants``, and how the trace's records match
    the runtime's calls in each run (``record_match``). The first run
    absorbs the records the profiler can drop at the start of a session:
    after the zoo phase, each session lost the record of its first memcpy
    call (and for some species of its first kernel launch), its runtime
    call in the trace and its frames right, while every later record
    arrived (PR 12)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    outs = []
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        ex.run(iter(frames), lambda _frame: None)
        with record_function("checked run"):
            t0 = time.perf_counter()
            ex.run(iter(frames), outs.append)
            wall_us = (time.perf_counter() - t0) * 1e6
    raw = trace_events(prof)
    events = device_events(raw)
    span = next((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in raw
                if e.get("ph") == "X" and e.get("name") == "checked run")
    checked = {e["args"]["correlation"] for e in raw if e.get("ph") == "X" and "correlation" in e.get("args", {})
               and e.get("cat") in ("cuda_runtime", "cuda_driver") and span[0] <= float(e["ts"]) <= span[1]}
    return dict(events=[e for e in events if e["correlation"] in checked], wall_us=wall_us,
                outputs_equal=len(outs) == len(wants) and all(np.array_equal(a, b) for a, b in zip(outs, wants)),
                **record_match(raw, events, span), first_run=record_match(raw, events, (-np.inf, span[0])))


def stream_phase(device: torch.device, reference: dict, names=STREAM_SPECIES, n_frames=STREAM_FRAMES,
                 batch=STREAM_BATCH, runs=STREAM_RUNS, hw=MAIN_HW) -> dict:
    """Host frames through ``StreamingExecutor(batch, split=False)``: for
    each species, ``n_frames`` uint8 frames made before the clock (so that
    the last batch is short). Hard checks: every frame comes out, in order,
    bit-equal to ``visualize_batch`` of its batch on the card; the frames
    went through the native ring built in ``build/native/``; each batch
    launched the species' kernel (counters set to 0 before the run, read
    after); in one ``torch.profiler`` run every memcpy of frame data (host
    to card or back, at least one frame's bytes) is pinned, runs on a
    stream apart from the compute kernels' and the copies add up to every
    frame once each way, and that run's frames equal ``visualize_batch``'s
    (``profiled_stream_run``, which also matches the trace's records to the
    runtime's calls). Measured: streamed fps (median, p90 of ``runs``
    runs, host clock around ``run``), the executor's stage split per frame
    and the process's minor page faults per frame (median run), the card's
    busy share in the profiled run, H2D and D2H GB/s. ``reference``
    holds each species' ``visualize`` and batch-on-card fps."""
    from animal_vision_tpu_torch.native import ring as R
    from animal_vision_tpu_torch.pipeline import StreamingExecutor
    from animal_vision_tpu_torch.species import NON_UV_NAMES, get_animal

    on_card = device.type == "cuda"
    rng = np.random.default_rng(SEED + 8)
    frames = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(n_frames)]
    frame_bytes = frames[0].nbytes
    n_batches = -(-n_frames // batch)
    build_dir = R.BUILD_DIR
    rows = {}

    def drop(_frame):
        pass

    with plain_forbidden_on_cuda():
        for name in names:
            animal = get_animal(name, device)
            ex = StreamingExecutor(animal, batch=batch, split=False)
            outs = []
            reset_counters()
            n = ex.run(iter(frames), outs.append)
            moved = {k: v for k, v in counters().items() if v}
            if n != n_frames or len(outs) != n_frames:
                raise AssertionError(f"{name}: {n} frames streamed, {len(outs)} reached the sink, of {n_frames}")
            kernel = expected_kernel(name) if name in NON_UV_NAMES else "blur_uv"
            want_launches = n_batches if kernel != "blur_uv" else moved.get(kernel, 0)
            if on_card and (set(moved) != {kernel} or moved[kernel] < n_batches or moved[kernel] != want_launches):
                raise AssertionError(f"{name}: launches over the streamed run {moved}, expected {kernel} for each "
                                     f"of {n_batches} batches")
            wants = []
            for start in range(0, n_frames, batch):
                _, want = animal.visualize_batch(np.stack(frames[start:start + batch]))
                wants.extend(want)
                for i, w in enumerate(want):
                    if not np.array_equal(outs[start + i], w):
                        raise AssertionError(f"{name}: streamed frame {start + i} differs from visualize_batch "
                                             f"({max_lsb(torch.from_numpy(outs[start + i]), torch.from_numpy(w))} "
                                             f"LSB)")
            if Path(ex.ring.library).parent != build_dir or ex.ring.reads != n_batches:
                raise AssertionError(f"{name}: ring {ex.ring.library} with {ex.ring.reads} reads, expected "
                                     f"{n_batches} through a library in {build_dir}")
            del outs
            fps, splits, faults = [], [], []
            for _ in range(runs):
                minflt = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
                t0 = time.perf_counter()
                n = ex.run(iter(frames), drop)
                fps.append(n / (time.perf_counter() - t0))
                faults.append((resource.getrusage(resource.RUSAGE_SELF).ru_minflt - minflt) / n_frames)
                splits.append({k: v * 1e3 / n_frames for k, v in ex.timer.totals.items()})
            prof_run = profiled_stream_run(ex, frames, wants, on_card)
            events, wall_us = prof_run.pop("events"), prof_run["wall_us"]
            kernels = [e for e in events if e["cat"] == "kernel"]
            copies = [e for e in events if e["cat"] == "gpu_memcpy"]
            # frame data crosses between host and card; a device-to-device
            # copy is the program's own work on the compute stream
            frame_copies = [e for e in copies if e["bytes"] >= frame_bytes and ("HtoD" in e["name"]
                                                                                 or "DtoH" in e["name"])]
            kernel_streams = {e["stream"] for e in kernels}
            copy_streams = {e["stream"] for e in frame_copies}
            kinds = sorted({e["name"] for e in copies})
            h2d = [e for e in frame_copies if "HtoD" in e["name"]]
            d2h = [e for e in frame_copies if "DtoH" in e["name"]]
            frame_total = n_frames * frame_bytes
            if not prof_run["outputs_equal"]:
                raise AssertionError(f"{name}: the profiled run's frames differ from visualize_batch")
            if on_card and (any("Pinned" not in e["name"] for e in frame_copies) or copy_streams & kernel_streams
                            or sum(e["bytes"] for e in h2d) != frame_total
                            or sum(e["bytes"] for e in d2h) != frame_total):
                raise AssertionError(f"{name}: frame copies {kinds} on streams {sorted(copy_streams)}, kernels on "
                                     f"{sorted(kernel_streams)}, {sum(e['bytes'] for e in h2d)} bytes H2D and "
                                     f"{sum(e['bytes'] for e in d2h)} D2H of {frame_total}; {prof_run}")
            med = int(np.argsort(fps)[len(fps) // 2])
            split = splits[med]
            h2d_gbs = frame_bytes / (split["h2d"] * 1e-3) / 1e9 if on_card else None
            d2h_gbs = frame_bytes / (split["d2h"] * 1e-3) / 1e9 if on_card else None
            busy = busy_us(events)
            rows[name] = dict(
                frames=n_frames, batch=batch, fps_runs=fps, fps_median=float(np.median(fps)),
                fps_p90=float(np.percentile(fps, 90)), visualize_fps=reference[name]["visualize_fps"],
                batch_fps=reference[name]["batch_fps"], split_ms_per_frame=split, launches=moved,
                ring=dict(library=ex.ring.library, reads=ex.ring.reads), h2d_gb_s=h2d_gbs, d2h_gb_s=d2h_gbs,
                profiled_wall_us=wall_us, device_busy_us=busy, device_busy_share=busy / wall_us,
                compute_busy_us=busy_us(kernels), memcpy_kinds=kinds, copy_streams=sorted(copy_streams),
                kernel_streams=sorted(kernel_streams), other_memcpys=len(copies) - len(frame_copies),
                page_faults_per_frame=faults[med], profiled_run=prof_run,
            )
            log(f"[stream] {name:<8} {n_frames} frames of {hw[0]}x{hw[1]}, batch {batch}: streamed "
                f"{rows[name]['fps_median']:.1f} fps (p90 {rows[name]['fps_p90']:.1f}; runs "
                f"{', '.join(f'{f:.1f}' for f in fps)}); visualize {reference[name]['visualize_fps']:.1f} fps, "
                f"batch on card {reference[name]['batch_fps']:.1f} fps; bit-equal to visualize_batch; "
                f"launches {moved}")
            log(f"[stream] {name:<8} ms per frame: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
                + f"; {faults[med]:.0f} page faults per frame; H2D {h2d_gbs} GB/s, D2H {d2h_gbs} GB/s; device busy {busy / wall_us:.1%} of "
                f"{wall_us / 1e3:.1f} ms (kernels {busy_us(kernels) / wall_us:.1%}); copies {kinds}, frame copies on "
                f"streams {sorted(copy_streams)}, kernels on {sorted(kernel_streams)}; memcpy records "
                f"{prof_run['memcpy_records']} of {prof_run['memcpy_calls']} calls, record after call "
                f"{prof_run['record_lag_us']} µs; ring {ex.ring.library}")
    return dict(species=rows, frames=n_frames, batch=batch, hw=list(hw))



# ---------------------------------------------------------------------------
# The serving layer
# ---------------------------------------------------------------------------


def raw_uri(img: np.ndarray) -> str:
    """A uint8 (H, W, 3) frame as a data URI of its raw bytes. The shape
    has no comma: the service takes the payload after the URI's first one."""
    h, w, c = img.shape
    return f"data:{SERVE_RAW_MIME};shape={h}x{w}x{c};base64," + base64.b64encode(np.ascontiguousarray(img)).decode()


def raw_frame(uri: str) -> np.ndarray:
    head, payload = uri.split(",", 1)
    if not head.startswith(f"data:{SERVE_RAW_MIME};shape="):
        raise AssertionError(f"not a raw frame: {head[:80]}")
    shape = tuple(int(v) for v in head.split("shape=", 1)[1].split(";", 1)[0].split("x"))
    return np.frombuffer(base64.b64decode(payload), np.uint8).reshape(shape)


@contextlib.contextmanager
def raw_codec(hw: tuple[int, int]):
    """The service's image codec (cv2, which the card's machine lacks)
    swapped for raw uint8 bytes of (H, W, 3) frames, for the length of the
    block: ``_decode_image`` takes ``H * W * 3`` bytes and raises
    ``ValueError`` on any other length, ``_encode_data_uri`` gives
    ``raw_uri`` of the frame whatever the format asked. Channels are
    reversed where the service would convert between BGR and RGB."""
    from animal_vision_tpu_torch import service

    shape = (*hw, 3)
    saved = service._decode_image, service._encode_data_uri

    def decode(data: bytes, assume_bgr: bool) -> np.ndarray:
        if len(data) != int(np.prod(shape)):
            raise ValueError(f"could not decode image bytes: {len(data)} bytes, not a raw {shape} frame")
        img = np.frombuffer(data, np.uint8).reshape(shape).copy()
        return img if assume_bgr else img[..., ::-1].copy()

    def encode(img: np.ndarray, fmt: str, assume_bgr: bool) -> str:
        return raw_uri(img if assume_bgr else img[..., ::-1])

    service._decode_image, service._encode_data_uri = decode, encode
    try:
        yield
    finally:
        service._decode_image, service._encode_data_uri = saved


def masked_frame(opcode: int, payload: bytes, fin: bool = True) -> bytes:
    """A client WebSocket frame, masked as browsers mask (RFC 6455 §5.3);
    ``fin=False`` starts or continues a fragmented message."""
    n = len(payload)
    head = bytes([(0x80 if fin else 0) | opcode]) + (bytes([0x80 | n]) if n < 126 else bytes([0x80 | 126]) + n.to_bytes(2, "big")
                                     if n < 1 << 16 else bytes([0x80 | 127]) + n.to_bytes(8, "big"))
    mask = os.urandom(4)
    return head + mask + (np.frombuffer(payload, np.uint8) ^ np.resize(np.frombuffer(mask, np.uint8), n)).tobytes()


async def read_ws_frame(reader) -> tuple[int, bytes]:
    """One unmasked server frame: (opcode, payload)."""
    b1, b2 = await reader.readexactly(2)
    n = b2 & 0x7F
    if n >= 126:
        n = int.from_bytes(await reader.readexactly(2 if n == 126 else 8), "big")
    return b1 & 0x0F, await reader.readexactly(n)


async def http_exchange(reader, writer, method: str, path: str, body: bytes = b"") -> tuple[int, bytes]:
    """One HTTP/1.1 request on a kept-alive connection: (status, body)."""
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: localhost\r\nContent-Type: application/json\r\n"
                 f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    length = None
    while (line := await reader.readline()) not in (b"\r\n", b""):
        key, _, value = line.decode().partition(":")
        if key.strip().lower() == "content-length":
            length = int(value)
    return status, await reader.readexactly(length)


async def ws_upgrade(port: int, path: str):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    key = base64.b64encode(os.urandom(16)).decode()
    writer.write(f"GET {path} HTTP/1.1\r\nHost: localhost\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
                 f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n".encode())
    if b" 101 " not in await reader.readline():
        raise AssertionError(f"{path}: no WebSocket upgrade")
    while (await reader.readline()) not in (b"\r\n", b""):
        pass
    return reader, writer


class SioClient:
    """An in-process Socket.IO client of the ASGI app (``socketio.ASGIApp``):
    the Engine.IO open and CONNECT, then one reader task that stamps each
    event with its arrival time (server pings are answered and dropped)."""

    def __init__(self, app):
        self.to_app, self.from_app = asyncio.Queue(), asyncio.Queue()
        scope = {"type": "websocket", "path": "/socket.io/", "query_string": b"EIO=4&transport=websocket"}
        self.task = asyncio.ensure_future(app(scope, self.to_app.get, self.from_app.put))
        self.events: asyncio.Queue = asyncio.Queue()
        self.reader = None

    async def _next(self) -> str:
        msg = await asyncio.wait_for(self.from_app.get(), SERVE_TIMEOUT_S)
        if msg["type"] != "websocket.send":
            raise AssertionError(f"Socket.IO: {msg}")
        return msg["text"]

    async def connect(self) -> None:
        await self.to_app.put({"type": "websocket.connect"})
        if (await asyncio.wait_for(self.from_app.get(), SERVE_TIMEOUT_S))["type"] != "websocket.accept":
            raise AssertionError("Socket.IO: not accepted")
        if not (await self._next()).startswith("0"):
            raise AssertionError("Socket.IO: no Engine.IO open")
        await self.to_app.put({"type": "websocket.receive", "text": "40"})
        if not (await self._next()).startswith("40"):
            raise AssertionError("Socket.IO: no CONNECT ack")
        self.reader = asyncio.ensure_future(self._read())

    async def _read(self) -> None:
        while True:
            text = await self._next()
            if text == "2":
                await self.to_app.put({"type": "websocket.receive", "text": "3"})
                continue
            if not text.startswith("42"):
                raise AssertionError(f"Socket.IO: unexpected packet {text[:40]}")
            await self.events.put((time.perf_counter(), json.loads(text[2:])))

    async def send(self, *args) -> float:
        await self.to_app.put({"type": "websocket.receive", "text": "42" + json.dumps(["sendimage", *args])})
        return time.perf_counter()

    async def event(self):
        return await asyncio.wait_for(self.events.get(), SERVE_TIMEOUT_S)

    async def close(self) -> None:
        self.reader.cancel()
        await self.to_app.put({"type": "websocket.disconnect", "code": 1000})
        await asyncio.wait_for(self.task, SERVE_TIMEOUT_S)


def ms_stats(samples: list[float]) -> dict:
    return dict(median=float(np.median(samples)), p90=float(np.percentile(samples, 90)), n=len(samples),
                samples=samples)


def serve_phase(device: torch.device, names=STREAM_SPECIES, hw=MAIN_HW, reps=SERVE_REPS,
                sio_shape=SERVE_SIO) -> dict:
    """The port's ASGI app (``server.app.build_asgi_app(device)``) served by
    its stdlib server (``miniasgi.serve_async``, 127.0.0.1, port 0), with
    the service's codec swapped for ``raw_codec`` (the card's machine has no
    cv2). Over TCP: the static routes and ``/gettip`` once; for each
    species ``reps`` ``/getframe`` requests on one kept-alive connection and
    ``reps`` frames over one ``/ws`` socket, masked as a browser masks them;
    in process through ``socketio.ASGIApp``: ``sio_shape`` = (clients,
    frames each), all sent before any answer is read, after a bad frame.
    Hard checks: every returned frame equals ``visualize`` on the card bit
    for bit; each route's run (counters set to 0 before, read after)
    launched the species' kernel as many times as ``visualize`` does for
    that many frames (once per frame for the non-UV species); every
    Socket.IO frame is answered once, to its own client, in its order; the
    bad frame gets an ``error`` event and the loop goes on. Measured, per
    species and route, on the host clock (each request ends with the
    response read, after ``visualize`` synchronized): ms per request
    (median, p90), beside ``visualize`` alone on the same frames; once, the
    host's codec work for one frame (JSON and base64 each way) and the
    stdlib server's read of one masked ``/ws`` frame."""
    from animal_vision_tpu_torch.server import miniasgi
    from animal_vision_tpu_torch.server.app import MANIFEST_JSON, _ui_asset, build_asgi_app, ui_page
    from animal_vision_tpu_torch.species import NON_UV_NAMES, animal_names, get_animal

    on_card = device.type == "cuda"
    clients, per_client = sio_shape
    rng = np.random.default_rng(SEED + 9)
    pool = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(max(reps, clients * per_client))]
    uris = [raw_uri(f) for f in pool]
    log(f"[serve] codec: raw uint8 frames as data:{SERVE_RAW_MIME};shape=HxWx3;base64 (chip_smoke.raw_codec in "
        f"place of the service's cv2 codec); not run on the card: "
        + "; ".join(f"{route} ({why})" for route, why in SERVE_NOT_ON_CARD.items()))

    body = json.dumps({"image": uris[0], "animal": "dog"})
    payload = uris[0].split(",", 1)[1]
    codec = {}
    for what, fn in (("json_loads", lambda: json.loads(body)), ("b64decode", lambda: base64.b64decode(payload)),
                     ("b64encode", lambda: raw_uri(pool[0])), ("json_dumps", lambda: json.dumps({"image": uris[0]}))):
        codec[what] = wall_ms(fn, 5)["median"]

    async def unmask_ms() -> float:
        reader = asyncio.StreamReader()
        reader.feed_data(masked_frame(0x1, body.encode()))
        t0 = time.perf_counter()
        _, _, data = await miniasgi._ws_read_frame(reader)
        ms = (time.perf_counter() - t0) * 1e3
        if data != body.encode():
            raise AssertionError("the stdlib server's read of a masked frame differs from the payload")
        return ms

    def counted(name: str, n_frames: int, per_frame: dict, moved: dict, route: str) -> None:
        want = {k: v * n_frames for k, v in per_frame.items()}
        if on_card and moved != want:
            raise AssertionError(f"{name} {route}: launches {moved} over {n_frames} requests, expected {want}")

    def check(name: str, route: str, i: int, uri: str, want: np.ndarray, want_uri: str) -> None:
        if uri != want_uri:
            got = raw_frame(uri)
            err = max_lsb(torch.from_numpy(got), torch.from_numpy(want)) if got.shape == want.shape else got.shape
            raise AssertionError(f"{name} {route}: frame {i} differs from visualize ({err})")

    async def static_routes(port: int) -> dict:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        try:
            want = {"/": json.dumps("animal-vision-tpu server").encode(), "/ui": ui_page().encode(),
                    "/manifest.webmanifest": MANIFEST_JSON.encode(), "/sw.js": _ui_asset("sw.js").encode(),
                    "/ui/app.js": _ui_asset("app.js").encode(), "/ui/app.css": _ui_asset("app.css").encode()}
            sizes = {}
            for path, content in want.items():
                status, got = await http_exchange(reader, writer, "GET", path)
                if status != 200 or got != content:
                    raise AssertionError(f"GET {path}: {status}, {len(got)} bytes, expected {len(content)}")
                sizes[path] = len(got)
            page = want["/ui"].decode()
            data = json.loads(page.split("<script>const DATA = ", 1)[1].split(";</script>", 1)[0])
            if data["animals"] != animal_names() or len(data["animals"]) != 36:
                raise AssertionError(f"/ui lists {len(data['animals'])} species")
            status, got = await http_exchange(reader, writer, "POST", "/gettip", b'{"animal": "dog"}')
            if status != 200 or json.loads(got) != {"tip": ""}:
                raise AssertionError(f"/gettip: {status} {got[:200]}")
            return sizes
        finally:
            writer.close()

    async def getframe(port: int, name: str, bodies: list, wants: list, want_uris: list) -> list[float]:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        samples, replies = [], []
        try:
            for i in range(reps):
                t0 = time.perf_counter()
                status, got = await http_exchange(reader, writer, "POST", "/getframe", bodies[i])
                samples.append((time.perf_counter() - t0) * 1e3)
                if status != 200:
                    raise AssertionError(f"{name} /getframe: {status} {got[:200]}")
                replies.append(got)
        finally:
            writer.close()
        for i, got in enumerate(replies):
            check(name, "/getframe", i, json.loads(got)["image"], wants[i], want_uris[i])
        return samples

    async def ws(port: int, name: str, bodies: list, wants: list, want_uris: list) -> list[float]:
        reader, writer = await ws_upgrade(port, "/ws")
        samples, replies = [], []
        try:
            for i in range(reps):
                msg = masked_frame(0x1, bodies[i])
                t0 = time.perf_counter()
                writer.write(msg)
                await writer.drain()
                op, got = await asyncio.wait_for(read_ws_frame(reader), SERVE_TIMEOUT_S)
                samples.append((time.perf_counter() - t0) * 1e3)
                if op != 0x1:
                    raise AssertionError(f"{name} /ws: opcode {op}")
                replies.append(got)
            writer.write(masked_frame(0x8, (1000).to_bytes(2, "big")))
            await writer.drain()
        finally:
            writer.close()
        for i, got in enumerate(replies):
            check(name, "/ws", i, json.loads(got)["image"], wants[i], want_uris[i])
        return samples

    async def socketio(app, name: str, wants: list, want_uris: list) -> tuple[list[float], float]:
        cs = [SioClient(app) for _ in range(clients)]
        for c in cs:
            await c.connect()
        await cs[0].send(base64.b64encode(b"not a frame").decode(), name)
        t_bad, (event, data) = await cs[0].event()
        if event != "error" or "decode" not in data.get("error", ""):
            raise AssertionError(f"{name} Socket.IO: a bad frame got {event} {data}")
        sent = {}
        t0 = time.perf_counter()
        for i in range(per_client):
            for k, c in enumerate(cs):
                sent[k, i] = await c.send(uris[k * per_client + i], name)
        samples, last = [], t0
        for k, c in enumerate(cs):
            for i in range(per_client):
                t, (event, data) = await c.event()
                if event != "getimage":
                    raise AssertionError(f"{name} Socket.IO: client {k} frame {i} got {event} {data}")
                j = k * per_client + i
                check(name, f"Socket.IO client {k}", i, data["image"], wants[j], want_uris[j])
                samples.append((t - sent[k, i]) * 1e3)
                last = max(last, t)
        wall = last - t0
        await asyncio.sleep(0.05)
        extra = [c.events.qsize() for c in cs]
        if any(extra):
            raise AssertionError(f"{name} Socket.IO: events beyond one per frame: {extra}")
        for c in cs:
            await c.close()
        return samples, wall

    async def run(app) -> dict:
        server = await miniasgi.serve_async(app, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        rows = {}
        try:
            sizes = await static_routes(port)
            ws_read = await unmask_ms()
            for name in names:
                animal = get_animal(name, device)
                animal.visualize(pool[0])  # builds and loads the species' program
                reset_counters()
                wants = [animal.visualize(f)[1] for f in pool]
                want_uris = [raw_uri(w) for w in wants]
                bodies = [json.dumps({"image": uris[i], "animal": name}).encode() for i in range(reps)]
                per_frame = {k: v // len(pool) for k, v in counters().items() if v}
                kernel = expected_kernel(name) if name in NON_UV_NAMES else "blur_uv"
                if on_card and (set(per_frame) != {kernel} or (kernel != "blur_uv" and per_frame[kernel] != 1)
                                or any(v % len(pool) for v in counters().values())):
                    raise AssertionError(f"{name}: visualize of {len(pool)} frames launched {counters()}")
                vis = wall_ms(lambda: animal.visualize(pool[0]), reps, warmup=False)
                routes = {}
                for route, drive in (("/getframe", lambda: getframe(port, name, bodies, wants, want_uris)),
                                     ("/ws", lambda: ws(port, name, bodies, wants, want_uris))):
                    reset_counters()
                    samples = await drive()
                    counted(name, reps, per_frame, {k: v for k, v in counters().items() if v}, route)
                    routes[route] = ms_stats(samples)
                reset_counters()
                samples, wall = await socketio(app, name, wants, want_uris)
                counted(name, clients * per_client, per_frame, {k: v for k, v in counters().items() if v},
                        "Socket.IO")
                routes["socketio"] = dict(ms_stats(samples), wall_ms=wall * 1e3,
                                          ms_per_frame=wall * 1e3 / (clients * per_client))
                rows[name] = dict(kernel=kernel, launches_per_frame=per_frame, visualize_ms=vis, routes=routes)
                log(f"[serve] {name:<8} {hw[0]}x{hw[1]}: visualize {vis['median']:.2f} ms (p90 {vis['p90']:.2f}); "
                    + "; ".join(f"{r} {v['median']:.2f} ms (p90 {v['p90']:.2f}, n={v['n']}, "
                                f"{v['median'] / vis['median']:.1f}x visualize)" for r, v in routes.items())
                    + f"; Socket.IO {clients}x{per_client} frames in {wall * 1e3:.1f} ms "
                    f"({routes['socketio']['ms_per_frame']:.2f} ms per frame); bit-equal to visualize; "
                    f"{kernel} x{per_frame.get(kernel, 0)} per request")
        finally:
            server.close()
            await asyncio.wait_for(server.wait_closed(), SERVE_TIMEOUT_S)
        return dict(species=rows, static_bytes=sizes, ws_read_ms=ws_read)

    saved_key = os.environ.pop("GEMINI_API_KEY", None)
    try:
        with plain_forbidden_on_cuda(), raw_codec(hw):
            out = asyncio.run(run(build_asgi_app(device)))
    finally:
        if saved_key is not None:
            os.environ["GEMINI_API_KEY"] = saved_key
    log(f"[serve] host work per {hw[0]}x{hw[1]} frame: " + ", ".join(f"{k} {v:.2f} ms" for k, v in codec.items())
        + f"; the stdlib server's read of one masked /ws frame ({len(body)} bytes): {out['ws_read_ms']:.1f} ms")
    return dict(out, hw=list(hw), reps=reps, socketio=dict(clients=clients, frames_each=per_client),
                codec=f"data:{SERVE_RAW_MIME};shape=HxWx3;base64", host_codec_ms=codec,
                not_on_card=SERVE_NOT_ON_CARD)

def train_phase(device: torch.device, steps=TRAIN_STEPS, batch=TRAIN_BATCH, patch=TRAIN_PATCH,
                scenes_shape=TRAIN_SCENES, resume_at=TRAIN_RESUME_AT, cpu_run=TRAIN_CPU,
                forward_hw=TRAIN_FORWARD_HW, eval_scenes=TRAIN_EVAL_SCENES, demo_steps=TRAIN_DEMO_STEPS) -> dict:
    """MST++ training and evaluation (``models/train.py``, ``export.py``,
    ``eval.py``, ``quality.py``) on the card, through the entry points a
    user calls:

    1. the published MST++ (3 stages, weights from a seeded generator) for
       ``steps`` Adam steps (``make_optimizer(lr, steps, warmup=1)``, the
       MRAE loss) on ``batch`` x ``patch``^2 patches cut by
       ``sample_patches`` from ``synthetic_scenes``: every loss finite, the
       last below the first, no kernel launched (the train forward is the
       plain versions under autograd); ms per step (median and p90 of steps
       ``TRAIN_TIMED_FROM``..``steps``, host clock ended by a synchronize),
       the steps' peak memory, and from one more, profiled, step the
       device's busy share and largest items;
    2. a checkpoint at step ``resume_at`` restored into a fresh model,
       optimizer and schedule, which then takes the same later steps: equal
       to the uninterrupted run bit for bit;
    3. ``cpu_run`` = (steps, batch, patch) of the same model from the same
       weights and patches on the card and on the CPU: losses within
       ``TRAIN_LOSS_REL``, parameters within Adam's bound;
    4. the trained model under ``torch.no_grad()``: one ``forward_hw``
       forward through the kernels with the launch counts of a forward, within
       ``MST_FORWARD_TOL`` of the plain forward, ``fused_vs_f32_psnr`` at
       least ``TRAIN_MIN_DB``, and unlike the same forward before training
       (a stale weight cache would repeat it);
    5. ``validate(..., crop=128)`` of the shipped weights through the
       kernels over ``synthetic_scenes`` and ``xgen_scenes`` against the
       port on the CPU (the card's machine has no cv2 or h5py, so the
       in-memory scenes stand in for ``eval_protocol_fixtures``'s files);
    6. ``convergence_demo(steps=demo_steps)`` on the card: the JAX bars."""
    from torch.profiler import ProfilerActivity, profile

    from animal_vision_tpu_torch.models import eval as meval
    from animal_vision_tpu_torch.models import export, quality, train
    from animal_vision_tpu_torch.models.mst_plus_plus import MSTPlusPlus
    from animal_vision_tpu_torch.ops import fused_msab as M

    cuda = device.type == "cuda"
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("train: TF32 must stay off (device_phase turns it off)")
    log("[train] CPU-tested only (the card's machine lacks cv2 and h5py): "
        + "; ".join(f"{k} ({why})" for k, why in TRAIN_NOT_ON_CARD.items()))
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 10)
    scenes = train.synthetic_scenes(*scenes_shape, seed=SEED, device=device)
    draws = [train.sample_patches(rng, *scenes[int(rng.integers(0, len(scenes)))], patch, batch)
             for _ in range(steps)]
    batches = [(torch.from_numpy(r).to(device), torch.from_numpy(h).to(device)) for r, h in draws]
    cfg = train.make_optimizer(lr=TRAIN_LR, total_steps=steps, warmup=1)
    state = train.init_state(MSTPlusPlus(), cfg, seed=SEED, device=device)
    n_params = sum(p.numel() for p in state.model.parameters())
    step = train.make_train_step("mrae")
    fh, fw = forward_hw
    x = torch.from_numpy(rng.random((1, fh, fw, 3), dtype=np.float32)).to(device)
    with torch.no_grad():
        before = state.model(x)  # fills the weight cache with the initial weights

    # 1 and 2: the uninterrupted run, with a checkpoint at resume_at
    losses, step_ms = [], []
    sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    base_mem = torch.cuda.memory_allocated(device) if cuda else 0
    reset_counters()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "mid.pt")
        for i, (rgb, hsi) in enumerate(batches, start=1):
            t0 = time.perf_counter()
            state, m = step(state, rgb, hsi)
            sync(device)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(m["loss"].item())
            if i == resume_at:
                export.save_checkpoint(ckpt, state)
        peak = (torch.cuda.max_memory_allocated(device) - base_mem) if cuda else 0
        launched = {k: v for k, v in counters().items() if v}
        fresh = MSTPlusPlus().to(device)
        resumed = export.load_checkpoint(ckpt, train.TrainState(fresh, *cfg.build(fresh.parameters())))
    if launched:
        raise AssertionError(f"train: the train steps launched kernels {launched}; they run the plain versions")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"train: losses {losses} not finite or not lower at step {steps} than at step 1")
    resumed_losses = []
    for rgb, hsi in batches[resume_at:]:
        resumed, m = step(resumed, rgb, hsi)
        resumed_losses.append(m["loss"].item())
    sd, rsd = state.model.state_dict(), resumed.model.state_dict()
    resume_equal = resumed.step == state.step == steps and resumed_losses == losses[resume_at:] and all(
        torch.equal(rsd[k], v) for k, v in sd.items())
    if not resume_equal:
        raise AssertionError(f"train: resumed at step {resume_at}, losses {resumed_losses} against "
                             f"{losses[resume_at:]}; parameters max "
                             f"{max((rsd[k] - v).abs().max().item() for k, v in sd.items()):.3g} apart")
    del resumed, fresh
    timed = step_ms[TRAIN_TIMED_FROM - 1:]
    step_stats = ms_stats(timed)

    # one more step, profiled: busy share and the largest device items
    rgb, hsi = batches[-1]
    with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        t0 = time.perf_counter()
        step(state, rgb, hsi)
        sync(device)
        prof_wall_us = (time.perf_counter() - t0) * 1e6
    events = trace_device_events(prof)
    busy = busy_us(events)
    top = top_kernels(events, 8)
    log(f"[train] MST++ ({n_params} parameters) {steps} steps of {batch}x{patch}x{patch}: loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; {step_stats['median']:.1f} ms per step (p90 {step_stats['p90']:.1f}, steps "
        f"{TRAIN_TIMED_FROM}-{steps}), peak {peak / 2 ** 30:.2f} GiB over the {base_mem / 2 ** 30:.2f} GiB before; "
        f"resumed at {resume_at}: bit-equal; profiled step {prof_wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms ({busy / prof_wall_us:.1%}; {busy / 1e3 / step_stats['median']:.1%} of the median "
        f"step); top: " + "; ".join(f"{k[:60]} {v:.1f} ms" for k, v in top))
    result = dict(params=n_params, steps=steps, batch=batch, patch=patch, lr=TRAIN_LR, losses=losses,
                  step_ms=step_stats, step_ms_all=step_ms, peak_bytes=peak, base_bytes=base_mem,
                  resume=dict(at=resume_at, bit_equal=resume_equal),
                  profiled_step=dict(wall_us=prof_wall_us, busy_us=busy, busy_share=busy / prof_wall_us,
                                     busy_share_of_median_step=busy / 1e3 / step_stats["median"], top_kernels=top))

    # 3: card against CPU
    n_cpu, b_cpu, p_cpu = cpu_run
    small = [train.sample_patches(rng, *scenes[0], p_cpu, b_cpu) for _ in range(n_cpu)]
    cpu_cfg = train.make_optimizer(lr=TRAIN_LR, total_steps=steps, warmup=1)
    on_cpu = train.init_state(MSTPlusPlus(), cpu_cfg, seed=SEED + 1, device="cpu")
    card_model = MSTPlusPlus().to(device)
    card_model.load_state_dict(on_cpu.model.state_dict())
    on_card = train.TrainState(card_model, *cpu_cfg.build(card_model.parameters()))
    pairs = []
    for r, h in small:
        on_cpu, mc = step(on_cpu, r, h)
        on_card, mg = step(on_card, r, h)
        pairs.append((mg["loss"].item(), mc["loss"].item()))
    worst = max(abs(a - b) / abs(b) for a, b in pairs)
    # an element whose gradient is at noise level may take Adam's step the
    # other way on the other device: the max within 2 x the rates' sum
    want = dict(on_cpu.model.named_parameters())
    diffs = torch.cat([(p.detach().cpu() - want[k].detach()).flatten() for k, p in on_card.model.named_parameters()])
    bound = 2 * sum(cpu_cfg.schedule(c) for c in range(n_cpu))
    params_cpu = dict(max_abs=diffs.abs().max().item(), rms=diffs.pow(2).mean().sqrt().item(), bound=bound)
    if (worst > TRAIN_LOSS_REL or params_cpu["max_abs"] > bound
            or params_cpu["rms"] > TRAIN_RMS_OF_BOUND * bound):
        raise AssertionError(f"train: card against CPU losses {pairs} ({worst:.3g} relative), parameters "
                             f"{params_cpu}")
    log(f"[train] card against CPU, {n_cpu} steps of {b_cpu}x{p_cpu}x{p_cpu}: losses within {worst:.3g} relative; "
        f"parameters {params_cpu['max_abs']:.3g} max, {params_cpu['rms']:.3g} RMS apart "
        f"(bound {params_cpu['bound']:.3g})")
    result["card_vs_cpu"] = dict(losses=pairs, max_rel=worst, params=params_cpu)
    del on_cpu, on_card, card_model

    # 4: the trained weights through the kernels
    state.model.eval()
    expected = {**MST_PER_FORWARD, **MST_FFN_PER_FORWARD}
    with torch.no_grad():
        with plain_forbidden_on_cuda():
            reset_counters()
            after = state.model(x)
            sync(device)
            moved = {k: v for k, v in counters().items() if k in expected}
        plain = state.model(x, plain=True)
    err = (after - plain).abs().max().item()
    change = (after - before).abs().max().item()
    db = quality.fused_vs_f32_psnr(state.model, forward_hw)
    if cuda and moved != expected:
        raise AssertionError(f"train: the trained model's forward launched {moved}, expected {expected}")
    if not (torch.isfinite(after).all().item() and err < MST_FORWARD_TOL and db >= TRAIN_MIN_DB and change > 1e-3):
        raise AssertionError(f"train: trained forward at {fh}x{fw}: {err:.3g} from plain, {db:.2f} dB, "
                             f"{change:.3g} from the forward before training")
    log(f"[train] trained weights through the kernels at {fh}x{fw}: launches {moved}; max {err:.3g} from the plain "
        f"forward; fused_vs_f32_psnr {db:.2f} dB; max {change:.3g} from the same forward before training")
    result["trained_forward"] = dict(hw=[fh, fw], launches=moved, max_abs_err=err, fused_vs_f32_psnr_db=db,
                                     max_change_from_init=change)

    del state, batches, before, after, plain
    if cuda:
        torch.cuda.empty_cache()

    # 5: the eval protocol on in-memory scenes, the shipped weights through the kernels
    n_eval, eh, ew = eval_scenes
    card_net, cpu_net = quality.load_pretrained(device), quality.load_pretrained("cpu")
    protocol = {}
    for family, make in (("synthetic", train.synthetic_scenes), ("xgen", train.xgen_scenes)):
        fam = make(n_eval, eh, ew, 7 if family == "synthetic" else 11, device="cpu")
        with plain_forbidden_on_cuda():
            reset_counters()
            got = meval.validate(meval.model_apply_fn(card_net), fam, crop=128)
            n_conv = counters()["conv_kernel"]
        want = meval.validate(meval.model_apply_fn(cpu_net), fam, crop=128)
        rel = max(abs(got[k] - want[k]) / abs(want[k]) for k in want)
        if (cuda and n_conv != n_eval * MST_PER_FORWARD["conv_kernel"]) or rel > TRAIN_EVAL_REL:
            raise AssertionError(f"train: eval protocol on {family} scenes: card {got}, CPU {want} "
                                 f"({rel:.3g} relative), {n_conv} conv launches")
        protocol[family] = dict(card=got, cpu=want, max_rel=rel)
        log(f"[train] eval protocol (crop 128, synth_v1 through the kernels) on {n_eval} {family} scenes of "
            f"{eh}x{ew}: MRAE {got['mrae']:.4f} RMSE {got['rmse']:.4f} PSNR {got['psnr']:.2f} dB; "
            f"{rel:.3g} relative from the CPU")
    result["eval_protocol"] = protocol
    del card_net, cpu_net

    # 6: the convergence demo on the card
    t0 = time.perf_counter()
    demo = train.convergence_demo(steps=demo_steps, device=device)
    gain = demo["psnr_final"] - demo["psnr_init"]
    if not (demo["resumed_step"] == demo_steps and demo["loss_last"] < 0.5 * demo["loss_first"] and gain >= 6.0):
        raise AssertionError(f"train: convergence demo {demo}")
    log(f"[train] convergence_demo(steps={demo_steps}): loss {demo['loss_first']:.4f} -> {demo['loss_last']:.4f}, "
        f"held-out PSNR {demo['psnr_init']:.2f} -> {demo['psnr_final']:.2f} dB (+{gain:.2f}), resumed step "
        f"{demo['resumed_step']}; {time.perf_counter() - t0:.1f} s; phase {time.perf_counter() - t_phase:.1f} s")
    result["convergence_demo"] = dict(demo, psnr_gain_db=gain, seconds=time.perf_counter() - t0)
    result["seconds"] = time.perf_counter() - t_phase
    result["not_on_card"] = TRAIN_NOT_ON_CARD
    return result


def sha256_file(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def tools_profiled_step(device: torch.device, train_args: tuple, warmup: int = 3) -> dict:
    """One ``train_synth`` step (its default batch and patch, the L1 loss)
    of the published MST++ from seeded weights, after ``warmup`` steps,
    under ``torch.profiler``: wall ms, the device's busy ms and share, the
    count of kernels and the largest items."""
    from torch.profiler import ProfilerActivity, profile

    from animal_vision_tpu_torch.models import train as T
    from animal_vision_tpu_torch.models.mst_plus_plus import MSTPlusPlus
    from animal_vision_tpu_torch.tools import train_synth

    defaults = {"--patch": 64, "--batch": 8, "--scene-hw": 160}
    args = dict(zip(train_args[::2], train_args[1::2]))
    patch, batch, hw = (int(args.get(k, v)) for k, v in defaults.items())
    scenes, _ = train_synth.split_scenes("mixed", 4, hw, device)
    rgb, hsi = (torch.from_numpy(a[0]).to(device) for a in
                train_synth.draw_chunk(np.random.default_rng(SEED), scenes, 1, patch, batch))
    state = T.init_state(MSTPlusPlus(), T.make_optimizer(1e-3, 100, 10), seed=SEED, device=device)
    step = T.make_train_step("l1")
    for _ in range(warmup):
        state, _m = step(state, rgb, hsi)
    sync(device)
    cuda = device.type == "cuda"
    with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        t0 = time.perf_counter()
        step(state, rgb, hsi)
        sync(device)
        wall_us = (time.perf_counter() - t0) * 1e6
    events = trace_device_events(prof)
    busy = busy_us(events)
    n_kernels = sum(1 for e in events if e["cat"] == "kernel")
    top = top_kernels(events, 5)
    log(f"[tools] one train_synth step ({batch}x{patch}x{patch}), profiled: {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms ({busy / wall_us:.1%}), {n_kernels} kernels; top: "
        + "; ".join(f"{k[:50]} {v:.2f} ms" for k, v in top))
    return dict(batch=batch, patch=patch, wall_us=wall_us, busy_us=busy, busy_share=busy / wall_us,
                kernels=n_kernels, top_kernels=top)


def tools_phase(device: torch.device, size=TOOLS_SIZE, train_args=TOOLS_TRAIN, finetune_args=TOOLS_FINETUNE,
                reload_hw=TOOLS_RELOAD_HW, cpu_threads=TOOLS_CPU_THREADS) -> dict:
    """The model side's entry points on the card, as a user runs them:

    1. ``models/summary.py:main(["--size", size])``: all 11 zoo methods on
       the card, exit 0, no ``FAILED``; each method's parameters and FLOPs
       equal to the CPU's, counted in a process of its own while the card
       works (the count is the plain composition's on both: the kernels'
       launches would be invisible to ``FlopCounterMode``);
    2. ``tools/train_synth.py:main`` with ``train_args`` into a temporary
       directory: every loss finite, the last chunk's mean below the
       first's, each family's held-out PSNR above the initial forward's, no
       kernel launched by a train step (the counters read around each);
       the budget counts from the start, scene making included, as the JAX
       tool counts it, so it may end the run a chunk early; then one more
       step of the tool's batch from fresh weights, profiled: its wall
       time, the device's busy share and the count of kernels it ran;
    3. the saved file through ``quality.load_pretrained(path=...)`` at
       ``reload_hw`` on the kernels: the launch counts of one forward,
       < ``MST_FORWARD_TOL`` from its plain forward;
    4. ``tools/finetune_mixed.py:main`` with ``finetune_args`` on a
       temporary copy of the shipped weights: the card's machine has no cv2
       or h5py, so the protocol is scored in memory and the copy is kept;
    5. the shipped ``synth_v1.pt`` unchanged (sha256)."""
    from animal_vision_tpu_torch.models import quality, summary
    from animal_vision_tpu_torch.models import train as T
    from animal_vision_tpu_torch.models.mst_plus_plus import SHIPPED
    from animal_vision_tpu_torch.tools import finetune_mixed, train_synth

    t_phase = time.perf_counter()
    shipped = sha256_file(SHIPPED)
    route = quality.protocol_route()
    on = [] if device.type == "cuda" else ["--device", str(device)]  # the card is every entry point's default
    cpu_proc = subprocess.Popen([sys.executable, "-c", TOOLS_CPU_FLOPS, str(size), str(cpu_threads)],
                                cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    result = {"protocol_route": route}
    try:
        # 1: the summary CLI on the card, every summarize call kept
        rows = {}
        real_summarize = summary.summarize

        def kept(method, *args, **kwargs):
            rows[method] = real_summarize(method, *args, **kwargs)
            return rows[method]

        printed = io.StringIO()
        summary.summarize = kept
        try:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                rc = summary.main(["--size", str(size), *on])
            summary_s = time.perf_counter() - t0
        finally:
            summary.summarize = real_summarize
        lines = printed.getvalue().splitlines()
        log("[tools] summary CLI on the card:\n" + "\n".join(lines))
        if rc != 0 or any("FAILED" in line for line in lines) or len(rows) != 11 or len(lines) != 12:
            raise AssertionError(f"tools: the summary CLI exited {rc} with {lines}")

        # 2: train_synth, the train steps' launches counted
        real_make = T.make_train_step
        step_launches = []

        def counted_make(loss):
            step = real_make(loss)

            def counted(state, rgb, hsi):
                before = sum(counters().values())
                out = step(state, rgb, hsi)
                step_launches.append(sum(counters().values()) - before)
                return out

            return counted

        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "synth_tools.pt")
            T.make_train_step = counted_make
            try:
                ts = train_synth.main([*train_args, *on, "--out", out])
            finally:
                T.make_train_step = real_make
            init, final = ts["held_out_log"][0], ts["held_out"]
            if not (ts["steps"] == len(step_launches) == len(ts["losses"]) and np.isfinite(ts["losses"]).all()
                    and ts["chunk_loss"][-1] < ts["chunk_loss"][0] and not any(step_launches)
                    and all(final[f]["psnr"] > init[f]["psnr"] for f in final) and ts["protocol"] == route):
                raise AssertionError(f"tools: train_synth {[ts[k] for k in ('steps', 'chunk_loss', 'protocol')]}, "
                                     f"held out {init} -> {final}, launches in steps {sum(step_launches)}")
            log(f"[tools] train_synth {' '.join(train_args)}: {ts['steps']} steps, chunk losses "
                f"{[round(v, 4) for v in ts['chunk_loss']]}, {ts['ms_per_step_median']:.1f} ms per step (median "
                f"of chunks), no kernel in a step; held-out PSNR "
                + ", ".join(f"{f} {init[f]['psnr']:.2f} -> {final[f]['psnr']:.2f} dB" for f in final)
                + f"; protocol ({ts['protocol']}) "
                + ", ".join(f"{f} {v['psnr']:.2f} dB" for f, v in ts["eval_protocol"].items())
                + f"; {ts['wall_s']:.1f} s")
            result["train_synth"] = {k: v for k, v in ts.items() if k != "losses"}
            result["profiled_step"] = tools_profiled_step(device, train_args)

            # 3: the saved file through the kernels
            model = quality.load_pretrained(device, path=out)
            fh, fw = reload_hw
            gen = torch.Generator().manual_seed(SEED + 16)
            x = torch.rand((1, fh, fw, 3), generator=gen).to(device)
            expected = {**MST_PER_FORWARD, **MST_FFN_PER_FORWARD}
            with torch.no_grad():
                with plain_forbidden_on_cuda():
                    reset_counters()
                    y = model(x)
                    sync(device)
                    moved = {k: v for k, v in counters().items() if k in expected}
                plain = model(x, plain=True)
            err = (y - plain).abs().max().item()
            if (device.type == "cuda" and moved != expected) or not (torch.isfinite(y).all().item()
                                                                     and err < MST_FORWARD_TOL):
                raise AssertionError(f"tools: the saved weights' forward at {fh}x{fw} launched {moved}, "
                                     f"{err:.3g} from plain")
            log(f"[tools] {out} reloaded by quality.load_pretrained: {fh}x{fw} forward launches {moved}, max {err:.3g} "
                "from plain")
            result["reload"] = dict(hw=[fh, fw], launches=moved, max_abs_err=err)
            del model, x, y, plain

            # 4: finetune_mixed on a copy of the shipped weights
            src = os.path.join(tmp, "synth_v1.pt")
            shutil.copyfile(SHIPPED, src)
            ft = finetune_mixed.main([*finetune_args, *on, "--src", src])
            kept_src = sha256_file(src) == shipped
            if not (ft["protocol"] == route and np.isfinite(ft["losses"]).all()
                    and (route == "files" or (not ft["swapped"] and kept_src))):
                raise AssertionError(f"tools: finetune_mixed {ft['protocol']}, swapped {ft['swapped']}, copy kept "
                                     f"{kept_src}")
            log(f"[tools] finetune_mixed {' '.join(finetune_args)}: {ft['steps']} steps; protocol ({ft['protocol']}) "
                f"synth {ft['start']['synth']['psnr']:.2f} -> {ft['final']['synth']['psnr']:.2f}, xgen "
                f"{ft['start']['xgen']['psnr']:.2f} -> {ft['final']['xgen']['psnr']:.2f} dB; gates passed "
                f"{ft['gates_passed']}, swapped {ft['swapped']}, the copy kept {kept_src}; {ft['wall_s']:.1f} s")
            result["finetune_mixed"] = dict({k: v for k, v in ft.items() if k != "losses"}, copy_kept=kept_src)

        # 1, continued: the CPU's counts
        t0 = time.perf_counter()
        cpu_out, cpu_err = cpu_proc.communicate(timeout=TOOLS_CPU_TIMEOUT_S)
        if cpu_proc.returncode != 0:
            raise AssertionError(f"tools: the CPU counts failed: {cpu_err[-2000:]}")
        cpu = json.loads(cpu_out.strip().splitlines()[-1])
        unequal = {m: (rows[m], cpu[m]) for m in cpu if rows.get(m) != cpu[m]}
        if unequal or set(rows) != set(cpu):
            raise AssertionError(f"tools: card and CPU summaries differ: {unequal}")
        log(f"[tools] summary at {size}x{size}: all {len(rows)} methods' parameters and FLOPs equal on the card and "
            f"the CPU (card {summary_s:.1f} s; waited {time.perf_counter() - t0:.1f} s for the CPU)")
        result["summary"] = dict(size=size, rows=rows, printed=lines, card_s=summary_s)
    finally:
        if cpu_proc.poll() is None:
            cpu_proc.kill()
            cpu_proc.communicate()
    if sha256_file(SHIPPED) != shipped:
        raise AssertionError("tools: the shipped synth_v1.pt changed")
    result["seconds"] = time.perf_counter() - t_phase
    log(f"[tools] shipped synth_v1.pt unchanged; phase {result['seconds']:.1f} s")
    return result


# ---------------------------------------------------------------------------
# Multi-device: ranks as processes on the card
# ---------------------------------------------------------------------------


def md_frames(seed: int, shape: tuple, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).random((*shape, 3), dtype=np.float32)).to(device)


def md_train_batches(steps: int, batch: int, patch: int, device: torch.device) -> list:
    """The sharded train steps' batches, made from a seed alike on every rank."""
    rng = np.random.default_rng(SEED + 30)
    return [(torch.from_numpy(rng.uniform(0, 1, (batch, patch, patch, 3)).astype(np.float32)).to(device),
             torch.from_numpy(rng.uniform(0.05, 1, (batch, patch, patch, 31)).astype(np.float32)).to(device))
            for _ in range(steps)]


def md_setup(device: torch.device):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from animal_vision_tpu_torch.models.mst_plus_plus import load_shipped

    return load_shipped(device)


def md_forward(run, x: torch.Tensor, want: torch.Tensor, reps: int, device: torch.device) -> dict:
    """One forward with the launch counters set to 0 just before it and read
    just after, its max abs error against ``want``; then ``reps`` timed
    forwards (host clock, each ending synchronized) with the transport
    counters per forward."""
    from animal_vision_tpu_torch.parallel import comm

    reset_counters()
    got = run(x)
    sync(device)
    launches = {k: v for k, v in counters().items() if v}
    err = (got - want).abs().max().item()
    del got
    comm.reset_traffic()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run(x)
        sync(device)
        samples.append((time.perf_counter() - t0) * 1e3)
    traffic = {k: {n: v / reps for n, v in c.items()} for k, c in comm.TRAFFIC.items()}
    return dict(launches=launches, max_abs_err=err, ms=ms_stats(samples), traffic=traffic,
                transport_ms=sum(c["ms"] for c in traffic.values()))


def md_train(device: torch.device, dims: tuple, steps: int, batch: int, patch: int) -> dict:
    """``steps`` sharded train steps of the published MST++ from the seeded
    weights: losses, host ms per step, rank 0's parameters."""
    import torch.distributed as dist

    from animal_vision_tpu_torch.models import train
    from animal_vision_tpu_torch.models.mst_plus_plus import MSTPlusPlus
    from animal_vision_tpu_torch.parallel import make_mesh

    cfg = train.make_optimizer(lr=TRAIN_LR, total_steps=TRAIN_STEPS, warmup=1)
    state = train.init_state(MSTPlusPlus(), cfg, seed=SEED, device=device)
    run, place = train.make_sharded_train_step(make_mesh(*dims), cfg)
    state = place(state)
    losses, samples = [], []
    for rgb, hsi in md_train_batches(steps, batch, patch, device):
        t0 = time.perf_counter()
        state, m = run(state, rgb, hsi)
        sync(device)
        samples.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
    params = {k: v.detach().cpu().numpy() for k, v in state.model.named_parameters()} if dist.get_rank() == 0 else None
    return dict(losses=losses, step_ms=samples, params=params)


def md_two_ranks(device: torch.device, hw: tuple, reps: int, train_cfg: tuple) -> dict:
    """Rank function of the 2-rank world: the sp 2 band forward at ``hw``,
    then the sharded train step with dp 2 and with sp 2."""
    import torch.distributed as dist

    from animal_vision_tpu_torch.parallel import make_mesh, sharded_inference_fn

    model = md_setup(device)
    x = md_frames(SEED + 40, (1, *hw), device)
    with torch.no_grad():
        want = model(x)
    out = dict(rank=dist.get_rank(), backend=dist.get_backend(), device=str(device))
    out["sp2"] = md_forward(sharded_inference_fn(make_mesh(sp=2), model), x, want, reps, device)
    del x, want
    torch.cuda.empty_cache()
    out["train"] = {name: md_train(device, dims, *train_cfg) for name, dims in (("dp2", (2, 1, 1)),
                                                                              ("sp2", (1, 2, 1)))}
    return out


def md_four_ranks(device: torch.device, sptp_hw: tuple, fallback_hw: tuple, pp: tuple, reps: int,
                  pp_reps: int) -> dict:
    """Rank function of the 4-rank world: the sp 2 x tp 2 band forward at
    ``sptp_hw``, the fallback at ``fallback_hw`` with sp 4, and the pp
    pipeline on ``pp`` frames."""
    import torch.distributed as dist

    from animal_vision_tpu_torch.parallel import fused_shard, make_mesh, sharded_inference_fn
    from animal_vision_tpu_torch.parallel.pipeline import make_pp_mesh, mst_plus_plus_pp_forward

    model = md_setup(device)
    out = dict(rank=dist.get_rank(), backend=dist.get_backend(), device=str(device))
    x = md_frames(SEED + 41, (1, *sptp_hw), device)
    with torch.no_grad():
        want = model(x)
    out["sp2tp2"] = md_forward(sharded_inference_fn(make_mesh(sp=2, tp=2), model), x, want, reps, device)

    mesh = make_mesh(sp=4)
    x = md_frames(SEED + 40, (1, *fallback_hw), device)
    with torch.no_grad():
        want = model(x)
    out["fallback"] = dict(bands=fused_shard.supports(mesh, 1, *fallback_hw),
                           **md_forward(sharded_inference_fn(mesh, model), x, want, 1, device))
    del x, want
    torch.cuda.empty_cache()

    ppm = make_pp_mesh(4)
    x = md_frames(SEED + 40, pp, device)
    with torch.no_grad():
        want = model(x)
    out["pp"] = dict(slot=ppm.index, **md_forward(lambda v: mst_plus_plus_pp_forward(model, ppm, v, MD_PP_MICRO), x,
                                                  want, pp_reps, device))
    return out


def multidevice_phase(device: torch.device, sp2_hw=MD_SP2_HW, sptp_hw=MD_SPTP_HW, fallback_hw=MD_FALLBACK_HW,
                      pp=MD_PP, reps=MD_REPS, pp_reps=MD_PP_REPS, train_cfg=MD_TRAIN, fleet_hw=MAIN_HW) -> dict:
    """The multi-device layer (``parallel/``, ``models/train.py``'s
    ``make_sharded_train_step``) with its ranks as processes. On a host
    with one card they all share it (gloo, every CUDA tensor staged through
    pinned host memory; the ranks share the SMs, so nothing here can be
    faster than one process); with a card per rank they take NCCL:

    1. 2 ranks: ``fused_sharded_forward`` of the shipped MST++ at
       ``sp2_hw`` with sp 2, through ``sharded_inference_fn``: each rank's
       kernel launches (counters set to 0 just before the forward and read
       just after; every rank must launch ``MD_KERNELS``), max abs error
       against the unsharded kernel forward (< ``MST_FORWARD_TOL``), host
       ms per forward (median, p90 of ``reps``) beside the unsharded forward
       in this process, halo bytes and transport ms per forward; then
       ``make_sharded_train_step`` with dp 2 and with sp 2 for
       ``train_cfg`` = (steps, batch, patch) against ``make_train_step`` in
       this process on the same batches: losses within ``TRAIN_LOSS_REL``,
       parameters within Adam's bound, ms per step;
    2. 4 ranks: the band forward at ``sptp_hw`` with sp 2 x tp 2 (tp folds
       into the bands), the same readings; ``fallback_hw`` with sp 4, whose
       bands would not be 4-aligned, so every rank runs it whole (< the
       same bar); ``mst_plus_plus_pp_forward`` on ``pp`` frames in
       ``MD_PP_MICRO`` microbatches (the slots with a stage launch every
       kernel, the identity slot conv_in and conv_out), error, ms and the
       bubble share;
    3. ``render_fleet`` of ``MD_FLEET`` on one ``fleet_hw`` frame over
       every card of the host, each species bit-equal to ``visualize`` on
       its card (one process);
    4. ``dryrun_multichip(4)``'s summary line."""
    import torch.distributed  # noqa: F401  (fails early where the build has no distributed support)

    from animal_vision_tpu_torch.models import train
    from animal_vision_tpu_torch.models.mst_plus_plus import MSTPlusPlus
    from animal_vision_tpu_torch.parallel import dryrun, fused_shard
    from animal_vision_tpu_torch.parallel.fleet import assign_devices, render_fleet
    from animal_vision_tpu_torch.parallel.launch import spawn
    from animal_vision_tpu_torch.parallel.pipeline import bubble_share
    from animal_vision_tpu_torch.species import get_animal

    t_phase = time.perf_counter()
    cuda = device.type == "cuda"
    model = md_setup(device)
    unsharded = {}
    with torch.no_grad():
        for name, shape in (("sp2", (1, *sp2_hw)), ("sp2tp2", (1, *sptp_hw)), ("pp", pp)):
            x = md_frames(SEED + 40, shape, device)
            unsharded[name] = wall_ms(lambda: (model(x), sync(device)), reps)
    del x

    # the single-process train steps on the same batches
    steps, batch, patch = train_cfg
    cfg = train.make_optimizer(lr=TRAIN_LR, total_steps=TRAIN_STEPS, warmup=1)
    state = train.init_state(MSTPlusPlus(), cfg, seed=SEED, device=device)
    step = train.make_train_step("mrae")
    ref_losses, ref_ms = [], []
    for rgb, hsi in md_train_batches(steps, batch, patch, device):
        t0 = time.perf_counter()
        state, m = step(state, rgb, hsi)
        sync(device)
        ref_ms.append((time.perf_counter() - t0) * 1e3)
        ref_losses.append(m["loss"].item())
    ref_params = {k: v.detach().cpu().numpy() for k, v in state.model.named_parameters()}
    del state
    if cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    two = spawn(md_two_ranks, 2, device, timeout=MD_TIMEOUT_S, hw=sp2_hw, reps=reps, train_cfg=train_cfg)
    two_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    four = spawn(md_four_ranks, 4, device, timeout=MD_TIMEOUT_S, sptp_hw=sptp_hw, fallback_hw=fallback_hw, pp=pp,
                 reps=reps, pp_reps=pp_reps)
    four_s = time.perf_counter() - t0

    for world in (two, four):
        for r in world:
            log(f"[multidevice] rank {r['rank']} of {len(world)}: backend {r['backend']}, device {r['device']}")
    result = dict(world_seconds={"2": two_s, "4": four_s}, unsharded=unsharded)
    for name, ranks, hw in (("sp2", two, sp2_hw), ("sp2tp2", four, sptp_hw)):
        rows = [r[name] for r in ranks]
        for r, row in zip(ranks, rows):
            missing = [k for k in MD_KERNELS if not row["launches"].get(k)]
            if cuda and missing:
                raise AssertionError(f"multidevice {name}: rank {r['rank']} launched none of {missing}: "
                                     f"{row['launches']}")
        err = max(row["max_abs_err"] for row in rows)
        if not err < MST_FORWARD_TOL:
            raise AssertionError(f"multidevice {name}: {err:.3g} from the unsharded kernel forward")
        med = max(row["ms"]["median"] for row in rows)
        p90 = max(row["ms"]["p90"] for row in rows)
        halo = [row["traffic"]["p2p"]["bytes"] for row in rows]
        transport = [row["transport_ms"] for row in rows]
        log(f"[multidevice] {name} band forward {hw[0]}x{hw[1]} on {len(rows)} ranks: launches per rank "
            + "; ".join(str({k: row['launches'].get(k, 0) for k in MD_KERNELS}) for row in rows)
            + f"; max {err:.3g} from unsharded; {med:.1f} ms per forward (p90 {p90:.1f}, slowest rank) against "
            f"{unsharded[name]['median']:.1f} ms unsharded (p90 {unsharded[name]['p90']:.1f}); halo "
            f"{max(halo) / 1e6:.2f} MB sent per rank and forward; transport {max(transport):.1f} ms per forward "
            f"(all-gather {max(row['traffic']['all_gather']['ms'] for row in rows):.1f}, halo "
            f"{max(row['traffic']['p2p']['ms'] for row in rows):.1f}, stats "
            f"{max(row['traffic']['all_reduce']['ms'] for row in rows):.1f})")
        result[name] = dict(hw=list(hw), ranks=rows, max_abs_err=err, ms_median=med, ms_p90=p90,
                            halo_bytes_per_rank=max(halo), transport_ms=max(transport))

    fb = [r["fallback"] for r in four]
    fb_err = max(row["max_abs_err"] for row in fb)
    if any(row["bands"] for row in fb) or not fb_err < MST_FORWARD_TOL:
        raise AssertionError(f"multidevice fallback: {fb}")
    log(f"[multidevice] {fallback_hw[0]}x{fallback_hw[1]} on 4 ranks with sp 4: no band path "
        f"({fused_shard.padded(fallback_hw[0]) / 4:g}-row bands), "
        f"each rank runs it whole; max {fb_err:.3g} from unsharded; launches per rank "
        + "; ".join(str({k: row['launches'].get(k, 0) for k in MD_KERNELS}) for row in fb))
    result["fallback"] = dict(hw=list(fallback_hw), ranks=fb, max_abs_err=fb_err)

    pps = [r["pp"] for r in four]
    pp_err = max(row["max_abs_err"] for row in pps)
    for row in pps:
        need = MD_KERNELS if row["slot"] < 3 else ("conv_kernel",)
        if cuda and any(not row["launches"].get(k) for k in need):
            raise AssertionError(f"multidevice pp: slot {row['slot']} launched {row['launches']}")
    if not pp_err < MST_FORWARD_TOL:
        raise AssertionError(f"multidevice pp: {pp_err:.3g} from unsharded")
    bubble = bubble_share(4, MD_PP_MICRO)
    pp_med = max(row["ms"]["median"] for row in pps)
    log(f"[multidevice] pp: MST++'s 3 stages and an identity slot over 4 ranks, {pp[0]} x {pp[1]}x{pp[2]} in "
        f"{MD_PP_MICRO} microbatches: max {pp_err:.3g} from unsharded; {pp_med:.1f} ms per forward (p90 "
        f"{max(row['ms']['p90'] for row in pps):.1f}) against {unsharded['pp']['median']:.1f} ms unsharded; "
        f"bubble share {bubble:.3f}; transport {max(row['transport_ms'] for row in pps):.1f} ms per forward")
    result["pp"] = dict(ranks=pps, max_abs_err=pp_err, ms_median=pp_med, bubble_share=bubble)

    # the sharded train steps against the single-process ones
    bound = 2 * sum(cfg.schedule(c) for c in range(steps))
    result["train"] = dict(steps=steps, batch=batch, patch=patch, single=dict(losses=ref_losses,
                                                                              step_ms=ms_stats(ref_ms)))
    for name in ("dp2", "sp2"):
        got = two[0]["train"][name]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref_losses))
        diffs = np.concatenate([(got["params"][k] - v).ravel() for k, v in ref_params.items()])
        pmax, prms = float(np.abs(diffs).max()), float(np.sqrt(np.mean(diffs ** 2)))
        if rel > TRAIN_LOSS_REL or pmax > bound or prms > TRAIN_RMS_OF_BOUND * bound:
            raise AssertionError(f"multidevice train {name}: losses {got['losses']} against {ref_losses} "
                                 f"({rel:.3g} relative); parameters {pmax:.3g} max, {prms:.3g} RMS (bound {bound:.3g})")
        step_ms = ms_stats([max(r["train"][name]["step_ms"][i] for r in two) for i in range(steps)])
        log(f"[multidevice] train {name} (2 ranks), {steps} steps of {batch}x{patch}x{patch}: losses "
            f"{[round(v, 6) for v in got['losses']]} ({rel:.3g} relative from one process); parameters "
            f"{pmax:.3g} max, {prms:.3g} RMS apart (bound {bound:.3g}); {step_ms['median']:.1f} ms per step "
            f"(p90 {step_ms['p90']:.1f}) against {np.median(ref_ms):.1f} ms in one process")
        result["train"][name] = dict(losses=got["losses"], max_rel=rel, params_max=pmax, params_rms=prms,
                                     bound=bound, step_ms=step_ms)

    # the fleet, one process
    frame = np.random.default_rng(SEED + 43).integers(0, 256, (*fleet_hw, 3), dtype=np.uint8)
    devices = None if cuda else [device]  # every card of the host
    placement = assign_devices(MD_FLEET, devices)
    fleet = render_fleet(frame, MD_FLEET, devices)
    for name in MD_FLEET:
        want = get_animal(name, placement[name]).visualize(frame)
        if not (np.array_equal(fleet[name][1], want[1]) and np.array_equal(fleet[name][0], want[0])):
            raise AssertionError(f"multidevice fleet: {name} differs from visualize")
    fleet_ms = wall_ms(lambda: render_fleet(frame, MD_FLEET, devices), MD_FLEET_REPS)
    visualize_ms = wall_ms(lambda: [get_animal(n, placement[n]).visualize(frame) for n in MD_FLEET], MD_FLEET_REPS)
    log(f"[multidevice] render_fleet of {', '.join(MD_FLEET)} at {fleet_hw[0]}x{fleet_hw[1]} on "
        f"{', '.join(str(placement[n]) for n in MD_FLEET)}: bit-equal to visualize; {fleet_ms['median']:.1f} ms "
        f"(p90 {fleet_ms['p90']:.1f}) against {visualize_ms['median']:.1f} ms for the four visualize calls")
    result["fleet"] = dict(hw=list(fleet_hw), devices=[str(placement[n]) for n in MD_FLEET], bit_equal=True,
                           ms=fleet_ms, visualize_ms=visualize_ms)

    t0 = time.perf_counter()
    line = dryrun.dryrun_multichip(4, device)
    result["dryrun"] = dict(line=line, seconds=time.perf_counter() - t0)
    result["seconds"] = time.perf_counter() - t_phase
    log(f"[multidevice] phase {result['seconds']:.1f} s (2-rank world {two_s:.1f} s, 4-rank world {four_s:.1f} s, "
        f"dry run {result['dryrun']['seconds']:.1f} s)")
    return result


def summary(kernel_rows: list[dict], blur_rows: list[dict], mst_rows: list[dict], ffn_rows: list[dict],
            launches: dict, ablation: dict, gelu_probe: dict) -> dict:
    """One entry per kernel: worst error over its cases and shapes; time,
    plain time, bound and library time of its heaviest main-path case at
    1080p (the masked pos kernel: its C = 31 case at 272x480, its operating
    point, with the three levels under ``cases``). Launches come from the
    main-path run of the kernel's species.
    The tensor-core kernels' ``bound_ms`` is their 3xTF32 bound (the f32
    one beside it); the convolution also reports its worst ratio to
    ``F.conv2d`` over its 10 cases, the blur its worst ratio to the
    three-call library reference over its cases. ``pointwise_u8`` also
    reports its share of the bytes bound and its ratio to the ablation's
    copy of as many 1080p frames (``nonuv_probe`` curve 0): the floor that
    a byte-wise kernel reaches on this card."""
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
        if kernel == "pointwise_u8":
            copy = next(v for v in ablation["variants"] if v["curve"] == "copy")
            copy_ms = copy["ms_per_frame"] * rep["frames"]
            out[-1].update(bound_share=rep["bound_ms"] / rep["ms"], copy_ms=copy_ms, copy_ratio=rep["ms"] / copy_ms)
    k, c = BLUR_REPRESENTATIVE
    rep = next(r for r in blur_rows if (r["ksize"], r["channels"], r["h"], r["w"]) == (k, c, *MAIN_HW))
    worst = max((r for r in blur_rows if r["library_ratio"] is not None), key=lambda r: r["library_ratio"])
    rat_uv = [dict(case=r["case"], ms=r["ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                   library_ms=r["library_ms"], plain_ms=r["plain_ms"])
              for r in blur_rows if r["channels"] == 3 and r["ksize"] in (7, 9) and (r["h"], r["w"]) == MAIN_HW]
    out.append(dict(
        name="blur_uv", route="cuda", source=SOURCES["blur_uv"], replaces=REPLACES["blur_uv"],
        launches=launches["blur_uv"], max_abs_err=max(r["max_abs_err"] for r in blur_rows),
        case=f"{rep['case']} {rep['h']}x{rep['w']}x{rep['frames']} frames",
        ms=rep["ms"], plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
        library_ms=rep["library_ms"], library_ratio_worst=worst["library_ratio"],
        library_ratio_worst_case=f"{worst['case']} {worst['h']}x{worst['w']}", rat_uv_cases=rat_uv,
    ))
    for kernel, case in MST_REPRESENTATIVE.items():
        rows = [r for r in mst_rows if r["kernel"] == kernel]
        rep = next(r for r in rows if r["case"] == case and r["point"] == "1080p")
        extra = {}
        if kernel == "attn_stats_kernel":
            extra = {"max_rel_err": max(r["err"] for r in rows)}
        if kernel in TC_KERNELS:
            extra = {**extra, "bound_f32_simt_ms": rep["bound_ms"]}
        if kernel == "conv_kernel":
            worst = max(rows, key=lambda r: r["library_ratio"])
            extra.update(library_ratio_worst=worst["library_ratio"],
                         library_ratio_worst_case=f"{worst['case']} at {worst['point']}")
        out.append(dict(
            name=kernel, route="cuda", source=SOURCES[kernel], replaces=REPLACES[kernel],
            launches=launches[kernel], max_abs_err=max(r["max_abs_err"] for r in rows),
            case=f"{rep['case']} {rep['h']}x{rep['w']}x{rep['frames']}",
            ms=rep["ms"], plain_ms=rep["plain_ms"], library_ms=rep["library_ms"],
            bound_ms=rep["bound_tc_ms"] if kernel in TC_KERNELS else rep["bound_ms"],
            bound_by=rep["bound_tc_by"] if kernel in TC_KERNELS else rep["bound_by"], **extra,
        ))
    masked = [r for r in mst_rows if r["kernel"] == "msab_pos_masked_kernel"]
    rep = masked[0]
    out.append(dict(
        name="msab_pos_masked_kernel", route="cuda", source=SOURCES["msab_pos_masked_kernel"],
        replaces=REPLACES["msab_pos_masked_kernel"], launches=launches["msab_masked_kernel"],
        max_abs_err=max(r["max_abs_err"] for r in masked), case=f"{rep['case']} {rep['h']}x{rep['w']}x{rep['frames']}",
        ms=rep["ms"], plain_ms=rep["plain_ms"], library_ms=None, bound_ms=rep["bound_tc_ms"],
        bound_by=rep["bound_tc_by"], bound_f32_simt_ms=rep["bound_ms"],
        cases=[dict(case=r["case"], h=r["h"] >> i, w=r["w"] >> i, ms=r["ms"], bound_ms=r["bound_tc_ms"],
                    bound_share=r["bound_tc_ms"] / r["ms"]) for i, r in enumerate(masked)],
    ))
    rep = next(r for r in ffn_rows if r["case"] == "C=31" and r["point"] == "honeybee")
    out.append(dict(
        name="ffn_kernel", route="cuda", source=SOURCES["ffn_kernel"], replaces=REPLACES["ffn_kernel"],
        launches=launches["ffn_kernel"], max_abs_err=max(r["max_abs_err"] for r in ffn_rows),
        case=f"{rep['case']} {rep['h']}x{rep['w']}x{rep['frames']}",
        ms=rep["ms"], plain_ms=rep["plain_ms"], bound_ms=rep["bound_tc_ms"], bound_by=rep["bound_tc_by"],
        library_ms=None, bound_f32_simt_ms=rep["bound_ms"],
    ))
    for r in gelu_probe["cases"]:
        out.append(dict(
            name=f"gelu_probe.{r['case']}.{r['dtype']}", route="cuda", source=SOURCES["gelu_probe"],
            replaces=REPLACES["gelu_probe"], launches=r["launches"], max_abs_err=r["max_abs_err"],
            case=f"{r['reps']} applications over {r['shape'][0]}x{r['shape'][1]}, the probe's own run",
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=None,
            ns_per_elem_app=r["ns_per_elem_app"], ratio_to_single_madd=r["ratio_to_single_madd"],
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
    os.environ.pop("ANIMAL_VISION_MAX_PIXELS", None)
    reset_counters()
    kernel_rows = kernels_phase(device)
    blur_rows = blur_phase(device)
    mst_rows = mst_kernels_phase(device)
    ffn_rows = ffn_phase(device)
    ablation = ablation_phase(device)
    gelu_probe = gelu_probe_phase(device)
    no_rungs("kernels")
    main_run = main_path_phase(device)
    no_rungs("main")
    uv_run = uv_main_path_phase(device)
    no_rungs("main uv")
    mst_run = mst_main_path_phase(device)
    no_rungs("main mst++")
    mst_l_run = mst_l_main_path_phase(device)
    no_rungs("main mst-l")
    zoo_run = zoo_phase(device)
    no_rungs("zoo")
    stream_run = stream_phase(device, {**main_run["species"], **uv_run["species"]})
    no_rungs("stream")
    serve_run = serve_phase(device)
    no_rungs("serve")
    train_run = train_phase(device)
    no_rungs("train")
    tools_run = tools_phase(device)
    no_rungs("tools")
    multidevice_run = multidevice_phase(device)
    no_rungs("multidevice")
    library_run = library_phase(device)
    no_rungs("library")
    profile_run = profile_phase(device)
    no_rungs("profile")
    degrade_run = degrade_phase(device)
    if any(m.startswith("jax") or m == "animal_vision_tpu" or m.startswith("animal_vision_tpu.")
           for m in sys.modules):
        raise AssertionError("the port imported JAX or the JAX package")
    log(f"[main] 20-species harmonic mean at {MAIN_HW[0]}x{MAIN_HW[1]}, batch of {BATCH} on the device: "
        f"{main_run['hm_fps']:.1f} fps; through visualize (host round trip): "
        f"{main_run['hm_visualize_fps']:.1f} fps; card: {info['card']}")
    log(f"[main] {len(uv_run['species'])}-UV-species harmonic mean at {MAIN_HW[0]}x{MAIN_HW[1]}, batch of {BATCH} "
        f"on the device: {uv_run['hm_fps']:.1f} fps ({len(uv_run['species']) - 1} without rat_uv: "
        f"{uv_run['hm_fps_without_rat_uv']:.1f} fps); through visualize: {uv_run['hm_visualize_fps']:.1f} fps "
        f"({uv_run['hm_visualize_fps_without_rat_uv']:.1f} fps)")
    launches = {**main_run["launches"], "blur_uv": uv_run["launches"]["blur_uv"],
                **{k: mst_run["launches"][k] for k in MST_PER_FORWARD}, "ffn_kernel": mst_l_run["launches"]["ffn"],
                "msab_masked_kernel": mst_l_run["launches"]["msab_masked_kernel"]}
    kernels = summary(kernel_rows, blur_rows, mst_rows, ffn_rows, launches, ablation, gelu_probe)
    REPORT.parent.mkdir(exist_ok=True)
    REPORT.write_text(json.dumps(dict(device=info, build=build, ablation=ablation, kernel_cases=kernel_rows,
                                      blur_cases=blur_rows,
                                      mst_cases=mst_rows, ffn_cases=ffn_rows, main_path=main_run,
                                      uv_main_path=uv_run, mst_main_path=mst_run, mst_l_main_path=mst_l_run,
                                      gelu_probe=gelu_probe, zoo=zoo_run,
                                      stream=stream_run, serve=serve_run, train=train_run, tools=tools_run,
                                      multidevice=multidevice_run, library=library_run,
                                      profile=profile_run,
                                      degrade=degrade_run,
                                      kernels=kernels["kernels"], seconds=time.perf_counter() - t0), indent=1))
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(info["card"])
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["kind"], "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
