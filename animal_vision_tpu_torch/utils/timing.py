"""Device timing on CUDA events: the one timer of ``chip_smoke.py`` and the
port's counterpart of ``animal_vision_tpu/utils/timing.py``.

PyTorch returns before the card finishes, so a host clock around calls
measures their enqueue. Both functions here time on the card with CUDA
events and refuse a CPU device: a CPU time is never a device metric.
"""

from __future__ import annotations

import time

import torch

# time_ms: the card's wait before a timed run, at most; cycles per second of
# that wait (at least the SM clock, so the wait lasts at least as long)
QUEUE_AHEAD_S = 0.2
SLEEP_CYCLES_PER_S = 2.0e9


def _require_cuda(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"device timing runs on a CUDA device, got {device}")
    return device


def time_ms(fn, reps: int, device, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls after
    ``warmup``, by CUDA events, with the calls queued ahead: the card first
    waits (``torch.cuda._sleep``) for 1.5 times as long as the host took to
    make ``reps`` warm-up calls (at most ``QUEUE_AHEAD_S``), so that a
    wrapper's host time per call does not show as the kernel's."""
    device = _require_cuda(device)
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        torch.cuda._sleep(int(min(QUEUE_AHEAD_S, 1.5 * host_s * reps) * SLEEP_CYCLES_PER_S))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_chained(prog, frames: torch.Tensor, iters: int, reps: int = 2) -> float:
    """Best seconds per frame of a batched (N, ...) -> (N, ...) program over
    ``reps`` passes of ``iters`` chained calls, each call fed the previous
    output, by CUDA events around each pass (the first call, which builds the
    program, is not timed)."""
    device = _require_cuda(frames.device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(device):
        prog(frames)
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(reps):
            start.record()
            y = frames
            for _ in range(iters):
                y = prog(y)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3 / (iters * frames.shape[0]))
    return best
