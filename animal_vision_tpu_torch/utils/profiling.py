"""Tracing and per-stage timing: the port's counterpart of
``animal_vision_tpu/utils/profiling.py``.

- ``trace(dir)``: ``torch.profiler`` around a block (the card's activity
  too where there is one), written as a Chrome trace into ``dir``.
- ``sync``: wait for the card (a no-op on the CPU).
- ``stage_timer``: seconds and counts per named stage; the streaming
  executor fills one from two threads.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import defaultdict

import torch

logger = logging.getLogger("animal_vision_tpu_torch")


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; write ``trace.json`` (Chrome format) into
    ``log_dir``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def sync(target) -> None:
    """Wait until the card has finished the work queued on the device of
    ``target`` (a device, a device name or a tensor); nothing on the CPU."""
    device = target.device if isinstance(target, torch.Tensor) else torch.device(target)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class stage_timer:
    """Accumulates seconds per stage; ``report()`` logs a summary.

        with timers.stage("compute", sync_value=device):
            out = program(frames)

    ``add`` books a time measured elsewhere (CUDA events). Safe to use from
    several threads."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1

    @contextlib.contextmanager
    def stage(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_value is not None:
                sync(sync_value)
            self.add(name, time.perf_counter() - t0)

    def report(self) -> str:
        with self._lock:
            rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
            lines = [
                f"{name}: {tot * 1e3:.2f} ms total / {self.counts[name]}x "
                f"({tot / max(self.counts[name], 1) * 1e3:.2f} ms avg)"
                for name, tot in rows
            ]
        text = "\n".join(lines)
        logger.info("stage timings:\n%s", text)
        return text
