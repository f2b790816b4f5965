"""Reduction of a ``torch.profiler`` trace of the measured window.

The benchmark marks the window with a ``portbench.window`` range and its
own calls with ``portbench.*`` ranges; the device's activity is the
trace's kernel, memcpy and memset records. From those: the window's
length, the time the card was busy (the union of the records' intervals
inside the window, however many streams ran at once), the time its
kernels were busy, the operations that took most device time, and the
idle gaps summed by what the host was doing (the innermost host range or
operation of the thread that ran the window, at the gap's middle).
"""

from __future__ import annotations

import bisect
import json
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "portbench.window"
TOP = 10


def load(path: Path) -> list[dict]:
    return json.loads(Path(path).read_text())["traceEvents"]


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def _clip(intervals, lo, hi):
    return [(max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi]


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def _host_label(hosts: list[tuple[float, float, str]], starts: list[float], t: float) -> str:
    """The innermost host range that holds ``t``: the latest-starting one
    that has not ended."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 200), -1):
        lo, hi, name = hosts[j]
        if hi >= t and name != WINDOW:
            return name
    return "python, no torch op"


def reduce(events: list[dict]) -> dict | None:
    """The window's reading, or None where the trace has no window."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW]
    if not win:
        return None
    w0, w1 = float(win[0]["ts"]), float(win[0]["ts"]) + float(win[0]["dur"])
    tid = win[0].get("tid")
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev]
    busy = _clip(union(spans), w0, w1)
    kbusy = _clip(union([s for s, e in zip(spans, dev) if e["cat"] == "kernel"]), w0, w1)

    by_name: dict[str, float] = {}
    for (a, b), e in zip(spans, dev):
        lo, hi = max(a, w0), min(b, w1)
        if hi > lo:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + (hi - lo) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    hosts = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in HOST_CATS and e.get("tid") == tid)
    starts = [h[0] for h in hosts]
    by_host: dict[str, float] = {}
    for a, b in gaps:
        label = _host_label(hosts, starts, 0.5 * (a + b))
        by_host[label] = by_host.get(label, 0.0) + (b - a) / 1e6
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": _length(busy) / 1e6,
        "kernel_busy_s": _length(kbusy) / 1e6,
        "device_ops": [[k, v] for k, v in top],
        "idle_gaps": [[k, v] for k, v in idle],
    }
