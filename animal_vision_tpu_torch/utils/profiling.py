"""Tracing and per-stage timing: the port's one tracing module, the
counterpart of ``animal_vision_tpu/utils/profiling.py``.

- ``span(name, **attrs)``: a span at a layer boundary. The switch is
  ``torch.profiler`` itself. While no profiler collects, ``span`` reads one
  attribute and returns a shared null context: no ``record_function``, no
  clock, no lock, no record. While one collects, it enters
  ``torch.profiler.record_function(name)`` (a ``user_annotation`` of the
  trace, on the profiler's clock) and keeps a ``Span`` record (name, start
  and end in ns, id, the id of the thread's enclosing span, thread id,
  ``attrs``) in a bounded buffer: ``spans()``, ``clear()``, ``dropped()``.
  ``with span(...) as s`` binds the record, or None while tracing is off.
- ``span(..., into=timer, stage=...)`` also books the span's seconds into a
  ``stage_timer``, under ``stage`` (default: the span's name), whether
  tracing is on or off. A span inside another span of its thread that
  books into the same timer books nothing: its time is in the outer one.
- ``record(name, t0_ns, t1_ns, **attrs)``: an interval measured elsewhere
  that cannot nest (the executor's emit hold), into the buffer only, while
  tracing is on.
- ``trace_offset_ns(events)``: the one offset that maps the records of a
  profiler session onto its exported Chrome trace.
- ``SETUP``: the ``stage_timer`` of the program's set-up work (libraries,
  the encode table, per-shape programs, MST++ layouts, executor buffers).
- ``sync``: wait for the card (a no-op on the CPU).
- ``stage_timer``: seconds and counts per named stage, from any thread.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict

import torch
import torch.autograd.profiler as _profiler

#: the most records the buffer keeps; later ones are counted as dropped
CAPACITY = 1 << 20

_NULL = contextlib.nullcontext()
_ids = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()
_buffer: list = []
_dropped = 0


def sync(target) -> None:
    """Wait until the card has finished the work queued on the device of
    ``target`` (a device, a device name or a tensor); nothing on the CPU."""
    device = target.device if isinstance(target, torch.Tensor) else torch.device(target)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class stage_timer:
    """Accumulates seconds and counts per stage: ``add`` books a time
    measured elsewhere (CUDA events), ``span(..., into=timer)`` a block's.
    Safe to use from several threads."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1


#: the program's set-up work, booked by the spans that do it
SETUP = stage_timer()


class Span:
    """One record of the buffer: times from ``time.perf_counter_ns``."""

    __slots__ = ("name", "t0_ns", "t1_ns", "id", "parent", "tid", "attrs")

    def __init__(self, name: str, t0_ns: int, t1_ns: int, id: int, parent: int | None, tid: int, attrs: dict):
        self.name, self.t0_ns, self.t1_ns = name, t0_ns, t1_ns
        self.id, self.parent, self.tid, self.attrs = id, parent, tid, attrs


def _thread_state():
    """This thread's open span ids, the timers its open spans book into, and
    its native id (read once: it is a system call, which costs several
    microseconds on some hosts)."""
    st = getattr(_local, "st", None)
    if st is None:
        st = _local.st = ([], [], threading.get_native_id())
    return st


def _keep(rec: Span) -> None:
    global _dropped
    with _lock:
        if len(_buffer) < CAPACITY:
            _buffer.append(rec)
        else:
            _dropped += 1


def _claim(booking: list, timer) -> bool:
    """Whether this span books into ``timer``: no enclosing span of the
    thread does already."""
    if timer is None or any(t is timer for t in booking):
        return False
    booking.append(timer)
    return True


class _Timed:
    """Tracing off, ``into`` given: the span's seconds into the timer."""

    __slots__ = ("timer", "stage", "t0", "own")

    def __init__(self, timer, stage: str):
        self.timer, self.stage = timer, stage

    def __enter__(self):
        self.own = _claim(_thread_state()[1], self.timer)
        self.t0 = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        if self.own:
            _thread_state()[1].pop()
            self.timer.add(self.stage, dt / 1e9)
        return False


class _Span:
    """Tracing on: a ``record_function`` range and a record."""

    __slots__ = ("rec", "timer", "stage", "range", "own")

    def __init__(self, name: str, attrs: dict, timer, stage: str):
        self.rec = Span(name, 0, 0, 0, None, 0, attrs)
        self.timer, self.stage = timer, stage

    def __enter__(self) -> Span:
        opened, booking, tid = _thread_state()
        rec = self.rec
        rec.id, rec.parent, rec.tid = next(_ids), opened[-1] if opened else None, tid
        opened.append(rec.id)
        self.own = _claim(booking, self.timer)
        self.range = torch.profiler.record_function(rec.name)
        # stamped outside the range, so that the range (whose first one in a
        # process takes a lazy set-up after its start) lies inside the record
        # and ends where the record ends, on every span alike
        rec.t0_ns = time.perf_counter_ns()
        self.range.__enter__()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        self.range.__exit__(*exc)
        rec.t1_ns = time.perf_counter_ns()
        opened, booking, _ = _thread_state()
        opened.pop()
        if self.own:
            booking.pop()
            self.timer.add(self.stage, (rec.t1_ns - rec.t0_ns) / 1e9)
        _keep(rec)
        return False


def span(name: str, into: stage_timer | None = None, stage: str | None = None, **attrs):
    """A context for the block's span ``name`` (see the module's text)."""
    if not _profiler._is_profiler_enabled:
        return _NULL if into is None else _Timed(into, stage or name)
    return _Span(name, attrs, into, stage or name)


def record(name: str, t0_ns: int, t1_ns: int, **attrs) -> None:
    """Keep an interval of ``time.perf_counter_ns`` stamps taken elsewhere,
    while tracing is on; its parent is the thread's open span."""
    if not _profiler._is_profiler_enabled:
        return
    opened, _, tid = _thread_state()
    _keep(Span(name, t0_ns, t1_ns, next(_ids), opened[-1] if opened else None, tid, attrs))


def spans() -> list[Span]:
    """The buffer's records, each kept when its span ended."""
    with _lock:
        return list(_buffer)


def dropped() -> int:
    """Records not kept since the last ``clear`` because the buffer was full."""
    return _dropped


def clear() -> None:
    """Empty the buffer and its count of dropped records."""
    global _dropped
    with _lock:
        _buffer.clear()
        _dropped = 0


def trace_offset_ns(events: list[dict], records: list[Span] | None = None) -> int | None:
    """The offset, in ns, from a record's stamps to the exported trace's
    ``ts`` (µs): each record's ``user_annotation`` range lies within
    ``[t0_ns + offset, t1_ns + offset]``. ``events`` are the Chrome trace's
    ``traceEvents``; ``records`` (default ``spans()``) those of the same
    profiler session. The records of each name and thread are paired in
    order with the trace's ranges of that name and thread where both count
    the same. A record ends after its range, by at least the range's exit
    (by more where the thread was preempted), so the offset is the largest
    of the pairs' differences of ends; None where nothing pairs."""
    records = spans() if records is None else records
    ranges = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            ranges[(e["name"], e.get("tid"))].append(float(e["ts"]) + float(e["dur"]))
    mine = defaultdict(list)
    for s in records:
        mine[(s.name, s.tid)].append(s.t1_ns)
    offsets = []
    for key, ends in mine.items():
        got = ranges.get(key, [])
        if len(got) == len(ends):
            offsets += [round(end * 1000.0) - t1 for end, t1 in zip(sorted(got), sorted(ends))]
    return max(offsets) if offsets else None
