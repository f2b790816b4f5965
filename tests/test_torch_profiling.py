"""The port's spans (``animal_vision_tpu_torch/utils/profiling.py``) on the
CPU: with no profiler running a span enters no ``record_function``, reads
no clock, takes no lock and keeps nothing; under ``torch.profiler`` its
records nest, carry their thread and attributes, and share one offset with
the exported trace; the executor's hold per batch and its early emits under
a paced producer; ``SETUP``'s program builds; and the benchmark's readers
of the spans and the trace's gap labels on synthetic inputs."""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from animal_vision_tpu_torch.pipeline import StreamingExecutor
from animal_vision_tpu_torch.species.nonuv import NONUV_SPECS, NonUVAnimal
from animal_vision_tpu_torch.utils import profiling as P
from portbench import harness
from portbench import trace as tracing


@pytest.fixture(autouse=True)
def _empty_buffer():
    P.clear()
    yield
    P.clear()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _boom(*a, **k):
    raise AssertionError("called while tracing is off")


def test_off_enters_no_range_reads_no_clock_and_keeps_nothing(monkeypatch):
    class NoLock:
        def __enter__(self):
            raise AssertionError("lock taken while tracing is off")

        __exit__ = __enter__

    monkeypatch.setattr(torch.profiler, "record_function", _boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _boom)
    monkeypatch.setattr(time, "perf_counter_ns", _boom)
    monkeypatch.setattr(time, "perf_counter", _boom)
    monkeypatch.setattr(P, "_lock", NoLock())
    assert not torch.autograd.profiler._is_profiler_enabled
    first = P.span("species.program", species="dog", frames=4)
    assert P.span("ops.launch", entry="av_iso_u8") is first  # one shared null context
    with first as s:
        assert s is None
        with P.span("executor.wait", batch=3):
            pass
    P.record("executor.held", 1, 2, batch=0, frames=1)
    monkeypatch.undo()
    assert P.spans() == [] and P.dropped() == 0


def test_off_with_into_books_the_timer_and_keeps_no_record():
    t = P.stage_timer()
    with P.span("executor.sink", into=t, stage="sink", batch=0) as s:
        time.sleep(0.002)
    with P.span("executor.setup", into=t):
        pass
    assert s is None and P.spans() == []
    assert dict(t.counts) == {"sink": 1, "executor.setup": 1} and t.totals["sink"] >= 0.002


@pytest.mark.parametrize("traced", [False, True])
def test_a_span_inside_one_booking_the_same_timer_books_nothing(traced):
    t, other = P.stage_timer(), P.stage_timer()
    ctx = _cpu_profile() if traced else None
    if ctx:
        ctx.__enter__()
    try:
        with P.span("species.build", into=t):
            with P.span("ops.build", into=t, library="fused_nonuv"):
                with P.span("model.layouts", into=other):
                    time.sleep(0.001)
    finally:
        if ctx:
            ctx.__exit__(None, None, None)
    assert dict(t.counts) == {"species.build": 1} and dict(other.counts) == {"model.layouts": 1}
    assert t.totals["species.build"] >= other.totals["model.layouts"] >= 0.001
    assert len(P.spans()) == (3 if traced else 0)


def test_on_nests_keeps_threads_and_attributes():
    def producer():
        for b in range(3):
            with P.span("executor.put", batch=b):
                pass

    with _cpu_profile():
        with P.span("species.program", species="dog", frames=4) as outer:
            with P.span("ops.launch", entry="av_iso_u8") as inner:
                pass
            th = threading.Thread(target=producer)
            th.start()
            th.join(timeout=60)
            P.record("executor.held", 10, 20, batch=7, frames=2)
    assert not th.is_alive()
    recs = {s.name: s for s in P.spans()}
    assert recs["species.program"] is outer and recs["ops.launch"] is inner
    assert outer.parent is None and inner.parent == outer.id
    assert outer.t0_ns <= inner.t0_ns <= inner.t1_ns <= outer.t1_ns
    assert outer.attrs == {"species": "dog", "frames": 4} and inner.attrs == {"entry": "av_iso_u8"}
    held = recs["executor.held"]
    assert (held.t0_ns, held.t1_ns, held.parent, held.attrs) == (10, 20, outer.id, {"batch": 7, "frames": 2})
    puts = [s for s in P.spans() if s.name == "executor.put"]
    assert [s.attrs["batch"] for s in puts] == [0, 1, 2]
    assert {s.tid for s in puts} == {th.native_id} != {outer.tid}
    assert all(s.parent is None for s in puts)  # another thread's stack
    assert outer.tid == threading.get_native_id()
    assert len({s.id for s in P.spans()}) == len(P.spans())


def test_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(P, "CAPACITY", 5)
    with _cpu_profile():
        for i in range(8):
            with P.span("executor.wait", batch=i):
                pass
    assert [s.attrs["batch"] for s in P.spans()] == [0, 1, 2, 3, 4] and P.dropped() == 3
    P.clear()
    assert P.spans() == [] and P.dropped() == 0


def test_one_offset_maps_every_span_onto_the_trace(tmp_path):
    with _cpu_profile() as prof:
        for i in range(20):
            with P.span("species.program", species="cat", frames=1):
                torch.ones(256).sum()
                with P.span("ops.launch", entry="av_iso_u8"):
                    time.sleep(0.0002)
            time.sleep(0.001)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = sorted((e["name"], float(e["ts"]), float(e["dur"])) for e in events
                    if e.get("cat") == "user_annotation" and e["name"] in ("species.program", "ops.launch"))
    recs = sorted(P.spans(), key=lambda s: (s.name, s.t0_ns))
    assert len(ranges) == len(recs) == 40
    # each span bounds the offset: at least its ends' difference, at most its
    # starts' (a preempted thread only widens the bounds); one offset within
    # 50 µs of every span's bounds maps each range inside its own record
    low = [(ts + dur) * 1000.0 - s.t1_ns for (name, ts, dur), s in zip(ranges, recs)]
    high = [ts * 1000.0 - s.t0_ns for (name, ts, dur), s in zip(ranges, recs)]
    assert max(low) <= min(high) + 50_000
    off = P.trace_offset_ns(events)
    assert off == pytest.approx(max(low), abs=1)
    for (name, ts, dur), s in zip(ranges, recs):
        assert name == s.name
        assert s.t0_ns + off - 50_000 <= ts * 1000.0 <= (ts + dur) * 1000.0 <= s.t1_ns + off + 50_000


def _dog():
    return NonUVAnimal(NONUV_SPECS["dog"], "cpu")


def test_setup_counts_a_program_build_on_the_first_call_only():
    dog = _dog()
    frames = np.random.default_rng(0).integers(0, 256, (2, 16, 24, 3), dtype=np.uint8)
    before = P.SETUP.counts.get("species.build", 0)
    dog.visualize_batch(frames)
    assert P.SETUP.counts["species.build"] == before + 1
    total = P.SETUP.totals["species.build"]
    dog.visualize_batch(frames)
    dog.visualize_batch_device(torch.from_numpy(frames))
    assert P.SETUP.counts["species.build"] == before + 1 and P.SETUP.totals["species.build"] == total


def test_species_program_spans_of_the_entry_points():
    dog = _dog()
    frames = np.random.default_rng(1).integers(0, 256, (3, 16, 24, 3), dtype=np.uint8)
    dog.visualize_batch(frames)  # built untraced
    with _cpu_profile():
        dog.visualize_batch(frames)
        dog.visualize_batch_device(torch.from_numpy(frames))
        dog.visualize(frames[0])
    progs = [s for s in P.spans() if s.name == "species.program"]
    assert [s.attrs for s in progs] == [{"species": "dog", "frames": 3}] * 2 + [{"species": "dog", "frames": 1}]
    assert not [s for s in P.spans() if s.name == "species.build"]


def _run(ex, frames):
    got = []
    assert ex.run(iter(frames), got.append) == len(frames)
    return got


def test_executor_holds_one_record_per_batch_and_keeps_its_stages():
    frames = [np.random.default_rng(i).integers(0, 256, (16, 24, 3), dtype=np.uint8) for i in range(7)]
    ex = StreamingExecutor(_dog(), batch=3, split=False)
    want = _run(ex, frames)
    untraced = (dict(ex.timer.counts), set(ex.timer.totals))
    assert P.spans() == []
    with _cpu_profile():
        got = _run(ex, frames)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    counts = dict(ex.timer.counts)
    assert (counts, set(ex.timer.totals)) == untraced
    assert counts == {"ring put": 7, "ring to pinned": 3, "compute": 3, "sink": 3}
    held = [s for s in P.spans() if s.name == "executor.held"]
    assert [{k: v for k, v in s.attrs.items() if k != "early"} for s in held] == [
        {"batch": 0, "frames": 3}, {"batch": 1, "frames": 3}, {"batch": 2, "frames": 1}]
    # whether a batch found its successor readable depends on the producer's
    # pace; the last never does
    early = [s.attrs["early"] for s in held]
    assert all(isinstance(e, bool) for e in early) and early[-1] and sum(early) == ex.emitted_early
    by = {}
    for s in P.spans():
        by.setdefault(s.name, []).append(s)
    for h in held:
        d = next(s for s in by["executor.dispatch"] if s.attrs["batch"] == h.attrs["batch"])
        r = next(s for s in by["executor.ready"] if s.attrs["batch"] == h.attrs["batch"])
        assert (h.t0_ns, h.t1_ns) == (d.t1_ns, r.t0_ns) and h.t1_ns >= h.t0_ns
    assert len(by["executor.wait"]) == 4  # the last wait finds the ring closed
    assert [s.attrs["batch"] for s in by["executor.put"]] == [0, 0, 0, 1, 1, 1, 2]
    assert {s.tid for s in by["executor.put"]} != {held[0].tid}
    assert len(by["executor.setup"]) == 2 and len(by["species.program"]) == 3
    # a stage's seconds are its spans' seconds, not a second pair of clock reads
    for stage, name in (("ring put", "executor.put"), ("ring to pinned", "executor.to_pinned"),
                        ("sink", "executor.sink"), ("compute", "species.program")):
        assert ex.timer.totals[stage] == pytest.approx(sum(s.t1_ns - s.t0_ns for s in by[name]) / 1e9)


def test_paced_stream_emits_each_batch_early_and_holds_it_briefly():
    """A producer that sleeps before each frame after the first: the
    ``executor.held`` records say ``early`` (at least 4 of 5, the last
    always), the run counts as many, and each hold is shorter than the producer's gap (a frame held until the
    next one came would read about the gap)."""
    gap_s = 0.1
    frames = [np.random.default_rng(i).integers(0, 256, (16, 24, 3), dtype=np.uint8) for i in range(5)]
    dog = _dog()
    dog.visualize(frames[0])  # built untraced

    def paced():
        for i, f in enumerate(frames):
            if i:
                time.sleep(gap_s)
            yield f

    ex = StreamingExecutor(dog, batch=1, split=False)
    got = []
    with _cpu_profile():
        assert ex.run(paced(), got.append) == len(frames)
    assert all(np.array_equal(g, dog.visualize(f)[1]) for g, f in zip(got, frames, strict=True))
    held = [s for s in P.spans() if s.name == "executor.held"]
    assert [s.attrs["batch"] for s in held] == list(range(5))
    early = [s.attrs["early"] for s in held]
    assert sum(early) >= 4 and early[-1] and ex.emitted_early == sum(early)
    assert all(s.t1_ns - s.t0_ns < gap_s * 1e9 for s in held), [s.t1_ns - s.t0_ns for s in held]


def test_trace_reduce_puts_a_gap_inside_a_program_span_under_its_name():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW, "ts": 0.0, "dur": 1000.0, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.call dog", "ts": 100.0, "dur": 600.0, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "species.program", "ts": 110.0, "dur": 500.0, "tid": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 120.0, "dur": 10.0, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "ops.launch", "ts": 500.0, "dur": 40.0, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "iso_kernel", "ts": 0.0, "dur": 200.0, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "iso_kernel", "ts": 520.0, "dur": 480.0, "tid": 7},
    ]
    got = tracing.reduce(ev)
    # the gap 200..520 µs has its middle at 360, inside species.program and no op
    assert got["idle_gaps"] == [["species.program", pytest.approx(320e-6)]]
    assert got["busy_s"] == pytest.approx(680e-6) and got["window_s"] == pytest.approx(1e-3)


def _span(name, t0, t1, id, parent=None, **attrs):
    return P.Span(name, int(t0), int(t1), id, parent, 1, attrs)


MS = 1_000_000  # ns
BUFFER = [
    _span("species.program", 0, 2 * MS, 1, frames=4),
    _span("species.build", 0, MS, 2, parent=1),
    _span("species.program", 0, MS, 3, parent=2, frames=4),  # nested: not counted again
    _span("species.program", 3 * MS, 4 * MS, 4, frames=4),
    _span("ops.launch", 3 * MS, 3.5 * MS, 5, parent=4),
    *[_span("executor.held", 0, (30 + k) * MS, 10 + k, batch=k, frames=1) for k in range(19)],
    _span("executor.held", 0, 100 * MS, 40, batch=19, frames=2),
]


def _setup_timer():
    t = P.stage_timer()
    t.add("ops.build", 1.5)
    t.add("species.build", 0.25)
    t.add("executor.setup", 0.125)
    return t


@pytest.mark.parametrize("name, want", [
    ("species.host_ms_per_frame", 3.0 / 8),
    ("executor.held_ms_p95.live", 100.0),  # 21 frames: rank 20 is the batch of 2
    ("setup.program_s", 1.875),
])
@pytest.mark.parametrize("buffer", ["synthetic", "empty", "absent"])
def test_readers_of_the_program_spans(monkeypatch, name, want, buffer):
    if buffer == "absent":  # a program whose profiling module has no spans or SETUP
        monkeypatch.delattr(P, "spans")
        monkeypatch.delattr(P, "SETUP")
    else:
        monkeypatch.setattr(P, "spans", lambda: list(BUFFER) if buffer == "synthetic" else [])
        monkeypatch.setattr(P, "SETUP", _setup_timer() if buffer == "synthetic" else P.stage_timer())
    got = harness.reader(name).read(harness.Reading())
    if buffer == "synthetic":
        assert got == pytest.approx(want)
    else:
        assert got is None


def test_held_p95_is_nearest_rank_over_frames(monkeypatch):
    holds = [_span("executor.held", 0, (k + 1) * MS, k + 1, batch=k, frames=1) for k in range(100)]
    monkeypatch.setattr(P, "spans", lambda: holds)
    assert harness.reader("executor.held_ms_p95.live").read(harness.Reading()) == pytest.approx(95.0)


def test_the_new_metrics_resolve_in_their_cells():
    for cell, names in (("nonuv20.device_1080p_b4", {"species.host_ms_per_frame", "setup.program_s"}),
                        ("honeybee_mstpp.device_1080p_b4", {"setup.program_s"}),
                        ("nonuv20.webcam_720p_30fps", {"executor.held_ms_p95.live", "setup.program_s"})):
        traced = {n for n, _ in harness.resolve(cell, True).metrics}
        assert names <= traced and not names & {n for n, _ in harness.resolve(cell, False).metrics}
