"""The metric arithmetic on synthetic readings and traces, and the open
loop's schedule."""

from __future__ import annotations

import math
import time

import numpy as np
import pytest
import torch

from portbench import compare, harness, peaks
from portbench import trace as tracing
from portbench import traffic as gen


def read(name: str, r) -> float | None:
    return harness.reader(name).read(r)


def reading(**kw):
    r = harness.Reading()
    for k, v in kw.items():
        setattr(r, k, v)
    return r


SPANS = {"ring put": 0.2, "ring to pinned": 0.3, "sink": 0.1, "h2d": 0.4, "compute": 0.25, "d2h": 0.35}
TRACE = {"window_s": 10.0, "busy_s": 2.5, "kernel_busy_s": 2.0, "device_ops": [], "idle_gaps": []}


@pytest.mark.parametrize("name, kw, want", [
    ("fps", dict(frames=800, window_s=10.0), 80.0),
    ("fps.mstpp", dict(frames=300, window_s=20.0), 15.0),
    ("setup_s", dict(setup_s=12.5), 12.5),
    ("executor.stage_ms_per_frame.live", dict(frames=100, spans=SPANS), 16.0),
    ("program_ms_per_frame", dict(frames=8, call_ms=[3.0, 5.0]), 1.0),
    ("program_ms_per_frame.mstpp", dict(frames=8, call_ms=[100.0, 300.0]), 50.0),
    ("mstpp.mfu_pct", dict(window_s=2.0, work={"mstpp_flops": 0.2 * peaks.TF32_FLOPS}), 10.0),
    ("kernels_roofline", dict(trace=TRACE, work={"least_s": 0.5}), 25.0),
    ("kernels_roofline.mstpp", dict(trace=TRACE, work={"least_s": 0.1}), 5.0),
    ("device.idle_pct", dict(trace=TRACE), 75.0),
    ("device.idle_pct.mstpp", dict(trace=TRACE), 75.0),
    ("device.idle_pct.live", dict(trace=TRACE), 75.0),
    ("frame_ms_p95.live", dict(latencies_ms=list(range(100, 0, -1))), 95.0),
    ("frame_on_time_pct", dict(latencies_ms=[1.0, 1e3 / 30, 33.4, 5.0], period_ms=1e3 / 30), 75.0),
    ("frame_on_time_pct", dict(latencies_ms=[8.0] * 1528 + [40.0, math.inf], period_ms=1e3 / 30),
     100.0 * 1528 / 1530),
    ("frame_on_time_pct", dict(latencies_ms=[1.0, 1e3 / 30, 20.0, 5.0], period_ms=1e3 / 60), 50.0),
])
def test_reader_arithmetic(name, kw, want):
    assert read(name, reading(**kw)) == pytest.approx(want)


@pytest.mark.parametrize("name", ["fps", "fps.mstpp", "frame_ms_p95", "frame_on_time_pct",
                                  "executor.stage_ms_per_frame.live",
                                  "program_ms_per_frame", "program_ms_per_frame.mstpp", "mstpp.mfu_pct",
                                  "kernels_roofline", "kernels_roofline.mstpp", "device.idle_pct",
                                  "device.idle_pct.mstpp", "device.idle_pct.live"])
def test_reader_with_nothing_to_read_returns_nothing(name):
    assert read(name, harness.Reading()) is None


def test_a_split_metric_is_read_by_the_reader_of_its_stem():
    assert harness.reader("fps.mstpp").__file__ == harness.reader("fps").__file__
    assert harness.reader("device.idle_pct.live").__file__.endswith("device.idle_pct.py")
    assert harness.reader("executor.stage_ms_per_frame.live").__file__.endswith("stage_ms_per_frame.live.py")
    with pytest.raises(FileNotFoundError):
        harness.reader("no_such_metric.mstpp")


def test_p95_is_the_nearest_rank_and_a_missing_frame_misses():
    lat = list(range(1, 101))
    assert read("frame_ms_p95", reading(latencies_ms=lat)) == 95
    assert read("frame_ms_p95", reading(latencies_ms=lat[:94] + [math.inf] * 6)) == 1e9
    assert compare.nearest_rank([5.0], 95) == 5.0


def test_on_time_share_counts_a_missing_frame_as_late():
    assert read("frame_on_time_pct", reading(latencies_ms=[5.0] * 3 + [math.inf], period_ms=40.0)) == 75.0
    assert read("frame_on_time_pct", reading(latencies_ms=[math.inf] * 2, period_ms=40.0)) == 0.0
    # a reading with no period (no open loop) has no deadline to count against
    assert read("frame_on_time_pct", reading(latencies_ms=[5.0] * 3)) is None


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}


def test_trace_reduction_on_a_synthetic_window():
    events = [
        _x(tracing.WINDOW, "user_annotation", 0, 1000),
        _x("portbench.call dog", "user_annotation", 0, 400),
        _x("aten::copy_", "cpu_op", 450, 100),
        _x("k1", "kernel", 100, 200, tid=7),
        _x("k2", "kernel", 250, 100, tid=8),  # overlaps k1 on another stream
        _x("Memcpy HtoD", "gpu_memcpy", 600, 100, tid=7),
        _x("k1", "kernel", 900, 300, tid=7),  # runs past the window
    ]
    got = tracing.reduce(events)
    assert got["window_s"] == pytest.approx(1e-3)
    assert got["busy_s"] == pytest.approx((250 + 100 + 100) * 1e-6)
    assert got["kernel_busy_s"] == pytest.approx((250 + 100) * 1e-6)
    assert dict(got["device_ops"]) == pytest.approx({"k1": 300e-6, "k2": 100e-6, "Memcpy HtoD": 100e-6})
    gaps = dict(got["idle_gaps"])
    assert gaps["portbench.call dog"] == pytest.approx(100e-6)  # 0..100
    assert gaps["aten::copy_"] == pytest.approx(250e-6)  # 350..600, the middle in the copy
    assert gaps["python, no torch op"] == pytest.approx(200e-6)  # 700..900
    assert tracing.reduce([_x("k", "kernel", 0, 1)]) is None


def test_open_loop_is_due_on_the_schedule_whatever_came_before():
    t0 = 100.0
    due = gen.due_times(t0, 30, 30, 30)
    assert due[0] == pytest.approx(t0 + 1.0) and np.diff(due) == pytest.approx(np.full(29, 1 / 30))


class _Stall:
    """A species whose first frame stalls the card for ``stall`` s."""

    def __init__(self, stall):
        self.device = torch.device("cpu")
        self.stall, self.calls = stall, 0

    def transform(self, shape, dtype):
        def program(x):
            self.calls += 1
            if self.calls == 1:
                time.sleep(self.stall)
            return x, x.clone()
        return program

    def visualize_batch_device(self, x):
        return self.transform(x.shape[1:], x.dtype)(x)


def test_open_loop_times_each_frame_from_its_due_time():
    stall = 0.2
    config = {"species": ["dog"]}
    cell = harness.Cell("t", 1, config, {"entry": "StreamingExecutor", "batch": 1, "split": False, "height": 8,
                                         "width": 8, "pool_frames": 2, "rate_hz": 30, "check_frames": 0}, [])
    driver = harness.StreamDriver(cell, {"dog": _Stall(stall)}, 1, "cpu")
    r = harness.Reading()
    driver.window(0.5, r, False)
    assert r.attempted == r.frames == 15 and r.failed == 0
    lat, period = r.latencies_ms, 1e3 / 30
    assert r.period_ms == pytest.approx(period)
    # frame 0 leaves when the stall ends, with no wait for a later frame to be
    # due; the frames due during the stall are late by what is left of it
    for k in range(6):
        left = 1e3 * stall - k * period
        assert left <= lat[k] < left + period, (k, lat)
    # once the backlog is read, a frame reads its own path, well under a period
    assert sorted(lat[8:])[3] < period / 4 and max(lat[8:]) < period, lat
