"""The port's timing and profiling utilities on the CPU: ``stage_timer``
totals and counts (booked by spans, also from several threads), ``sync``
on the CPU, and the device timers' refusal of a CPU device."""

import threading
import time

import pytest
import torch

from animal_vision_tpu_torch.utils.profiling import span, stage_timer, sync
from animal_vision_tpu_torch.utils.timing import time_chained, time_ms


def test_stage_timer_totals_and_counts():
    t = stage_timer()
    for _ in range(3):
        with span("a", into=t):
            time.sleep(0.002)
    with span("executor.sink", into=t, stage="b"):
        pass
    t.add("c", 0.5)
    t.add("c", 0.25)
    assert dict(t.counts) == {"a": 3, "b": 1, "c": 2}
    assert t.totals["a"] >= 0.006 and t.totals["c"] == 0.75


def test_stage_timer_from_threads():
    t = stage_timer()

    def work():
        for _ in range(2000):
            t.add("x", 1.0)

    threads = [threading.Thread(target=work) for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert t.counts["x"] == 16000 and t.totals["x"] == 16000.0


def test_sync_on_cpu_is_a_noop():
    sync("cpu")
    sync(torch.device("cpu"))
    sync(torch.ones(3))


def test_device_timers_refuse_the_cpu():
    with pytest.raises(ValueError, match="CUDA device"):
        time_ms(lambda: None, 3, "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        time_chained(lambda x: x, torch.zeros(2, 3), 2)
