"""A run with the timed path broken underneath comes out not correct.

The harness runs as the benchmark runs it, without its look for a card,
on the CPU at a small frame size: the port comes out correct, and each
fault that the cell can have comes out not correct: half of a batch left
out (cells of more than one frame per batch), one answer altered where it
is produced."""

from __future__ import annotations

import pytest

from portbench import harness, standins
from portbench import traffic as gen

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")

#: a seed whose sample reaches into the first round of the device cells (a
#: call of honeybee and of some non-UV species), so that a slow CPU run
#: compares something and the half fault shows however few rounds it
#: completes
SEED = 2**31 + 79


def test_the_seed_samples_the_first_round():
    assert 0 in gen.sample(SEED, 100, 8, 2)
    assert any(gen.sample(SEED, 100 + i, 8, 1) == [0] for i in range(20))

CELLS = {
    "nonuv20.device_1080p_b4": ((24, 40), 0.3),
    "honeybee_mstpp.device_1080p_b4": ((16, 24), 0.3),
    "nonuv20.webcam_720p_30fps": ((24, 40), 1.0),
}
CASES = [(cell, fault) for cell in CELLS for fault in ("half", "alter")
         if not (fault == "half" and harness.resolve(cell, False, BENCH).traffic["batch"] == 1)]


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_comes_out_correct(cell):
    shape, seconds = CELLS[cell]
    result, lines = harness.run_cell(cell, SEED, seconds, False, "cpu", shape=shape, bench=BENCH)
    assert result["correct"], lines


@pytest.mark.parametrize("cell, fault", CASES)
def test_a_fault_comes_out_not_correct(cell, fault):
    shape, seconds = CELLS[cell]
    result, lines = harness.run_cell(cell, SEED, seconds, False, "cpu", build=standins.fault(fault), shape=shape,
                                     bench=BENCH)
    assert not result["correct"], lines
    assert any(line.startswith("check ") and line.endswith("FAILED") for line in lines), lines
    assert list(result)[-1] == "check" and lines[-1].startswith("check ")
