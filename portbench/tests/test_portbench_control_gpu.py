"""The check's control on the card: the plain reference in the program's
place, its products in TF32, comes out not correct on three seeds, where
the port comes out correct. At 272x480 (the cells' own size is read by
``python -m portbench.control``), each window long enough for the control
to reach every sampled call: TF32 moves only the cat's dense products in
the non-UV device cell, so its sampled call has to be in the window."""

from __future__ import annotations

import pytest
import torch

from portbench import harness, standins

SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)
CELLS = {"nonuv20.device_1080p_b4": 8.0, "honeybee_mstpp.device_1080p_b4": 2.0, "nonuv20.webcam_720p_30fps": 2.0}


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_comes_out_not_correct(card, cell):
    for seed in SEEDS:
        port, _ = harness.run_cell(cell, seed, CELLS[cell], False, card, shape=(272, 480))
        ctl, lines = harness.run_cell(cell, seed, CELLS[cell], False, card, build=standins.control, shape=(272, 480))
        assert port["correct"] and not ctl["correct"], lines
