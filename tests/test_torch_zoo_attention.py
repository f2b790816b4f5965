"""The zoo's attention networks (Restormer, AWAN) in the port against the
JAX modules, on the CPU; see ``tests/torch_zoo_checks.py`` for the weights,
sizes and bars. AWAN's non-local tail runs each quadrant apart, so the odd
frame gives it quadrants of unequal sizes."""

import numpy as np
import pytest
import torch

from animal_vision_tpu_torch.models import awan
from torch_zoo_checks import (SHAPES, check_batch_equals_frames, check_round_trip, check_vs_jax, one_torch_thread,
                              seeded)

METHODS = ["restormer", "awan"]
_ = one_torch_thread


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("method", METHODS)
def test_forward_vs_jax(method, shape):
    check_vs_jax(method, shape)


@pytest.mark.parametrize("method", METHODS)
def test_from_jax_params_round_trip(method):
    check_round_trip(method)


@pytest.mark.parametrize("method", METHODS)
def test_batch_equals_frames(method):
    check_batch_equals_frames(method)


def test_awan_quadrants_run_apart():
    """Changing one quadrant's input changes no other quadrant's non-local
    output."""
    nl = awan.PSNL(31)
    torch.nn.init.normal_(nl.non_local.W.weight, std=0.3)
    x = torch.from_numpy(np.random.default_rng(3).random((1, 31, 10, 12), dtype=np.float32))
    y = x.clone()
    y[:, :, :5, :6] += 1.0
    with torch.no_grad():
        a, b = nl(x), nl(y)
    assert not torch.equal(a[:, :, :5, :6], b[:, :, :5, :6])
    assert torch.equal(a[:, :, 5:], b[:, :, 5:]) and torch.equal(a[:, :, :5, 6:], b[:, :, :5, 6:])
    assert seeded("awan").tail_nonlocal.non_local.theta.weight.shape == (3, 31, 1, 1)
