"""The species fleet (``parallel/fleet.py``) against the JAX package's, on
the CPU: the round-robin placement by index, and ``render_fleet`` of the
dog, pig, rat and lion on a 48x64 frame, bit-equal to the port's
``visualize`` and within 1 LSB of the JAX ``render_fleet`` (README's uint8
bar). No process group: the fleet is one process."""

import jax
import numpy as np
import pytest
import torch

from animal_vision_tpu.parallel import fleet as jfleet
from animal_vision_tpu_torch.parallel import fleet
from animal_vision_tpu_torch.species import get_animal

NAMES = ["dog", "pig", "rat", "lion"]


@pytest.mark.parametrize("n_devices", [1, 3, 8])
def test_assign_devices_is_the_jax_round_robin(n_devices):
    names = NAMES + ["cat", "deer", "kestrel"]
    jdevs = jax.devices()[:n_devices]
    ours = [torch.device("cuda", i) for i in range(n_devices)]  # device objects only: nothing runs there
    want = {k: jdevs.index(v) for k, v in jfleet.assign_devices(names, jdevs).items()}
    got = fleet.assign_devices(names, ours)
    assert {k: i % n_devices for k, i in want.items()} == want
    assert all(got[k] == ours[want[k]] for k in names)
    assert list(got) == names


def test_render_fleet_equals_visualize_and_jax():
    frame = np.random.default_rng(0).integers(0, 255, (48, 64, 3), dtype=np.uint8)
    outs = fleet.render_fleet(frame, NAMES, ["cpu"])
    jouts = jfleet.render_fleet(frame, NAMES)
    assert list(outs) == NAMES
    for name in NAMES:
        base, out = outs[name]
        want_base, want = get_animal(name, "cpu").visualize(frame)
        assert out.dtype == np.uint8 and out.shape == frame.shape
        assert np.array_equal(out, want) and np.array_equal(base, want_base)
        jbase, jout = jouts[name]
        assert np.abs(out.astype(int) - np.asarray(jout).astype(int)).max() <= 1, name
        assert np.abs(base.astype(int) - np.asarray(jbase).astype(int)).max() <= 1, name


def test_render_fleet_rejects_a_batch_and_needs_a_card_by_default(monkeypatch):
    with pytest.raises(ValueError, match="one \\(H, W, 3\\) frame"):
        fleet.render_fleet(np.zeros((2, 8, 8, 3), np.uint8), NAMES, ["cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fleet.render_fleet(np.zeros((8, 8, 3), np.uint8), NAMES)
