"""The port's non-UV species at odd and narrow frame shapes, against the JAX
package (which pads such frames into shape buckets or takes its XLA path;
the port runs every shape as it is), within 1 uint8 LSB."""

import jax  # noqa: F401  (JAX on the CPU backend, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch  # noqa: F401

from animal_vision_tpu.species import get_animal as jax_animal
from animal_vision_tpu_torch.species import get_animal


def _lsb(a, b):
    return int(np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max())


@pytest.mark.parametrize("shape", [(50, 50), (64, 85), (48, 100)])
@pytest.mark.parametrize("name", ["dog", "deer", "rabbit", "rat", "cat"])
def test_odd_shapes_vs_jax(name, shape):
    frame = np.random.default_rng(sum(shape)).integers(0, 256, size=(*shape, 3), dtype=np.uint8)
    base_j, out_j = jax_animal(name).visualize(frame)
    base_t, out_t = get_animal(name, device="cpu").visualize(frame)
    assert out_t.shape == frame.shape and base_t.shape == frame.shape
    assert _lsb(out_t, out_j) <= 1
    assert _lsb(base_t, base_j) <= 1


@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (5, 40)])
def test_tiny_frames_match_composition(shape):
    """Frames smaller than the blur kernels: every reflect-101 border wraps
    more than once; the fused path still equals the composed chain."""
    frame = np.random.default_rng(3).integers(0, 256, size=(*shape, 3), dtype=np.uint8)
    for name in ("dog", "deer", "panda", "pig", "cat"):
        animal = get_animal(name, device="cpu")
        x = torch.from_numpy(frame)
        _, fused = animal.transform(frame.shape)(x)
        _, plain = animal.plain_transform(frame.shape)(x)
        assert _lsb(fused, plain) <= 1, name
