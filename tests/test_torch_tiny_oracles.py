"""The port's non-UV species on frames smaller than their blurs, against the
framework-free oracles of ``tests/oracles.py`` (every reflect-101 border
wraps more than once): the 19 spec species against ``nonuv_pipeline`` and
the cat's two outputs against ``cat_pipeline``, within 1 uint8 LSB. The JAX
package is not involved: its ``_iso_kernel`` raises at such sizes on the
CPU backend."""

import numpy as np
import pytest

import oracles
from animal_vision_tpu_torch.species import get_animal
from animal_vision_tpu_torch.species.nonuv import NONUV_SPECS

SHAPES = [(1, 1), (2, 3), (5, 7), (5, 40), (13, 9)]


def _frame(shape):
    return np.random.default_rng(sum(shape) * 7 + shape[0]).integers(0, 256, size=(*shape, 3), dtype=np.uint8)


def _lsb(a, b):
    return int(np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", sorted(NONUV_SPECS))
def test_spec_species_tiny_vs_oracle(name, shape):
    spec = NONUV_SPECS[name]
    frame = _frame(shape)
    effects = [(e.kind, e.params) for e in spec.effects if e.enabled]
    base_ref, out_ref = oracles.nonuv_pipeline(frame, spec.alpha, spec.s_scale, effects)
    base, out = get_animal(name, device="cpu").visualize(frame)
    assert out.shape == frame.shape and out.dtype == np.uint8
    np.testing.assert_array_equal(base, base_ref)
    assert _lsb(out, out_ref) <= 1


@pytest.mark.parametrize("shape", SHAPES)
def test_cat_tiny_vs_oracle(shape):
    frame = _frame(shape)
    human_ref, cat_ref = oracles.cat_pipeline(frame)
    human, cat = get_animal("cat", device="cpu").visualize(frame)
    assert human.shape == cat.shape == frame.shape
    assert _lsb(human, human_ref) <= 1
    assert _lsb(cat, cat_ref) <= 1
