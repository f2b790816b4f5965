"""The port's UV species: the butterflies (morpho, heliconius, pieris) against the JAX package and the
NumPy/cv2 oracles, on the CPU (the checks and bars of
``tests/torch_uv_checks.py``), at the 64x96 ``img_u8`` and two odd
shapes."""

import jax  # noqa: F401  (JAX on the CPU backend, as tests/conftest.py sets it)
import numpy as np
import pytest

import torch_uv_checks as checks
from animal_vision_tpu.species.uv.morpho import Morpho as JMorpho
from animal_vision_tpu_torch import species
from animal_vision_tpu_torch.species import get_animal
from torch_uv_checks import one_torch_thread  # noqa: F401  (the module-wide fixture)

NAMES = ["morpho", "heliconius", "pieris"]


@pytest.mark.parametrize("shape", [None] + checks.ODD_SHAPES)
@pytest.mark.parametrize("name", NAMES)
def test_vs_jax_and_oracle(name, shape, img_u8, psnr_fn):
    checks.vs_jax_and_oracle(name, checks.frame_of(shape, img_u8), psnr_fn)


@pytest.mark.parametrize("name", NAMES)
def test_float_frames_vs_jax(name, img_f32):
    checks.float_frames_vs_jax(name, img_f32)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("name", NAMES)
def test_visualize_batch_equals_frames(name, dtype, img_u8):
    checks.batch_equals_frames(name, dtype, img_u8)


@pytest.mark.parametrize("name", NAMES)
def test_plain_transform_matches_kernel_path(name, img_u8):
    checks.plain_transform_matches_kernel_path(name, img_u8)


def test_morpho_gate_from_the_environment(monkeypatch, img_u8, psnr_fn):
    """``ANIMAL_VISION_MORPHO_GATE`` sets ``orientation_gate`` on the
    registry's morpho; gated, it matches the gated JAX morpho on a textured
    frame and on a flat frame with faint noise (where the ungated
    orientation is the arctangent of noise)."""
    monkeypatch.setenv("ANIMAL_VISION_MORPHO_GATE", "1e-2")
    monkeypatch.setattr(species, "_CACHE", {})
    animal = get_animal("morpho", device="cpu")
    assert animal.orientation_gate == 1e-2
    reference = JMorpho()
    reference.orientation_gate = 1e-2
    rng = np.random.default_rng(0)
    flat = np.clip(0.5 + rng.normal(0, 2e-4, (48, 64, 3)), 0, 1).astype(np.float32)
    checks.check(animal.visualize(img_u8), reference.visualize(img_u8), psnr_fn, "gated morpho")
    base_t, out_t = animal.visualize(flat)
    base_j, out_j = reference.visualize(flat)
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-4)
    monkeypatch.delenv("ANIMAL_VISION_MORPHO_GATE")
    monkeypatch.setattr(species, "_CACHE", {})
    assert get_animal("morpho", device="cpu").orientation_gate is None
