"""The port's UV species: the reef and stream fish (damselfish, anableps, anchovy, guppy) against the JAX package and the
NumPy/cv2 oracles, on the CPU (the checks and bars of
``tests/torch_uv_checks.py``), at the 64x96 ``img_u8`` and two odd
shapes."""

import jax  # noqa: F401  (JAX on the CPU backend, as tests/conftest.py sets it)
import pytest

import torch_uv_checks as checks
from torch_uv_checks import one_torch_thread  # noqa: F401  (the module-wide fixture)

NAMES = ["damselfish", "anableps", "anchovy", "guppy"]


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
