"""The UV blur's plain version (what ``blur_uv`` runs on the CPU, and what
the CUDA kernel is held against on the card) against the JAX package.

- against the Pallas ``fused_gaussian_blur`` (interpret mode on the CPU)
  and the XLA ``core.blur.gaussian_blur_uv``: <= 1e-5 on [0, 1] data;
- frames narrower or shorter than the kernel, down to 1x1, against the
  XLA path: <= 1e-5;
- a batch equals its frames, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal_vision_tpu.core import blur as jblur
from animal_vision_tpu.ops.fused_blur import fused_gaussian_blur
from animal_vision_tpu_torch.core import blur as tblur
from animal_vision_tpu_torch.ops import _build
from animal_vision_tpu_torch.ops import fused_blur as F

TOL = 1e-5
SIGMAS = [0.2, 0.8, 1.8, 3.0]


def _data(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _port(x: np.ndarray, sigma: float) -> np.ndarray:
    """The port's UV blur of an (H, W) map or (H, W, C) image."""
    t = torch.from_numpy(x[..., None] if x.ndim == 2 else x)
    out = tblur.gaussian_blur_uv(t, sigma).numpy()
    return out[..., 0] if x.ndim == 2 else out


@pytest.mark.parametrize("sigma", SIGMAS)
@pytest.mark.parametrize("shape", [(40, 50, 3), (64, 96), (37, 129, 3), (37, 129)])
def test_plain_vs_pallas_and_xla(shape, sigma):
    x = _data(shape, seed=len(shape))
    got = _port(x, sigma)
    pallas = np.asarray(fused_gaussian_blur(jnp.asarray(x), sigma, ksize=jblur.uv_ksize(sigma)))
    xla = np.asarray(jblur.gaussian_blur_uv(jnp.asarray(x), sigma))
    assert got.shape == x.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, pallas, rtol=0, atol=TOL)
    np.testing.assert_allclose(got, xla, rtol=0, atol=TOL)


@pytest.mark.parametrize("sigma", [1.2, 3.0])
@pytest.mark.parametrize("shape", [(1, 1), (1, 40), (40, 1), (5, 3), (7, 2, 3), (2, 17, 3)])
def test_narrow_frames_vs_xla(shape, sigma):
    """Borders that wrap more than once (W or H below the kernel's radius)."""
    x = _data(shape, seed=7)
    got = _port(x, sigma)
    want = np.asarray(jblur.gaussian_blur_uv(jnp.asarray(x), sigma))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("channels", [1, 3])
def test_batch_equals_frames(channels):
    x = torch.from_numpy(_data((3, 33, 45, channels), seed=3))
    taps = tblur.uv_taps(1.8, "cpu")
    batch = F.blur_uv(x, taps)
    for i in range(3):
        assert torch.equal(batch[i], F.blur_uv(x[i : i + 1], taps)[0])


def test_cpu_wrapper_takes_the_plain_version():
    x = torch.from_numpy(_data((2, 9, 11, 3)))
    taps = tblur.uv_taps(0.8, "cpu")
    before = _build.LAUNCHES["blur_uv"]
    assert torch.equal(F.blur_uv(x, taps), F.blur_uv_plain(x, taps))
    assert _build.LAUNCHES["blur_uv"] == before  # no kernel launch on the CPU


def test_sigma_zero_is_identity():
    x = torch.from_numpy(_data((6, 7, 3)))
    assert tblur.gaussian_blur_uv(x, 0.0) is x


@pytest.mark.parametrize("sigma", [0.2, 0.7, 1.0, 1.2, 3.0, 6.0])
def test_uv_ksize_and_taps_match_jax(sigma):
    k = tblur.uv_ksize(sigma)
    assert k == jblur.uv_ksize(sigma)
    np.testing.assert_array_equal(tblur.uv_taps(sigma, "cpu").numpy(), jblur.gaussian_kernel_1d(k, sigma))


@pytest.mark.parametrize("channels", [1, 3, 8])
def test_tile_rows_fit_and_raise(channels):
    """The H100 allows 232448 bytes per block: the streaming block fits at
    every ksize of 3..37 with 1, 3 or 8 channels (about 49 KB at C = 3,
    k = 19), and kernels far wider raise naming their ksize."""
    limit = 232448
    for k in range(3, 39, 2):
        assert F.block_smem(k, channels, limit) == F.smem_bytes(k, channels) <= limit
    assert F.smem_bytes(19, 3) == 49856
    far = {1: 801, 3: 301, 8: 121}[channels]
    with pytest.raises(ValueError, match=f"ksize {far}"):
        F.block_smem(far, channels, limit)


def test_run_rows():
    """Runs of 128 rows for a 1080p batch of 3 channels; shorter ones keep
    16 warps per SM on fewer channels and smaller frames, down to 16 rows."""
    assert F.run_rows(3, 1080, 1920, 3) == F.run_rows(4, 1080, 1920, 3) == 128
    assert F.run_rows(3, 1080, 1920, 1) == 64 and F.run_rows(1, 1080, 1920, 3) == 64
    assert F.run_rows(4, 272, 480, 3) == F.run_rows(1, 64, 96, 1) == 16
    assert all(r % F.GROUP == 0 for r in F.RUN_ROWS)


def test_rejects_bad_operands():
    x = torch.zeros(1, 4, 4, 3)
    taps = tblur.uv_taps(0.8, "cpu")
    with pytest.raises(ValueError):
        F.blur_uv(torch.zeros(1, 4, 4, 9), taps)  # more than 8 channels
    with pytest.raises(ValueError):
        F.blur_uv(x[0], taps)  # not (N, H, W, C)
    with pytest.raises(TypeError):
        F.blur_uv(x.double(), taps)
    with pytest.raises(ValueError):
        F.blur_uv(x, taps[:-1])  # even tap count
