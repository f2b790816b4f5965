"""Checks shared by the port's UV species test files: each species of the
port (``get_animal(name, device="cpu")``) against the JAX package's
``get_animal(name)`` and the NumPy/cv2 oracle ``oracles_uv.<name>_pipeline``,
on the CPU.

Bars: >= 40 dB PSNR on the uint8 output (the repo's UV contract) with the
baseline within 1 LSB; float frames within 1e-4; a batch equal to its
frames bit for bit; the plain program equal to the kernel program on the
CPU (both take the plain blur there)."""

import numpy as np
import pytest
import torch

import oracles_uv
from animal_vision_tpu.species import get_animal as jax_animal
from animal_vision_tpu_torch.species import get_animal

MIN_DB = 40.0
#: (H, W) of the random frames beside the 64x96 ``img_u8`` fixture
ODD_SHAPES = [(50, 70), (9, 13)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for a file's CPU chains: the test workers share
    the machine's cores. Imported by each species test file."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lsb(a, b):
    return int(np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max())


def check(got, want, psnr_fn, what):
    (base_t, out_t), (base_w, out_w) = got, want
    assert out_t.dtype == np.uint8 and out_t.shape == np.asarray(out_w).shape
    db = psnr_fn(out_t / 255.0, np.asarray(out_w) / 255.0)
    assert db >= MIN_DB, f"{what}: {db:.2f} dB"
    assert _lsb(base_t, base_w) <= 1, what


def frame_of(shape, img_u8):
    """``img_u8`` for None, else a random uint8 frame of ``shape``."""
    if shape is None:
        return img_u8
    return np.random.default_rng(sum(shape)).integers(0, 256, size=(*shape, 3), dtype=np.uint8)


def vs_jax_and_oracle(name, frame, psnr_fn):
    got = get_animal(name, device="cpu").visualize(frame)
    check(got, jax_animal(name).visualize(frame), psnr_fn, f"{name} {frame.shape} vs JAX")
    check(got, getattr(oracles_uv, f"{name}_pipeline")(frame), psnr_fn, f"{name} {frame.shape} vs oracle")


def float_frames_vs_jax(name, img_f32):
    base_t, out_t = get_animal(name, device="cpu").visualize(img_f32)
    base_j, out_j = jax_animal(name).visualize(img_f32)
    assert out_t.dtype == np.float32 and base_t.dtype == np.float32
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(base_t, base_j, rtol=0, atol=1e-4)


def batch_equals_frames(name, dtype, img_u8):
    """Three frames; as float32, the second has max <= 1, so to_float01
    divides the other two by 255 and leaves it as it is."""
    if dtype == "uint8":
        frames = [img_u8, (img_u8 > 127).astype(np.uint8), img_u8[::-1]]
    else:
        frames = [img_u8.astype(np.float32), img_u8[::-1] / np.float32(255), (img_u8 > 127) * np.float32(200)]
    batch = np.stack(frames)
    animal = get_animal(name, device="cpu")
    base_b, out_b = animal.visualize_batch(batch)
    for i in range(3):
        base_i, out_i = animal.visualize(batch[i])
        np.testing.assert_array_equal(out_b[i], out_i)
        np.testing.assert_array_equal(base_b[i], base_i)
    dev_base, dev_out = animal.visualize_batch_device(torch.from_numpy(batch))
    np.testing.assert_array_equal(dev_out.numpy(), out_b)
    np.testing.assert_array_equal(np.asarray(dev_base), base_b)


def plain_transform_matches_kernel_path(name, img_u8):
    animal = get_animal(name, device="cpu")
    frame = torch.from_numpy(img_u8)
    for got, want in zip(animal.transform(img_u8.shape)(frame), animal.plain_transform(img_u8.shape)(frame)):
        assert torch.equal(got, want)
