"""The port's degradation ladder on the CPU: the four cases of the JAX
package's ``tests/test_degrade.py`` (the pixel budget, an OOM from the
exact path, an exhausted ladder, other errors propagating), the ladder
equal to its explicit composition (area down, ``visualize``, linear up)
bit for bit, within 1 LSB of the JAX package's ladder, the host resize
without cv2 within 1 LSB of cv2's, and the OOM errors of PyTorch and CUDA
each taking the ladder with the failed shape's programs dropped."""

import sys

import numpy as np
import pytest
import torch

from animal_vision_tpu.species import get_animal as jax_animal
from animal_vision_tpu_torch.species import base, get_animal
from animal_vision_tpu_torch.species.nonuv import NONUV_SPECS, Cat, NonUVAnimal
from animal_vision_tpu_torch.species.uv.kestrel import Kestrel
from animal_vision_tpu_torch.species.uv.rat_uv import RatUV

FRESH = {
    "dog": lambda: NonUVAnimal(NONUV_SPECS["dog"], "cpu"),
    "cat": lambda: Cat("cpu"),
    "horse": lambda: NonUVAnimal(NONUV_SPECS["horse"], "cpu"),
    "rat_uv": lambda: RatUV("cpu"),
    "kestrel": lambda: Kestrel("cpu"),
}
OOMS = [
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 1.29 GiB"),
    RuntimeError("CUDA error: out of memory"),
    RuntimeError("av_blur_uv: CUDA error 2: out of memory"),
    RuntimeError("RESOURCE_EXHAUSTED: Out of memory in HBM"),
]


def _img(h, w, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _lsb(a, b):
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def _shapes(animal):
    return {k[0] for k in animal._programs}


def _composition(animal, image, side):
    h, w = image.shape[:2]
    sh, sw = base.rung_shape(h, w, side)
    b, o = animal.visualize(base.host_resize(image, sh, sw, "area"))
    return base.host_resize(b, h, w, "linear"), base.host_resize(o, h, w, "linear")


def test_pixel_budget_takes_ladder(monkeypatch, psnr_fn):
    """An absurd aspect ratio over the budget runs at a rung, at full size,
    and builds no full-size program; it approximates the exact result."""
    monkeypatch.setenv("ANIMAL_VISION_MAX_PIXELS", "200000")
    animal = FRESH["dog"]()
    img = _img(300, 4000)
    before = base.RUNGS[1024]
    b, out = animal.visualize(img)
    assert base.RUNGS[1024] == before + 1
    assert out.shape == img.shape and out.dtype == np.uint8 and b.shape == img.shape
    assert _shapes(animal) == {(77, 1024, 3)}
    monkeypatch.delenv("ANIMAL_VISION_MAX_PIXELS")
    _, ref = FRESH["dog"]().visualize(img)
    assert psnr_fn(out / 255.0, ref / 255.0) > 20.0


@pytest.mark.parametrize("err", range(len(OOMS)))
def test_oom_exception_takes_ladder(monkeypatch, err):
    animal = get_animal("horse", device="cpu")
    orig = animal._visualize_exact

    def flaky(image):
        if image.shape[0] * image.shape[1] > 300_000:
            raise OOMS[err]
        return orig(image)

    monkeypatch.setattr(animal, "_visualize_exact", flaky)
    img = _img(900, 1700, seed=5)
    before = base.RUNGS[512]
    b, out = animal.visualize(img)  # rungs 1024 (542x1024) and 768 (407x768) fail too
    assert base.RUNGS[512] == before + 1
    assert out.shape == img.shape and out.dtype == np.uint8 and b.shape == img.shape
    np.testing.assert_array_equal(out, _composition(animal, img, 512)[1])


def test_exhausted_ladder_raises(monkeypatch):
    monkeypatch.setenv("ANIMAL_VISION_MAX_PIXELS", "100")
    with pytest.raises(MemoryError):
        get_animal("dog", device="cpu").visualize(_img(2000, 3000))


def test_oom_at_every_rung_raises(monkeypatch):
    animal = FRESH["dog"]()

    def oom(image):
        raise torch.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(animal, "_visualize_exact", oom)
    with pytest.raises(MemoryError):
        animal.visualize(_img(600, 1300))


@pytest.mark.parametrize("exc", [ValueError("not an oom"), RuntimeError("CUDA error: an illegal memory access")])
def test_non_oom_errors_propagate(monkeypatch, exc):
    animal = get_animal("dog", device="cpu")

    def broken(image):
        raise exc

    monkeypatch.setattr(animal, "_visualize_exact", broken)
    with pytest.raises(type(exc), match=str(exc)):
        animal.visualize(_img(64, 96))
    assert not base.is_oom(exc)


@pytest.mark.parametrize("name", ["dog", "cat", "rat_uv", "kestrel"])
def test_ladder_equals_composition(monkeypatch, name):
    """Budget 100000 on 600x1300: rungs 1024, 768 and 512 are over it, 384
    (177x384) is taken. Bit-equal to the composition; the batch entry
    points do not degrade."""
    monkeypatch.setenv("ANIMAL_VISION_MAX_PIXELS", "100000")
    animal = FRESH[name]()
    img = _img(600, 1300, seed=7)
    before = dict(base.RUNGS)
    got = animal.visualize(img)
    assert {s: base.RUNGS[s] - before[s] for s in base.RUNGS} == {1024: 0, 768: 0, 512: 0, 384: 1, 256: 0}
    assert _shapes(animal) == {(177, 384, 3)}
    monkeypatch.delenv("ANIMAL_VISION_MAX_PIXELS")
    want = _composition(FRESH[name](), img, 384)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    monkeypatch.setenv("ANIMAL_VISION_MAX_PIXELS", "100000")
    _, out_b = animal.visualize_batch(img[None, :120, :160])
    assert (120, 160, 3) in _shapes(animal) and out_b.shape == (1, 120, 160, 3)


@pytest.mark.parametrize("name", ["dog", "cat", "horse"])
def test_ladder_vs_jax(monkeypatch, name):
    """Budget 30000 on 200x1300: rung 384 (59x384). The rung keeps the
    frame under 65 rows: the JAX cat on the CPU is up to 196 LSB from
    ``oracles.cat_pipeline`` on uint8 frames taller than 64 rows, where
    the port's cat is within 1 LSB of the oracle."""
    monkeypatch.setenv("ANIMAL_VISION_MAX_PIXELS", "30000")
    img = _img(200, 1300, seed=8)
    before = base.RUNGS[384]
    got = FRESH[name]().visualize(img)
    assert base.RUNGS[384] == before + 1
    want = jax_animal(name).visualize(img)
    assert _lsb(got[1], want[1]) <= 1 and _lsb(got[0], want[0]) <= 1


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_host_resize_without_cv2(monkeypatch, dtype):
    img = _img(97, 203, seed=9)
    img = img if dtype == np.uint8 else img.astype(np.float32) / np.float32(255)
    cases = [((41, 88), "area"), ((97, 203), "area"), ((180, 400), "linear"), ((31, 64), "linear")]
    with_cv2 = [base.host_resize(img, h, w, interp) for (h, w), interp in cases]
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises ImportError
    for ((h, w), interp), want in zip(cases, with_cv2):
        got = base.host_resize(img, h, w, interp)
        assert got.shape == (h, w, 3) and got.dtype == img.dtype
        if dtype == np.uint8:
            assert _lsb(got, want) <= 1
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("err", range(2))
def test_oom_drops_the_failed_program(monkeypatch, err):
    """An OOM raised while the full-size program runs: the ladder is taken,
    that program leaves the cache, the rung's stays."""
    animal = FRESH["dog"]()
    build = animal._build_program

    def building(shape, dtype, kernels):
        prog = build(shape, dtype, kernels)
        if shape[0] * shape[1] <= 600_000:
            return prog

        def failing(frames):
            raise OOMS[err]

        return failing

    monkeypatch.setattr(animal, "_build_program", building)
    img = _img(600, 1300, seed=10)
    before = base.RUNGS[1024]
    _, out = animal.visualize(img)
    assert base.RUNGS[1024] == before + 1
    assert _shapes(animal) == {(473, 1024, 3)}
    np.testing.assert_array_equal(out, _composition(FRESH["dog"](), img, 1024)[1])
