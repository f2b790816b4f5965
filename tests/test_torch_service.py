"""The port's serving adapters (``animal_vision_tpu_torch/service.py``) on
the CPU against the JAX package's: PNG outputs (split image, gallery)
within 1 LSB of JAX's once decoded, JPEG outputs (image, frame) >= 40 dB
from them, the same name resolution, and an error without a card unless
``device="cpu"``."""

import base64

import cv2
import jax  # noqa: F401  (JAX on the CPU backend, as tests/conftest.py sets it)
import numpy as np
import pytest
import torch

from animal_vision_tpu import service as jservice
from animal_vision_tpu_torch import service


def _decode(uri: str, mime: str) -> np.ndarray:
    head, payload = uri.split(",", 1)
    assert head == f"data:{mime};base64"
    img = cv2.imdecode(np.frombuffer(base64.b64decode(payload), np.uint8), cv2.IMREAD_COLOR)
    assert img is not None
    return img


def _url(img_rgb, fmt=".png"):
    ok, buf = cv2.imencode(fmt, cv2.cvtColor(img_rgb, cv2.COLOR_RGB2BGR))
    assert ok
    mime = "image/png" if fmt == ".png" else "image/jpeg"
    return f"data:{mime};base64," + base64.b64encode(buf.tobytes()).decode()


def _lsb(a, b):
    return int(np.abs(a.astype(int) - b.astype(int)).max())


@pytest.mark.parametrize("assume_bgr", [True, False])
@pytest.mark.parametrize("animal", ["Dog", "cat", "GoldFish"])
def test_processsplitimage_vs_jax(img_u8, animal, assume_bgr, psnr_fn):
    url = _url(img_u8)
    got = _decode(service.processsplitimage(url, animal, assume_bgr, device="cpu"), "image/png")
    want = _decode(jservice.processsplitimage(url, animal, assume_bgr), "image/png")
    assert got.shape == want.shape == img_u8.shape
    if animal == "GoldFish":  # a UV species: held in PSNR
        assert psnr_fn(got / 255.0, want / 255.0) >= 40.0
    else:
        assert _lsb(got, want) <= 1


def test_processgallery_vs_jax(img_u8):
    url = _url(img_u8)
    animals = ["dog", "pig", "cat"]
    got = _decode(service.processgallery(url, animals=animals, device="cpu"), "image/png")
    want = _decode(jservice.processgallery(url, animals=animals), "image/png")
    assert got.shape == want.shape and got.shape[0] > img_u8.shape[0]
    assert _lsb(got, want) <= 1


@pytest.mark.parametrize("animal", ["dog", "rat"])
def test_processimage_and_processframe_vs_jax(img_u8, animal, psnr_fn):
    ok, buf = cv2.imencode(".jpg", cv2.cvtColor(img_u8, cv2.COLOR_RGB2BGR))
    got = _decode(service.processimage(buf.tobytes(), animal, device="cpu"), "image/jpeg")
    want = _decode(jservice.processimage(buf.tobytes(), animal), "image/jpeg")
    assert got.shape == img_u8.shape
    assert psnr_fn(got / 255.0, want / 255.0) >= 40.0
    url = _url(img_u8, ".jpg")
    got = _decode(service.processframe(url, animal, assume_bgr=False, device="cpu"), "image/jpeg")
    want = _decode(jservice.processframe(url, animal, assume_bgr=False), "image/jpeg")
    assert psnr_fn(got / 255.0, want / 255.0) >= 40.0


@pytest.mark.parametrize("name,slug", [("Dog", "dog"), ("RatUV", "rat_uv"), ("mantis shrimp", "mantis_shrimp"),
                                       ("Mantis-Shrimp", "mantis_shrimp"), ("JumpingSpider", "jumping_spider")])
def test_resolve_animal_aliases(name, slug):
    from animal_vision_tpu.species import get_animal as jax_animal
    from animal_vision_tpu_torch.species import get_animal

    assert jservice.resolve_animal(name) is jax_animal(slug)
    assert service.resolve_animal(name, device="cpu") is get_animal(slug, device="cpu")


@pytest.mark.parametrize("name", ["unicorn", "", "dog cat"])
def test_resolve_animal_unknown(name):
    with pytest.raises(KeyError):
        jservice.resolve_animal(name)
    with pytest.raises(KeyError):
        service.resolve_animal(name, device="cpu")


def test_choices_and_categories_equal_jax():
    assert service.animal_choices() == jservice.animal_choices()
    assert service.species_categories() == jservice.species_categories()


def test_default_device_without_card_raises(img_u8, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    url = _url(img_u8)
    ok, buf = cv2.imencode(".jpg", img_u8)
    for call in (lambda: service.processimage(buf.tobytes(), "dog"),
                 lambda: service.processsplitimage(url, "dog"),
                 lambda: service.processframe(url, "dog"),
                 lambda: service.processgallery(url, animals=["dog"]),
                 lambda: service.resolve_animal("dog")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_undecodable_bytes_raise():
    with pytest.raises(ValueError, match="decode"):
        service.processimage(b"not an image", "dog", device="cpu")
