"""Serving adapters: bytes or a data URL in, a data URI out.

Counterpart of ``animal_vision_tpu/service.py``: decode and encode in
memory (cv2, imported where used). Every function takes ``device``: None
means the CUDA card, and without one it raises (``species.resolve_device``);
pass ``device="cpu"`` for the plain PyTorch path.

Channel order: the reference's server feeds **BGR** frames into visualize;
``assume_bgr=True`` reproduces that, False converts to RGB and back.
"""

from __future__ import annotations

import base64

import numpy as np

from animal_vision_tpu_torch.io.renderer import compose_split, require_cv2
from animal_vision_tpu_torch.species import animal_names, display_name, get_animal

_ALIASES = {"ratuv": "rat_uv", "mantisshrimp": "mantis_shrimp", "jumpingspider": "jumping_spider"}


def _decode_image(data: bytes, assume_bgr: bool) -> np.ndarray:
    """Image bytes -> a BGR frame (as the reference server feeds it), or RGB
    unless ``assume_bgr``."""
    cv2 = require_cv2()
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ValueError("could not decode image bytes")
    return img if assume_bgr else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _payload(image_data_url: str) -> bytes:
    return base64.b64decode(image_data_url.split(",", 1)[1] if "," in image_data_url else image_data_url)


def _encode_data_uri(img: np.ndarray, fmt: str, assume_bgr: bool) -> str:
    cv2 = require_cv2()
    if not assume_bgr:
        img = cv2.cvtColor(img, cv2.COLOR_RGB2BGR)
    ok, buf = cv2.imencode(fmt, img)
    if not ok:
        raise ValueError(f"could not encode a {img.shape} frame as {fmt}")
    mime = "image/jpeg" if fmt == ".jpg" else "image/png"
    return f"data:{mime};base64," + base64.b64encode(buf.tobytes()).decode()


def resolve_animal(name: str, device=None):
    """The animal of a display name or slug, aliases included, on ``device``."""
    key = name.lower().replace(" ", "_").replace("-", "_")
    key = _ALIASES.get(key, key)
    if key not in animal_names():
        raise KeyError(f"unknown animal {name!r}")
    return get_animal(key, device)


def processimage(imagedata: bytes, animal: str, assume_bgr: bool = True, device=None) -> str:
    """Raw image bytes -> the transformed frame as a JPEG data URI."""
    _, out = resolve_animal(animal, device).visualize(_decode_image(imagedata, assume_bgr))
    return _encode_data_uri(out, ".jpg", assume_bgr)


def processsplitimage(image_data_url: str, animal: str, assume_bgr: bool = True, device=None) -> str:
    """Data URL -> the half/half split comparison frame as a PNG data URI."""
    baseline, out = resolve_animal(animal, device).visualize(_decode_image(_payload(image_data_url), assume_bgr))
    return _encode_data_uri(compose_split(baseline, out), ".png", assume_bgr)


def processframe(image_data_url: str, animal: str, assume_bgr: bool = True, device=None) -> str:
    """Data URL -> the full transformed frame as a JPEG data URI (the live
    video flow: one frame per request)."""
    return processimage(_payload(image_data_url), animal, assume_bgr=assume_bgr, device=device)


def animal_choices() -> list[dict]:
    """Menu entries: display name and slug."""
    return [{"name": display_name(n), "value": n} for n in animal_names()]


def species_categories() -> dict[str, list[str]]:
    """Category -> species slugs, the gallery groupings."""
    from animal_vision_tpu_torch.species import NON_UV_NAMES, UNIQUE_UV_NAMES, UV_NAMES

    return {"nonuv": NON_UV_NAMES, "uv": UV_NAMES, "unique_uv": UNIQUE_UV_NAMES}


def processgallery(
    image_data_url: str,
    category: str = "nonuv",
    animals: list[str] | None = None,
    assume_bgr: bool = True,
    device=None,
) -> str:
    """Data URL -> the labeled species grid of one category as a PNG data
    URI; ``animals`` overrides the category's species. A species that fails
    is left out of the grid, as the CLI's gallery does; the device is
    resolved first, so a missing card raises."""
    from animal_vision_tpu_torch.io.gallery import build_labeled_grid
    from animal_vision_tpu_torch.species import resolve_device

    resolve_device(device)
    names = animals if animals else species_categories()[category]
    frame = _decode_image(_payload(image_data_url), assume_bgr)
    tiles, labels = [], []
    for name in names:
        try:
            _, out = resolve_animal(name, device).visualize(frame)
        except Exception:  # noqa: BLE001  (the gallery skips a failing species)
            continue
        tiles.append(out)
        labels.append(display_name(name))
    if not tiles:
        raise ValueError(f"no species of category {category!r} succeeded")
    return _encode_data_uri(build_labeled_grid(tiles, labels), ".png", assume_bgr)
