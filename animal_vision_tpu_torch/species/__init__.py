"""Species registry: slug -> Animal, one cached instance per (slug, device).

Counterpart of ``animal_vision_tpu/species/__init__.py`` for the 20 non-UV
species and the UV species ported so far (``PORTED_UV_NAMES``). Entry
points run on the CUDA card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

from typing import Callable

import torch

from animal_vision_tpu_torch.species.base import Animal
from animal_vision_tpu_torch.species.nonuv import NONUV_SPECS, Cat, NonUVAnimal
from animal_vision_tpu_torch.species.uv.goldfish import Goldfish
from animal_vision_tpu_torch.species.uv.honeybee import HoneyBee
from animal_vision_tpu_torch.species.uv.kestrel import Kestrel
from animal_vision_tpu_torch.species.uv.reindeer import Reindeer

_FACTORIES: dict[str, Callable[[torch.device], Animal]] = {}
_DISPLAY: dict[str, str] = {}
_CACHE: dict[tuple[str, str], Animal] = {}


def register(name: str, display: str, factory: Callable[[torch.device], Animal]) -> None:
    """Register ``factory(device) -> Animal`` under the slug ``name``."""
    _FACTORIES[name] = factory
    _DISPLAY[name] = display


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the CUDA card; without one that is an error, never a
    silent move to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def get_animal(name: str, device: str | torch.device | None = None) -> Animal:
    """Look up (and cache) an animal by slug (case-insensitive) on ``device``."""
    key = name.lower().replace(" ", "_")
    if key not in _FACTORIES:
        raise KeyError(f"unknown animal {name!r}; known: {sorted(_FACTORIES)}")
    dev = resolve_device(device)
    cache_key = (key, str(dev))
    if cache_key not in _CACHE:
        _CACHE[cache_key] = _FACTORIES[key](dev)
    return _CACHE[cache_key]


def animal_names() -> list[str]:
    return sorted(_FACTORIES)


def display_name(name: str) -> str:
    return _DISPLAY.get(name, name)


register("cat", "Cat", Cat)
for _slug, _spec in NONUV_SPECS.items():
    register(_slug, _slug.capitalize(), (lambda dev, s=_spec: NonUVAnimal(s, dev)))

NON_UV_NAMES = ["cat"] + sorted(NONUV_SPECS)

register("honeybee", "HoneyBee", HoneyBee)
register("reindeer", "ReinDeer", Reindeer)
register("goldfish", "GoldFish", Goldfish)
register("kestrel", "Kestrel", Kestrel)

# The JAX package's gallery groupings, in its order, listing only the UV
# species ported so far.
UV_NAMES = ["honeybee", "reindeer", "goldfish"]
UNIQUE_UV_NAMES = ["kestrel"]
PORTED_UV_NAMES = UV_NAMES + UNIQUE_UV_NAMES
