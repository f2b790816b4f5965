"""Species registry: slug -> Animal, one cached instance per (slug, device).

Counterpart of ``animal_vision_tpu/species/__init__.py`` for the 20 non-UV
species and the UV species ported so far (``PORTED_UV_NAMES``). Entry
points run on the CUDA card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os
from typing import Callable

import torch

from animal_vision_tpu_torch.species.base import Animal
from animal_vision_tpu_torch.species.nonuv import NONUV_SPECS, Cat, NonUVAnimal
from animal_vision_tpu_torch.species.uv.anableps import Anableps
from animal_vision_tpu_torch.species.uv.anchovy import Anchovy
from animal_vision_tpu_torch.species.uv.damselfish import Damselfish
from animal_vision_tpu_torch.species.uv.dragonfly import Dragonfly
from animal_vision_tpu_torch.species.uv.goldfish import Goldfish
from animal_vision_tpu_torch.species.uv.guppy import Guppy
from animal_vision_tpu_torch.species.uv.heliconius import Heliconius
from animal_vision_tpu_torch.species.uv.honeybee import HoneyBee
from animal_vision_tpu_torch.species.uv.hummingbird import Hummingbird
from animal_vision_tpu_torch.species.uv.jumping_spider import JumpingSpider
from animal_vision_tpu_torch.species.uv.kestrel import Kestrel
from animal_vision_tpu_torch.species.uv.mantis_shrimp import MantisShrimp
from animal_vision_tpu_torch.species.uv.morpho import Morpho
from animal_vision_tpu_torch.species.uv.pieris import Pieris
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


def _morpho(device: torch.device) -> Morpho:
    """Morpho with ``orientation_gate`` from ``ANIMAL_VISION_MORPHO_GATE``
    (a float, e.g. 1e-2), so that flat frames render deterministically;
    unset keeps the reference's behaviour."""
    animal = Morpho(device)
    gate = os.environ.get("ANIMAL_VISION_MORPHO_GATE")
    if gate:
        animal.orientation_gate = float(gate)
    return animal


register("honeybee", "HoneyBee", HoneyBee)
register("reindeer", "ReinDeer", Reindeer)
register("goldfish", "GoldFish", Goldfish)
register("damselfish", "DamselFish", Damselfish)
register("anableps", "Anableps (Four-eyed fish)", Anableps)
register("anchovy", "Northern Anchovy Fish", Anchovy)
register("guppy", "Guppy Fish", Guppy)
register("morpho", "Morpho Butterfly", _morpho)
register("heliconius", "Heliconius Butterfly", Heliconius)
register("pieris", "Pieris Butterfly", Pieris)
register("mantis_shrimp", "Mantis Shrimp", MantisShrimp)
register("kestrel", "Kestrel", Kestrel)
register("jumping_spider", "Jumping Spider", JumpingSpider)
register("dragonfly", "DragonFly", Dragonfly)
register("hummingbird", "HummingBird", Hummingbird)

# The JAX package's gallery groupings, in its order, listing only the UV
# species ported so far (all but rat_uv).
UV_NAMES = ["honeybee", "reindeer", "goldfish", "damselfish", "anableps", "anchovy", "guppy", "morpho",
            "heliconius", "pieris"]
UNIQUE_UV_NAMES = ["mantis_shrimp", "kestrel", "jumping_spider", "dragonfly", "hummingbird"]
PORTED_UV_NAMES = UV_NAMES + UNIQUE_UV_NAMES
