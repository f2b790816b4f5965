"""Stand-ins for the system under test, for the check's control and for
the fault tests; the benchmark's own runs never use them.

- ``control``: the plain reference in the program's place, its products in
  TF32 (the nearest precision below the configurations' float32);
- ``fault``: the port with its outputs broken where they are produced:
  ``half`` leaves out the second half of each batch (its outputs repeat
  the first half's), ``alter`` changes one byte of every output frame.

Each takes the place of ``harness.build_program``: ``(config, state,
device) -> {species: animal}``, where an animal has ``device``,
``visualize_batch_device`` and ``transform``.
"""

from __future__ import annotations

import torch

from portbench import harness
from portbench.reference import common as refc


class _Animal:
    def __init__(self, device, program):
        self.device = torch.device(device)
        self._program = program

    def visualize_batch_device(self, frames: torch.Tensor):
        return self._program(frames.to(self.device))

    def transform(self, shape, dtype):
        return self._program


def control(config: dict, state, device) -> dict:
    """The reference, computed with TF32 products, as the system."""
    progs = {}

    def animal(name):
        def program(frames):
            h, w = int(frames.shape[-3]), int(frames.shape[-2])
            if (name, h, w) not in progs:
                progs[(name, h, w)] = harness.reference(config, h, w, device, state)[name]
            with torch.no_grad(), refc.precision(True):
                return progs[(name, h, w)](frames)

        return _Animal(device, program)

    return {name: animal(name) for name in config["species"]}


def _broken(out: torch.Tensor, kind: str) -> torch.Tensor:
    out = out.clone()
    if kind == "half":
        n = out.shape[0]
        out[n // 2:] = out[: n - n // 2]
    elif kind == "alter":
        out[..., 0, 0, 0] ^= 16
    else:
        raise ValueError(f"unknown fault {kind!r}")
    return out


def fault(kind: str):
    """A ``build`` of the port whose outputs carry the fault ``kind``."""

    def build(config: dict, state, device) -> dict:
        animals = harness.build_program(config, state, device)

        def wrap(a):
            def program(frames):
                base, out = a.transform(tuple(frames.shape[-3:]), frames.dtype)(frames)
                return base, _broken(out, kind)

            return _Animal(device, program)

        return {name: wrap(a) for name, a in animals.items()}

    return build
