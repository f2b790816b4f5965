"""The one traffic generator: frames, species order and arrival times
from a seed and a mix's parameters (``traffic/<name>.json``).

Every seed gives the same sizes, counts and arrival times; only the
frames' contents and the order of the species change with it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def stream(seed: int, *tags: int) -> np.random.Generator:
    """A NumPy generator for one purpose (``tags``) of a run's seed."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), *tags]))


def torch_seed(seed: int, *tags: int) -> int:
    return int(np.random.SeedSequence([int(seed), *tags]).generate_state(1, np.uint64)[0] >> 1)


def make_frames(seed: int, n: int, h: int, w: int, device, chunk: int = 4) -> torch.Tensor:
    """(n, h, w, 3) uint8 frames on ``device``: smooth random scenes
    (bicubic from a 1/32 grid) with +-12 of noise, made on the device in
    a few large calls."""
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, 1))
    out = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    for i in range(0, n, chunk):
        k = min(chunk, n - i)
        coarse = torch.rand((k, 3, h // 32 + 2, w // 32 + 2), generator=gen, device=device)
        scene = F.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=False) * 255.0
        noise = torch.randint(-12, 13, (k, 3, h, w), generator=gen, device=device, dtype=torch.int16)
        frame = torch.clamp(scene + noise, 0, 255).to(torch.uint8)
        out[i:i + k] = frame.permute(0, 2, 3, 1)
    return out


def round_order(seed: int, species: list[str], r: int) -> list[str]:
    """Round ``r``: every species once, in a seeded-shuffled order."""
    return [species[i] for i in stream(seed, 2, r).permutation(len(species))]


def frame_indices(seed: int, pool: int, n: int) -> np.ndarray:
    """The pool frames of a stream of ``n`` frames, in order."""
    return stream(seed, 3).integers(0, pool, n)


def sample(seed: int, tag: int, population: int, k: int) -> list[int]:
    """``k`` distinct indices of ``range(population)``, drawn from the seed."""
    return sorted(int(i) for i in stream(seed, 4, tag).choice(population, size=min(k, population), replace=False))


def due_times(t0: float, rate_hz: float, start: int, count: int) -> np.ndarray:
    """Open loop: frame k is due at t0 + k / rate, whatever came before."""
    return t0 + (start + np.arange(count)) / float(rate_hz)
