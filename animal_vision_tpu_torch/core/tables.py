"""Small float32 host constants as tensors on a device, made once per
(contents, device), so that a program on the card copies no constant from
the host while it runs."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _cached(data: bytes, shape: tuple[int, ...], device: str) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(data, dtype=np.float32).reshape(shape).copy()).to(device)


def device_table(a, device: str | torch.device) -> torch.Tensor:
    """``a`` (array-like) as a float32 tensor on ``device``; the same
    tensor for the same contents. Callers do not write to it."""
    a = np.ascontiguousarray(a, dtype=np.float32)
    return _cached(a.tobytes(), a.shape, str(device))
