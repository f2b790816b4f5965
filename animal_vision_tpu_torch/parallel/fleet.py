"""Species fleet: every species program on a device of its own.

Counterpart of ``animal_vision_tpu/parallel/fleet.py``, the expert-parallel
analogue of this model family (it has no MoE layers; its experts are the
36 species programs). Species are placed round-robin on the devices, and
``render_fleet`` queues every species' work before it waits for any, so
the devices render concurrently. One process: PyTorch queues CUDA work
asynchronously, as JAX dispatches it.
"""

from __future__ import annotations

import numpy as np
import torch

from animal_vision_tpu_torch.species import get_animal, resolve_device


def _devices(devices=None) -> list[torch.device]:
    """``devices`` as a list, or every CUDA card when None (raising
    without one, as the entry points do)."""
    if devices is None:
        resolve_device(None)
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def assign_devices(names, devices=None) -> dict:
    """Round-robin species -> device map."""
    devices = _devices(devices)
    return {name: devices[i % len(devices)] for i, name in enumerate(names)}


def render_fleet(frame: np.ndarray, names, devices=None) -> dict:
    """Render the (H, W, 3) ``frame`` through every named species, each on
    its assigned device: the frame is copied to each device and every
    program is queued before any result is read back.

    Returns {name: (baseline, transformed)} as host NumPy arrays, equal to
    ``get_animal(name, device).visualize(frame)``."""
    if frame.ndim != 3 or frame.shape[2] != 3:
        raise ValueError(f"render_fleet takes one (H, W, 3) frame, got {frame.shape}")
    placement = assign_devices(names, devices)
    host = torch.from_numpy(np.ascontiguousarray(frame))
    if any(d.type == "cuda" for d in placement.values()):
        host = host.pin_memory()
    local = {d: host.to(d, non_blocking=True) for d in set(placement.values())}
    pending = {}
    for name in names:
        dev = placement[name]
        animal = get_animal(name, dev)
        x = local[dev]
        base, out = animal.transform(frame.shape, frame.dtype)(x)
        pending[name] = (base is x, base, out)
    return {name: (frame.copy() if same else base.cpu().numpy(), out.cpu().numpy())
            for name, (same, base, out) in pending.items()}
