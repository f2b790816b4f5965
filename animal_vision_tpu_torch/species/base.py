"""The public Animal API.

Contract: ``Animal.visualize(image) -> (baseline, transformed)``, NumPy in
and NumPy out with the input dtype preserved (the uint8 round trip is
``*255 + 0.5``); the baseline is the input frame unless the species
transforms geometry (the cat).

Each animal runs on one device, chosen when it is made. A species builds,
per frame shape and dtype, a program: a function from (..., H, W, 3)
tensors on that device to (baseline, transformed) tensors. PyTorch runs it
eagerly; the cache only keeps the device tables (colour matrices, blur taps,
per-row streak and gain tables) that depend on the shape.
"""

from __future__ import annotations

import abc
from typing import Callable

import numpy as np
import torch

Program = Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a NumPy dtype (or torch dtype)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), dtype=np.dtype(dtype))).dtype


class Animal(abc.ABC):
    """Base class for all species simulators."""

    def __init__(self, device: str | torch.device = "cuda") -> None:
        self.device = torch.device(device)
        self._programs: dict = {}

    @abc.abstractmethod
    def _build_program(self, shape: tuple[int, ...], dtype: torch.dtype, kernels: bool) -> Program:
        """Return the program for frames of ``shape`` (H, W, 3) and ``dtype``.
        ``kernels`` selects the fused kernels where the species has them;
        ``kernels=False`` composes the same chain from the core ops."""

    def _program(self, shape, dtype, kernels: bool = True) -> Program:
        key = (tuple(int(s) for s in shape[-3:]), torch_dtype(dtype), kernels)
        prog = self._programs.get(key)
        if prog is None:
            prog = self._build_program(key[0], key[1], kernels)
            self._programs[key] = prog
        return prog

    def _table(self, a: np.ndarray) -> torch.Tensor:
        """A float32 host table as a tensor on this animal's device."""
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(self.device)

    def _to_device(self, images) -> torch.Tensor:
        if isinstance(images, torch.Tensor):
            return images.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(images)).to(self.device)

    def visualize(self, image: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Simulate this species' vision of one (H, W, 3) frame. NumPy in,
        NumPy out."""
        if not isinstance(image, np.ndarray):
            raise TypeError("Input must be a numpy ndarray.")
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError("Input must be HxWx3 RGB.")
        return self._to_host(image, self._to_device(image))

    def visualize_batch(self, images: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Batched variant over (N, H, W, 3) frames; equals per-frame
        ``visualize``."""
        if images.ndim != 4 or images.shape[3] != 3:
            raise ValueError("Input must be NxHxWx3.")
        return self._to_host(images, self._to_device(images))

    def _to_host(self, images: np.ndarray, frames: torch.Tensor):
        """Run the program and bring both outputs to the host. A baseline
        that is the input frame comes back as a copy of the input, never as
        a view of it and never through the device."""
        baseline, out = self._program(frames.shape[-3:], frames.dtype)(frames)
        base = np.array(images, copy=True) if baseline is frames else baseline.cpu().numpy()
        return base, out.cpu().numpy()

    def visualize_batch_device(self, images) -> tuple[torch.Tensor, torch.Tensor]:
        """Like ``visualize_batch``, for (N, H, W, 3) frames given as a NumPy
        array or a tensor, returning tensors on this animal's device without
        synchronizing with it."""
        if images.ndim != 4 or images.shape[3] != 3:
            raise ValueError("Input must be NxHxWx3.")
        frames = self._to_device(images)
        return self._program(frames.shape[1:], frames.dtype)(frames)

    def transform(self, shape: tuple[int, ...], dtype=np.uint8) -> Program:
        """The program for frames of ``shape`` (H, W, 3): a function of
        (..., H, W, 3) tensors on this animal's device."""
        return self._program(tuple(shape), dtype)

    def plain_transform(self, shape: tuple[int, ...], dtype=np.uint8) -> Program:
        """The same chain composed of core PyTorch ops, without the fused
        kernels (the path float frames take): the reference for the kernels'
        output on any device."""
        return self._program(tuple(shape), dtype, kernels=False)
