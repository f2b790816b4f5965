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

``visualize`` degrades instead of failing, as the JAX package's does: a
frame above ``ANIMAL_VISION_MAX_PIXELS``, or one whose exact run exhausts
the device's memory, takes the resolution ladder (``DEGRADE_LADDER``):
area-downscale on the host to the largest rung that fits, run, and
linear-upscale both outputs on the host. The batched entry points never
degrade. ``RUNGS`` counts the frames served at each rung.

Under ``torch.profiler`` each program's lookup and call is a
``species.program`` span (no sync inside), and a program built on a cache
miss a ``species.build`` span, booked into ``profiling.SETUP`` either way.
"""

from __future__ import annotations

import abc
import gc
import os
from typing import Callable

import numpy as np
import torch

from animal_vision_tpu_torch.core import geometry
from animal_vision_tpu_torch.utils.profiling import SETUP, span

Program = Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]

#: longest-side rungs of the degradation ladder, largest first
DEGRADE_LADDER = (1024, 768, 512, 384, 256)
#: frames that ``visualize`` served at each rung (the exact path is not counted)
RUNGS = {side: 0 for side in DEGRADE_LADDER}

_OOM_TEXT = ("out of memory", "Out of memory", "RESOURCE_EXHAUSTED", "STATUS_ALLOC_FAILED")


def reset_rungs() -> None:
    for side in RUNGS:
        RUNGS[side] = 0


def rungs_taken() -> int:
    """Frames served by the ladder since the last ``reset_rungs``."""
    return sum(RUNGS.values())


def max_pixels() -> int | None:
    """The pixel budget ``ANIMAL_VISION_MAX_PIXELS``: frames above it take
    the ladder up front instead of risking a device OOM."""
    v = os.environ.get("ANIMAL_VISION_MAX_PIXELS")
    return int(v) if v else None


def is_oom(e: BaseException) -> bool:
    """Whether ``e`` says the device ran out of memory: PyTorch's allocator
    error, or a runtime error from cuBLAS, cuDNN or a kernel launch
    (``ops/_build.Library.launch``) that says so."""
    if isinstance(e, torch.OutOfMemoryError):
        return True
    return isinstance(e, RuntimeError) and any(t in str(e) for t in _OOM_TEXT)


def host_resize(img: np.ndarray, h: int, w: int, interp: str) -> np.ndarray:
    """Resize an (H, W, 3) host frame to (h, w): ``area`` down, ``linear``
    up, dtype kept. With cv2 it is ``cv2.resize`` (INTER_AREA /
    INTER_LINEAR); without, ``core/geometry.resize`` (cv2's coefficients in
    float32) on CPU tensors, then +0.5 and a clip for uint8. Runs on the
    host so that recovery never allocates on an exhausted device."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        flag = cv2.INTER_AREA if interp == "area" else cv2.INTER_LINEAR
        out = cv2.resize(img, (w, h), interpolation=flag)
        return out if out.ndim == 3 else out[..., None]
    x = torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32))
    out = geometry.resize(x, (h, w), interp).numpy()
    if img.dtype == np.uint8:
        out = np.clip(out + 0.5, 0, 255).astype(np.uint8)
    return out.astype(img.dtype, copy=False)


def rung_shape(h: int, w: int, side: int) -> tuple[int, int]:
    """(h, w) scaled so that the longer side is ``side``."""
    scale = side / max(h, w)
    return max(1, int(round(h * scale))), max(1, int(round(w * scale)))


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a NumPy dtype (or torch dtype)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), dtype=np.dtype(dtype))).dtype


class Animal(abc.ABC):
    """Base class for all species simulators. ``name`` labels its spans."""

    def __init__(self, device: str | torch.device = "cuda") -> None:
        self.device = torch.device(device)
        self.name = type(self).__name__.lower()
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
            with span("species.build", into=SETUP, species=self.name, shape=key[0]):
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
        NumPy out. A frame above ``ANIMAL_VISION_MAX_PIXELS``, or one that
        runs the device out of memory, takes the degradation ladder."""
        if not isinstance(image, np.ndarray):
            raise TypeError("Input must be a numpy ndarray.")
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError("Input must be HxWx3 RGB.")
        budget = max_pixels()
        if budget and image.shape[0] * image.shape[1] > budget:
            return self._visualize_degraded(image, budget)
        out = self._try_exact(image)
        return out if out is not None else self._visualize_degraded(image, budget)

    def _visualize_exact(self, image: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        return self._to_host(image, self._to_device(image))

    def _try_exact(self, image: np.ndarray):
        """``_visualize_exact(image)``, or None after a device OOM, with the
        failed shape's programs dropped and the allocator's cache emptied.
        The release happens outside the ``except`` block: until it is left,
        the traceback keeps the failed call's tensors alive."""
        try:
            return self._visualize_exact(image)
        except Exception as e:  # noqa: BLE001  (only OOMs are retried)
            if not is_oom(e):
                raise
        self._release(image.shape)
        return None

    def _release(self, shape) -> None:
        hwc = tuple(int(s) for s in shape[-3:])
        for key in [k for k in self._programs if k[0] == hwc]:
            del self._programs[key]
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _visualize_degraded(self, image: np.ndarray, budget: int | None):
        """The ladder: the largest rung under ``budget`` whose run fits."""
        h, w = int(image.shape[0]), int(image.shape[1])
        for side in DEGRADE_LADDER:
            if side >= max(h, w):
                continue
            sh, sw = rung_shape(h, w, side)
            if budget and sh * sw > budget:
                continue
            got = self._try_exact(host_resize(image, sh, sw, "area"))
            if got is None:
                continue
            RUNGS[side] += 1
            return host_resize(got[0], h, w, "linear"), host_resize(got[1], h, w, "linear")
        raise MemoryError(f"frame {h}x{w} does not fit the device at any rung of {DEGRADE_LADDER}")

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
        with span("species.program", species=self.name, frames=frames.shape[0] if frames.dim() == 4 else 1):
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
        with span("species.program", species=self.name, frames=frames.shape[0]):
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
