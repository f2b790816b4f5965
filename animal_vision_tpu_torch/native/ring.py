"""ctypes bindings for the native SPSC frame ring (``framering.cpp``).

The port's counterpart of ``animal_vision_tpu/native/ring.py``, with its own
build: at first use ``g++ -O3 -shared -fPIC -std=c++17`` compiles
``framering.cpp`` into ``build/native/framering-<hash>.so`` at the
repository root, where the hash covers the source and the flags. The build
writes a temporary file under a file lock and ends with ``os.replace``, so
processes that build at once (test workers) never load a half-written
library. A failed build raises; there is no fallback channel.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "framering.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
# how long a side waits before it looks again at a full or empty ring
SPIN_SLEEP_S = 1e-4

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    """``BUILD_DIR/framering-<hash>.so``, the hash of the source and flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"framering-{h.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    """Compile into ``target`` unless another process already has; under an
    exclusive lock on ``target``'s lock file."""
    target.parent.mkdir(parents=True, exist_ok=True)
    with open(target.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists():
            return
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
        os.close(fd)
        try:
            out = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", tmp], capture_output=True, text=True,
                                 timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            os.unlink(tmp)
            raise RuntimeError(f"g++ could not build {SOURCE}: {e}") from e
        if out.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed to build {SOURCE} (exit {out.returncode}):\n{out.stderr}")
        os.replace(tmp, target)


def load() -> ctypes.CDLL:
    """The ring library, built on first use; raises if the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = library_path()
        if not target.exists():
            _build(target)
        lib = ctypes.CDLL(str(target))
        lib.ring_create.restype = ctypes.c_void_p
        lib.ring_create.argtypes = [ctypes.c_int64, ctypes.c_int64]
        lib.ring_destroy.restype = None
        lib.ring_destroy.argtypes = [ctypes.c_void_p]
        lib.ring_acquire_write.restype = ctypes.c_void_p
        lib.ring_acquire_write.argtypes = [ctypes.c_void_p]
        lib.ring_commit_write.restype = None
        lib.ring_commit_write.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.ring_acquire_read.restype = ctypes.c_void_p
        lib.ring_acquire_read.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        lib.ring_release_read.restype = None
        lib.ring_release_read.argtypes = [ctypes.c_void_p]
        lib.ring_read_into.restype = ctypes.c_int64
        lib.ring_read_into.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.ring_close.restype = None
        lib.ring_close.argtypes = [ctypes.c_void_p]
        lib.ring_is_closed.restype = ctypes.c_int32
        lib.ring_is_closed.argtypes = [ctypes.c_void_p]
        lib.ring_size.restype = ctypes.c_int64
        lib.ring_size.argtypes = [ctypes.c_void_p]
        lib.path = str(target)
        _lib = lib
        return lib


class FrameRing:
    """Single-producer single-consumer ring of fixed-size slots.

    Producer: ``put(arr)`` copies an array into a slot; or ``acquire(shape,
    dtype)`` returns a writable view of the next free slot (None once the
    ring is closed), filled in place and published by ``commit(shape)``.
    Both wait while the ring is full. Consumer: ``get()`` returns the next
    array as a fresh ndarray, or None once the ring is closed and drained;
    ``wait_readable()`` then ``read_into(ptr, capacity)`` copies the next
    slot straight into a caller's buffer (one memcpy, in C, without the
    interpreter lock). Shape and dtype travel beside each slot.

    ``library`` is the path of the loaded library; ``reads`` counts the
    slots consumed. ``free()`` releases the slots (also on collection)."""

    def __init__(self, slot_bytes: int, n_slots: int = 8):
        if slot_bytes <= 0 or n_slots <= 1:
            raise ValueError(f"a ring needs slot_bytes > 0 and n_slots > 1, got {slot_bytes}, {n_slots}")
        self._lib = load()
        self._h = self._lib.ring_create(slot_bytes, n_slots)
        if not self._h:
            raise MemoryError(f"ring_create({slot_bytes}, {n_slots}) failed")
        self.library = self._lib.path
        self.slot_bytes = slot_bytes
        self.reads = 0
        self._meta: collections.deque = collections.deque()
        self._pending_dtype = None

    def _handle(self):
        if not self._h:
            raise RuntimeError("the ring was freed")
        return self._h

    def acquire(self, shape, dtype) -> np.ndarray | None:
        """Writable view of shape ``shape`` into the next free slot, waiting
        while the ring is full; None if the ring was closed meanwhile."""
        dtype = np.dtype(dtype)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        if nbytes > self.slot_bytes:
            raise ValueError(f"{tuple(shape)} {dtype} is {nbytes} bytes; slots hold {self.slot_bytes}")
        h = self._handle()
        while True:
            if self._lib.ring_is_closed(h):
                return None
            ptr = self._lib.ring_acquire_write(h)
            if ptr:
                break
            time.sleep(SPIN_SLEEP_S)
        self._pending_dtype = dtype
        buf = (ctypes.c_uint8 * nbytes).from_address(ptr)
        return np.frombuffer(buf, dtype=dtype).reshape(shape)

    def commit(self, shape) -> None:
        """Publish the acquired slot, which holds an array of ``shape`` (a
        prefix of the acquired view) and the acquired dtype."""
        dtype = self._pending_dtype
        if dtype is None:
            raise RuntimeError("commit without acquire")
        nbytes = int(np.prod(shape)) * dtype.itemsize
        if nbytes > self.slot_bytes:
            raise ValueError(f"{tuple(shape)} {dtype} does not fit a slot of {self.slot_bytes} bytes")
        self._meta.append((tuple(shape), dtype))
        self._pending_dtype = None
        self._lib.ring_commit_write(self._handle(), nbytes)

    def put(self, arr: np.ndarray) -> None:
        arr = np.ascontiguousarray(arr)
        view = self.acquire(arr.shape, arr.dtype)
        if view is None:
            raise RuntimeError("put on a closed ring")
        np.copyto(view, arr)
        self.commit(arr.shape)

    def wait_readable(self) -> bool:
        """Wait for the next slot: True when one is readable, False once the
        ring is closed and drained."""
        h = self._handle()
        nbytes = ctypes.c_int64(0)
        while not self._lib.ring_acquire_read(h, ctypes.byref(nbytes)):
            if self._lib.ring_is_closed(h) and self._lib.ring_size(h) == 0:
                return False
            time.sleep(SPIN_SLEEP_S)
        return True

    def read_into(self, ptr: int, capacity: int) -> tuple[tuple[int, ...], np.dtype]:
        """Copy the next readable slot into the ``capacity`` bytes at address
        ``ptr`` and free the slot; returns its (shape, dtype). Call after
        ``wait_readable()`` returned True."""
        got = self._lib.ring_read_into(self._handle(), ptr, capacity)
        if got == -1:
            raise RuntimeError("read_into on an empty ring")
        if got == -2:
            shape, dtype = self._meta[0]
            raise ValueError(f"slot of {tuple(shape)} {dtype} does not fit {capacity} bytes")
        self.reads += 1
        return self._meta.popleft()

    def get(self) -> np.ndarray | None:
        if not self.wait_readable():
            return None
        shape, dtype = self._meta[0]
        out = np.empty(shape, dtype)
        self.read_into(out.ctypes.data, out.nbytes)
        return out

    def close(self) -> None:
        self._lib.ring_close(self._handle())

    def __len__(self) -> int:
        return int(self._lib.ring_size(self._handle()))

    def free(self) -> None:
        if getattr(self, "_h", None):
            self._lib.ring_destroy(self._h)
            self._h = None

    def __del__(self):
        self.free()
