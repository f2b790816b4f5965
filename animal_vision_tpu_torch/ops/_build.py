"""Build and load the CUDA sources in ``csrc/`` as plain C shared libraries.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``build/torch_kernels/<name>-<hash>.so`` at the repository root, where the
hash covers every file in ``csrc/`` and the flags, so an edited source
rebuilds and an unchanged one loads from the cache. The library exposes
``extern "C"`` entry points that take raw pointers and the CUDA stream and
return ``cudaGetLastError()``; it is loaded with ``ctypes``. Nothing here
runs at import: the first kernel launch builds what it needs. A failed
build raises. Under ``torch.profiler`` a launch is an ``ops.launch`` span
(device context, stream lookup, the call and its error check), and a load
or build an ``ops.build`` span, booked into ``profiling.SETUP`` either way.

This module is the kernel modules' one host interface to their libraries.
Each module hands ``Library`` its entry points and their argument types
once, as a module-level constant, and ``Library.load`` types them when it
loads the library. ``Library.launch`` calls an entry point on the device's
stream and books the launch in ``LAUNCHES`` under the key its wrapper
names; ``Library.query`` asks an entry point for ints about a device. The
device facts that more than one kernel module uses live here.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from animal_vision_tpu_torch.utils.profiling import SETUP, span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# Accurate powf and IEEE division: no --use_fast_math.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: An entry point's argument that it writes one int through: a device
#: query's out-parameter (``Library.query``).
INT_OUT = ctypes.POINTER(ctypes.c_int)
#: SMs of an H100 and the warps a row-streaming kernel's grid should give
#: each (``fused_blur.run_rows``, ``fused_nonuv.iso_run_rows``).
SMS = 132
WARPS_PER_SM = 16

#: Kernel launches per key, booked by ``Library.launch`` (a plain version
#: books nothing): the non-UV kernels (``iso_u8`` counts ``av_iso_f32``
#: too), the UV blur, the MST++ kernels (``msab_masked_kernel`` counts the
#: masked form of ``msab_pos``), the FFN kernel and the GELU probe's cases.
LAUNCHES = dict.fromkeys(
    ("iso_u8", "streak_u8", "pointwise_u8", "blur_uv", "conv_kernel", "attn_stats_kernel", "msab_apply_kernel",
     "up_fuse_kernel", "msab_masked_kernel", "ffn", "gelu_deg11", "gelu_deg7", "madd3x3", "single_madd", "gelu_erf"),
    0)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from PyTorch's CUDA_HOME; raises if neither."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: cannot build the CUDA kernels")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Compile every source not yet in the cache, one ``nvcc`` each, all
    started together. Returns ``{name: nvcc's ptxas report}`` for the
    sources built by this call (read from the cached log for the others)."""
    names = names or sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    reports = {}
    for name in names:
        target = library_path(name)
        log = target.with_suffix(".log")
        if target.exists():
            reports[name] = log.read_text() if log.exists() else ""
            continue
        nvcc = nvcc or nvcc_path()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, target, log)
    failed = []
    for name, (proc, tmp, target, log) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            continue
        log.write_text(out)
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.av_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def device_index(device: torch.device) -> int:
    """The index of the CUDA ``device``; the current device where it has none."""
    return device.index if device.index is not None else torch.cuda.current_device()


class Library(NamedTuple):
    """The library of ``csrc/<name>.cu`` and its ``entries``: each entry
    point's name and argument types (every one returns an int)."""

    name: str
    entries: dict[str, list]

    def load(self) -> ctypes.CDLL:
        """The loaded library, built on first use, its entry points typed."""
        with _lock:
            lib = _libs.get(self.name)
            if lib is None:
                with span("ops.build", into=SETUP, library=self.name):
                    target = library_path(self.name)
                    if not target.exists():
                        build_all([self.name])
                    lib = ctypes.CDLL(str(target))
                    lib.av_error_string.argtypes = [ctypes.c_int]
                    lib.av_error_string.restype = ctypes.c_char_p
                    for fn, argtypes in self.entries.items():
                        getattr(lib, fn).argtypes = argtypes
                        getattr(lib, fn).restype = ctypes.c_int
                _libs[self.name] = lib
            return lib

    def launch(self, fn: str, key: str | None, device, *args) -> None:
        """Call entry point ``fn`` with ``args`` and the current stream of
        the CUDA ``device``; raise if it returns a CUDA error. The launch is
        booked in ``LAUNCHES[key]`` (nowhere where ``key`` is None)."""
        lib = self.load()
        with span("ops.launch", entry=fn):
            with torch.cuda.device(device):
                stream = torch.cuda.current_stream(device).cuda_stream
                err = getattr(lib, fn)(*args, stream)
            check(lib, err, fn)
        if key is not None:
            LAUNCHES[key] += 1

    def query(self, fn: str, index: int, *args) -> tuple[int, ...]:
        """The ints that entry point ``fn`` writes through its ``INT_OUT``
        parameters, which follow ``args``, on the CUDA device ``index``."""
        lib = self.load()
        entry = getattr(lib, fn)
        outs = [ctypes.c_int(0) for t in entry.argtypes if t is INT_OUT]
        with torch.cuda.device(index):
            check(lib, entry(*args, *map(ctypes.byref, outs)), fn)
        return tuple(v.value for v in outs)


@functools.lru_cache(maxsize=None)
def block_smem_limit(device_index: int) -> int:
    """The most dynamic shared memory, in bytes, one block may use on the
    CUDA device ``device_index`` (the UV blur's and the iso kernel's limit)."""
    from animal_vision_tpu_torch.ops.fused_blur import LIB  # it imports this module

    return LIB.query("av_blur_uv_smem_limit", device_index)[0]


@functools.lru_cache(maxsize=None)
def two_block_smem_limit(device_index: int) -> int:
    """The shared memory, in bytes, that two blocks may share on one SM of
    the CUDA device ``device_index``: the SM's total less the per-block
    reservation of each. The MST kernels size their tiles to it."""
    from animal_vision_tpu_torch.ops.fused_mst import LIB  # it imports this module

    sm_bytes, reserved = LIB.query("av_mst_smem_limit", device_index)
    return sm_bytes - 2 * reserved
