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
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

from animal_vision_tpu_torch.utils.profiling import SETUP, span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# Accurate powf and IEEE division: no --use_fast_math.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


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


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            with span("ops.build", into=SETUP, library=name):
                target = library_path(name)
                if not target.exists():
                    build_all([name])
                lib = ctypes.CDLL(str(target))
                lib.av_error_string.argtypes = [ctypes.c_int]
                lib.av_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.av_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def launch(lib: ctypes.CDLL, fn: str, device, *args) -> None:
    """Call entry point ``fn`` with ``args`` and the current stream of the
    CUDA ``device``; raise if it returns a CUDA error."""
    with span("ops.launch", entry=fn):
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = getattr(lib, fn)(*args, stream)
        check(lib, err, fn)
