"""The kernel libraries' host interface (``ops/_build.py``) on the CPU.

Each library's entry table, which ``_build.Library`` types when it loads the
library, against the ``extern "C"`` block of its ``csrc/<name>.cu``: the
same entry points, each with its parameters' C types in order. A wrong
table would otherwise show only on the card, as a failed or mistyped call.
Then the one launch table ``_build.LAUNCHES``: ``reset_launches`` zeroes
every key, every key is one a wrapper books, and a wrapper called on a CPU
tensor takes its plain version and books nothing."""

import ast
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from animal_vision_tpu_torch.core import blur
from animal_vision_tpu_torch.ops import _build
from animal_vision_tpu_torch.ops import fused_blur as B
from animal_vision_tpu_torch.ops import fused_msab as M
from animal_vision_tpu_torch.ops import fused_mst as T
from animal_vision_tpu_torch.ops import fused_nonuv as F
from animal_vision_tpu_torch.ops import gelu_probe as GP

MODULES = {"fused_nonuv": F, "fused_blur": B, "fused_msab": M, "fused_mst": T, "gelu_probe": GP}
#: Each C parameter type of the entry points and the ctypes type it takes
C_TYPES = {
    "void*": ctypes.c_void_p, "const void*": ctypes.c_void_p, "int": ctypes.c_int, "int*": _build.INT_OUT,
    "float": ctypes.c_float, "unsigned long long": ctypes.c_ulonglong,
}


def _library(name: str) -> _build.Library:
    return chip_smoke.probe_lib() if name == "nonuv_probe" else MODULES[name].LIB


def _c_entries(name: str) -> dict[str, list]:
    """{entry point: its parameters' ctypes types} of the ``extern "C"``
    block of ``csrc/<name>.cu``."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    block = src[src.index('extern "C" {'):src.index('}  // extern "C"')]
    block = re.sub(r"//[^\n]*", "", block)
    out = {}
    for fn, params in re.findall(r"^int\s+(av_\w+)\s*\(([^)]*)\)\s*\{", block, re.M):
        types = [re.sub(r"\s*\w+$", "", p.strip()).replace(" *", "*") for p in params.split(",")]
        out[fn] = [C_TYPES[t] for t in types]
    return out


@pytest.mark.parametrize("name", [*MODULES, "nonuv_probe"])
def test_entry_table_matches_the_source(name):
    lib = _library(name)
    want = _c_entries(name)
    assert lib.name == name and want
    assert lib.entries == want


def test_reset_launches_zeroes_every_key():
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 3
    _build.reset_launches()
    assert set(_build.LAUNCHES.values()) == {0}


def _booked_keys() -> set[str]:
    """The keys the wrappers name in their ``LIB.launch`` calls; the GELU
    probe books under its case names."""
    keys = set(GP.REPS)
    for mod in MODULES.values():
        for node in ast.walk(ast.parse(Path(mod.__file__).read_text())):
            if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "launch":
                key = node.args[1]
                for k in (key.body, key.orelse) if isinstance(key, ast.IfExp) else (key,):
                    if isinstance(k, ast.Constant) and k.value is not None:
                        keys.add(k.value)
    return keys


def test_every_launch_key_is_booked_by_a_wrapper():
    assert _booked_keys() == set(_build.LAUNCHES)


def _rand(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).random(shape, dtype=np.float32))


def _u8(n=1, h=4, w=5):
    return torch.from_numpy(np.random.default_rng(1).integers(0, 256, (n, h, w, 3), dtype=np.uint8))


def _msab(c=31):
    return M.MsabWeights(1, *(_rand(*s, seed=i) for i, s in enumerate(
        [(c, c), (c, c), (c, c), (1,), (c, c), (c,), (3, 3, c), (3, 3, c), (c,), (c,), (c, 4 * c), (3, 3, 4 * c),
         (4 * c, c)])))


WRAPPERS = {
    "iso_u8": lambda: F.iso_u8(_u8(), torch.ones(1), torch.from_numpy(F.iso_params(np.eye(3), 0.7))),
    "streak_u8": lambda: F.streak_u8(_u8(), torch.ones(1), torch.full((4, 2), 0.25), torch.eye(3).reshape(1, 9)
                                     .repeat(4, 1)),
    "pointwise_u8": lambda: F.pointwise_u8(_u8(), torch.ones(1), torch.eye(3).reshape(9), torch.ones(4)),
    "blur_uv": lambda: B.blur_uv(_rand(1, 4, 5, 2), blur.uv_taps(0.8, "cpu")),
    "conv": lambda: M.conv(_rand(1, 4, 5, 31), _rand(3, 3, 31, 31, seed=1)),
    "attn_stats": lambda: M.attn_stats(_rand(1, 4, 5, 31), _rand(31, 31, seed=1), _rand(31, 31, seed=2), 1),
    "msab_pos": lambda: M.msab_pos(_rand(1, 4, 5, 31), _rand(1, 31, 31, seed=1), _msab()),
    "msab_pos masked": lambda: M.msab_pos(_rand(1, 4, 5, 31), _rand(1, 31, 31, seed=1), _msab(),
                                          _rand(1, 4, 5, 31, seed=2)),
    "msab_apply": lambda: M.msab_apply(_rand(1, 4, 5, 31), _rand(1, 31, 31, seed=1), _msab()),
    "up_fuse": lambda: M.up_fuse(_rand(1, 2, 3, 62), _rand(1, 4, 6, 31, seed=1),
                                 M.up_fuse_raw(_rand(62, 2, 2, 31), _rand(2, 2, 31), _rand(62, 31))),
    "ffn": lambda: T.ffn(_rand(1, 4, 5, 31), *(_rand(*s, seed=i) for i, s in
                                               enumerate([(31,), (31,), (31, 124), (3, 3, 124), (124, 31)]))),
    "gelu_probe": lambda: GP.run("single_madd", _rand(512, 16), 2),
}


@pytest.mark.parametrize("wrapper", list(WRAPPERS))
def test_cpu_wrapper_books_no_launch(wrapper):
    _build.reset_launches()
    out = WRAPPERS[wrapper]()
    assert all(torch.isfinite(t).all() for t in (out if isinstance(out, tuple) else (out,)))
    assert set(_build.LAUNCHES.values()) == {0}
