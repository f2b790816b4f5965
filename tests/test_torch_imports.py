"""Import rules of the PyTorch port: no JAX, no JAX package, no OpenCV (the
I/O modules import cv2 inside the functions that use it), no h5py (the
``.mat`` I/O imports it likewise), no optax or orbax (the port trains with
``torch.optim`` and checkpoints with ``torch.save``), and no work at import
time: no kernel library and no frame ring is built or loaded."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (JAX on the CPU backend, as tests/conftest.py sets it)
import torch  # noqa: F401

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
import animal_vision_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
    or m == "animal_vision_tpu" or m.startswith("animal_vision_tpu.") or m == "cv2"
    or m.split(".")[0] in ("h5py", "optax", "orbax")
)
from animal_vision_tpu_torch.native import ring
from animal_vision_tpu_torch.ops import _build
print(json.dumps({"modules": names, "bad": bad, "libs": sorted(_build._libs), "ring": ring._lib is not None}))
"""


def test_port_imports_no_jax_package_or_cv2():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, timeout=300,
        check=True,
    )
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["bad"] == []
    assert report["libs"] == []  # importing builds and loads no kernel library
    assert report["ring"] is False  # nor the frame ring
    expected = {
        "animal_vision_tpu_torch.core.blur", "animal_vision_tpu_torch.core.color",
        "animal_vision_tpu_torch.core.effects", "animal_vision_tpu_torch.core.geometry",
        "animal_vision_tpu_torch.core.linalg", "animal_vision_tpu_torch.ops._build",
        "animal_vision_tpu_torch.ops.fused_nonuv", "animal_vision_tpu_torch.species.base",
        "animal_vision_tpu_torch.species.nonuv",
        "animal_vision_tpu_torch.core.stats", "animal_vision_tpu_torch.core.gradients",
        "animal_vision_tpu_torch.core.tables", "animal_vision_tpu_torch.ops.fused_blur",
        "animal_vision_tpu_torch.spectral.bands", "animal_vision_tpu_torch.spectral.classic",
        "animal_vision_tpu_torch.spectral.mappers", "animal_vision_tpu_torch.species.uv.common",
        "animal_vision_tpu_torch.species.uv.honeybee", "animal_vision_tpu_torch.species.uv.goldfish",
        "animal_vision_tpu_torch.species.uv.reindeer", "animal_vision_tpu_torch.species.uv.kestrel",
        "animal_vision_tpu_torch.ops.fused_msab", "animal_vision_tpu_torch.models.mst_plus_plus",
        "animal_vision_tpu_torch.models.providers",
        "animal_vision_tpu_torch.ops.fused_mst", "animal_vision_tpu_torch.models.mst",
        "animal_vision_tpu_torch.models.zoo", "animal_vision_tpu_torch.spectral.colorimetry",
    } | {f"animal_vision_tpu_torch.species.uv.{n}" for n in (
        "mantis_shrimp", "jumping_spider", "dragonfly", "hummingbird", "damselfish", "anableps", "anchovy",
        "guppy", "morpho", "heliconius", "pieris", "rat_uv")} | {f"animal_vision_tpu_torch.{n}" for n in (
        "utils.timing", "utils.profiling", "native.ring", "io.renderer", "io.image", "io.video", "io.webcam",
        "io.gallery", "pipeline.executor", "service", "cli", "ops.gelu_probe", "models.common", "models.metrics",
        "models.simple_nets", "models.hinet", "models.mprnet", "models.restormer", "models.mirnet", "models.hdnet",
        "models.sgn", "models.awan", "models.tiling", "models.ensemble", "models.summary", "server",
        "server.app", "server.miniasgi", "server.miniosio", "models.data", "models.eval", "models.train",
        "models.export", "models.quality")}
    assert expected <= set(report["modules"])


def test_chip_smoke_fails_without_cuda():
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
