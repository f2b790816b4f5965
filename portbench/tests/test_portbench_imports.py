"""What a run loads, and where it refuses to run."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "animal_vision_tpu"}

PROBE = r"""
import json, sys
from pathlib import Path

import pytest
from portbench import compare, control, harness, peaks, run, standins, trace, traffic
for sub in ("metrics", "work", "reference"):
    for f in sorted((harness.HERE / sub).glob("*.py")):
        harness.load_module(f)
harness.run_cell("nonuv20.device_1080p_b4", 5, 0.2, False, "cpu", shape=(16, 24))
harness.run_cell("honeybee_mstpp.device_1080p_b4", 5, 0.2, False, "cpu", shape=(16, 24))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _env(**kw):
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env.update(kw)
    return env


def test_no_module_of_jax_or_the_jax_package_is_loaded():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env=_env())
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "animal_vision_tpu_torch" in top and "portbench" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def _run(cwd):
    return subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "nonuv20.device_1080p_b4",
                           "--seed", "4294967311", "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env=_env(CUDA_VISIBLE_DEVICES=""))


def _no_result(out) -> bool:
    return not any(line.startswith("{") for line in out.stdout.splitlines())


def test_the_measurement_path_refuses_without_a_card():
    out = _run(ROOT)
    assert out.returncode != 0 and _no_result(out)
    assert "CUDA card" in out.stderr


def test_the_benchmark_alone_does_not_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and _no_result(out)


def _fake_card(monkeypatch, tmp_path, load_jax: bool):
    import torch

    from portbench import harness

    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR", "CUDA_CACHE_PATH"):
        monkeypatch.setenv(var, str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "card_line", lambda: "a card")

    def run_cell(*args, **kw):
        # a reader or the reference that loads JAX after the window
        if load_jax:
            import types

            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return {"correct": True}, ["check n 0 limit 0 ok"]

    monkeypatch.setattr(harness, "run_cell", run_cell)


@pytest.mark.parametrize("load_jax", [False, True])
def test_a_jax_module_loaded_after_the_window_stops_the_result(monkeypatch, tmp_path, capsys, load_jax):
    from portbench import run

    _fake_card(monkeypatch, tmp_path, load_jax)
    rc = run.main(["--workload", "nonuv20.device_1080p_b4", "--seed", "1", "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    if load_jax:
        assert rc == 3 and _no_result(subprocess.CompletedProcess([], rc, out, err)) and "['jax']" in err
    else:
        assert rc == 0 and out.splitlines()[-1] == '{"correct": true}'
