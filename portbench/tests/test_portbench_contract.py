"""``BENCHMARK.json`` against the benchmark's contract, and every cell's
files found by name."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n\r]{1,200}$")
CELLS = [c["name"] for c in BENCH["workloads"]]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["command"]) <= 32 and all(TEXT.match(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")


def test_names_units_and_texts():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["chips"] == 1
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert TEXT.match(m["layer"])


def _reports(cell: str) -> set:
    return {m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", CELLS)}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_what_the_contract_asks(cell):
    e2e = _reports(cell)
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in BENCH["per_layer"] if cell in m["workloads"]]
    assert layer
    for m in layer:
        assert m["moves"] in e2e


def test_per_layer_moves_one_end_to_end_metric_that_its_cells_report():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert m["moves"] in _reports(cell)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_resolves_its_files_by_name(cell, trace):
    c = harness.resolve(cell, trace, BENCH)
    entry = next(e for e in BENCH["configs"] if e["name"] == c.config["name"])
    assert entry["file"].startswith("portbench/") and (ROOT / entry["file"]).is_file()
    assert c.config["reduced"] == entry["reduced"] == []
    assert (harness.HERE / "reference" / f"{c.config['reference']}.py").is_file()
    assert (harness.HERE / "work" / f"{c.config['name']}.py").is_file()
    assert c.traffic["entry"] in harness.DRIVERS
    for name, _ in c.metrics:
        assert hasattr(harness.reader(name), "read")


def test_files_under_paths_are_named_from_name_characters():
    for f in (ROOT / "portbench").rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            rel = f.relative_to(ROOT).as_posix()
            assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel


def test_every_config_is_used_and_its_file_is_its_own():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_check_numbers_have_limits():
    for entry in BENCH["configs"]:
        spec = json.loads((ROOT / entry["file"]).read_text())["check"]["numbers"]
        assert spec, entry["name"]
        for name, s in spec.items():
            assert s["better"] in ("lower", "higher") and isinstance(s["limit"], (int, float)), name
