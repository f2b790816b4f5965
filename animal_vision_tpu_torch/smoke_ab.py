"""A/B of two trees of the repository on one card, through ``chip_smoke.py``.

    python3 -m animal_vision_tpu_torch.smoke_ab prepare PARENT   # where git is
    python3 -m animal_vision_tpu_torch.smoke_ab run [ORDER ...]  # on the card

``prepare`` unpacks ``git archive PARENT`` into ``build/ab/parent`` and the
working tree as git would commit it (``git add -A`` into a temporary
index, ``git write-tree``) into ``build/ab/change``, and puts the change's
``chip_smoke.py`` in both, so that one harness measures both packages.
``build/`` is ignored, so the copy a card machine receives carries both.
``run`` then runs each tree's ``chip_smoke.py`` in ``ORDER`` (default
parent, change, change, parent, parent, change), one process after another
on the same card, keeps each run's log and report under
``chiprun_out/ab/``, and writes ``chiprun_out/ab/summary.json``: per tree,
the median, minimum and maximum over that tree's runs of each non-UV
kernel case's ms, each summary kernel's ratios, each profiled call's
device and wall time and each group's harmonic mean, with the card's name
and power limit. It fails if a run fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
AB = ROOT / "build" / "ab"
OUT = ROOT / "chiprun_out" / "ab"
ORDER = ("parent", "change", "change", "parent", "parent", "change")
RUN_SECONDS = 1200


def _git(*args: str, env: dict | None = None) -> str:
    return subprocess.run(["git", *args], cwd=ROOT, check=True, capture_output=True, text=True, env=env).stdout.strip()


def _unpack(tree: str, dest: Path) -> None:
    dest.mkdir(parents=True, exist_ok=True)
    archive = subprocess.run(["git", "archive", tree], cwd=ROOT, check=True, capture_output=True).stdout
    subprocess.run(["tar", "-x", "-C", str(dest)], input=archive, check=True)


def prepare(parent: str) -> None:
    """Unpack the parent commit and the working tree under ``build/ab``."""
    subprocess.run(["rm", "-rf", str(AB)], check=True)
    _unpack(parent, AB / "parent")
    with tempfile.TemporaryDirectory() as tmp:
        env = {**os.environ, "GIT_INDEX_FILE": str(Path(tmp) / "index")}
        _git("read-tree", "HEAD", env=env)
        _git("add", "-A", env=env)
        tree = _git("write-tree", env=env)
    _unpack(tree, AB / "change")
    (AB / "parent" / "chip_smoke.py").write_bytes((AB / "change" / "chip_smoke.py").read_bytes())
    print(f"parent {_git('rev-parse', parent)} -> {AB / 'parent'}; change tree {tree} -> {AB / 'change'}")


def _spread(values: list[float]) -> dict:
    return dict(median=float(np.median(values)), min=float(min(values)), max=float(max(values)), n=len(values))


def summarize(runs: list[tuple[str, dict]]) -> dict:
    """Median, minimum and maximum per tree of each non-UV kernel case's ms,
    each profiled call's device and wall time, and the harmonic means."""
    out: dict = {}
    for label in dict.fromkeys(label for label, _ in runs):
        reports = [r for lab, r in runs if lab == label]
        kernels: dict = {}
        for r in reports:
            for row in r["kernel_cases"]:
                key = f"{row['kernel']} {row['case']} {row['h']}x{row['w']}"
                kernels.setdefault(key, {"ms": [], "bound_ms": row["bound_ms"]})["ms"].append(row["ms"])
        profile: dict = {}
        for r in reports:
            for call, row in r["profile"].items():
                entry = profile.setdefault(call, {"device_us": [], "wall_us": []})
                entry["device_us"].append(row["device_us"])
                entry["wall_us"].append(row["wall_us"])
        ratios: dict = {}
        for r in reports:
            for entry in r["kernels"]:
                for key in ("bound_share", "copy_ratio", "copy_ms"):
                    if key in entry:
                        ratios.setdefault(f"{entry['name']} {key}", []).append(entry[key])
        out[label] = dict(
            summary_ratios={k: _spread(v) for k, v in ratios.items()},
            kernels={k: dict(**_spread(v["ms"]), bound_ms=v["bound_ms"],
                             bound_share=v["bound_ms"] / float(np.median(v["ms"]))) for k, v in kernels.items()},
            profile={k: {m: _spread(v) for m, v in e.items()} for k, e in profile.items()},
            hm_fps=_spread([r["main_path"]["hm_fps"] for r in reports]),
            uv_hm_fps=_spread([r["uv_main_path"]["hm_fps"] for r in reports]),
            seconds=_spread([r["seconds"] for r in reports]),
        )
    return out


def run(order: tuple[str, ...]) -> int:
    """Each tree's ``chip_smoke.py`` in ``order``; the summary of all runs."""
    OUT.mkdir(parents=True, exist_ok=True)
    runs = []
    card = None
    for i, label in enumerate(order, 1):
        tree = AB / label
        log = OUT / f"run{i}-{label}.log"
        with log.open("w") as f:
            rc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree, stdout=f, stderr=subprocess.STDOUT,
                                timeout=RUN_SECONDS).returncode
        print(f"run {i} {label}: rc {rc}", flush=True)
        if rc != 0:
            print(log.read_text()[-4000:])
            return rc
        report = json.loads((tree / "chiprun_out" / "chip_smoke_report.json").read_text())
        (OUT / f"run{i}-{label}.json").write_text(json.dumps(report))
        card = report["device"]["card"]
        runs.append((label, report))
    summary = dict(card=card, order=list(order), trees=summarize(runs))
    (OUT / "summary.json").write_text(json.dumps(summary, indent=1))
    for label, tree in summary["trees"].items():
        print(f"== {label} ({card}): harmonic mean {tree['hm_fps']['median']:.1f} fps")
        for key, row in tree["kernels"].items():
            print(f"   {key:<44} {row['median']:.4f} ms [{row['min']:.4f}-{row['max']:.4f}] "
                  f"{row['bound_share']:.1%} of bound")
        for key, row in tree["summary_ratios"].items():
            print(f"   {key:<44} {row['median']:.4f} [{row['min']:.4f}-{row['max']:.4f}]")
        for call, row in tree["profile"].items():
            print(f"   {call:<28} device {row['device_us']['median']:.1f} us "
                  f"[{row['device_us']['min']:.1f}-{row['device_us']['max']:.1f}]")
    return 0


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "prepare":
        prepare(argv[1])
        return 0
    if argv and argv[0] == "run":
        return run(tuple(argv[1:]) or ORDER)
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
