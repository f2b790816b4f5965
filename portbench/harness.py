"""One run of one cell: set-up, the measured window, the check, the result.

``run_cell`` finds the cell in ``BENCHMARK.json``, its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<traffic>.json``),
its reference (``reference/<config>.py``), its work counts
(``work/<config>.py``) and a reader for each of its metrics (``reader``),
all by name. The system under test is the configuration's species of
``animal_vision_tpu_torch`` (the mix's own ``species`` where it names
them), built by the port's own factories and driven through the mix's
entry: ``visualize_batch_device`` (frames on the card, closed loop) or
``StreamingExecutor.run`` (host frames, open loop).

After the window it reads the peak memory and the trace, frees the
program's state and compares what the window emitted (a sample drawn from
the seed) with the plain reference, float32 with TF32 off. ``run.py``
looks for modules of JAX last, before it prints the result.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from portbench import compare
from portbench import trace as tracing
from portbench import traffic as gen
from portbench.reference import common as refc

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
OUT = ROOT / "build" / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "animal_vision_tpu")
#: the provider fields that the port's factories take (``build_program``)
PROVIDER_KEYS = {"method", "weights", "sha256", "input_encoding", "params"}


@dataclass
class Reading:
    """What a run measured; the metric readers take it."""

    frames: int = 0
    attempted: int = 0
    failed: int = 0
    window_s: float = 0.0
    setup_s: float = 0.0
    spans: dict = field(default_factory=dict)
    call_ms: list | None = None
    work: dict = field(default_factory=dict)
    trace: dict | None = None
    latencies_ms: list | None = None
    period_ms: float | None = None  # an open loop's time between due frames
    lateness_ms: list | None = None
    marks: list | None = None  # (seconds into the window, frames done) at each round's end
    kept: list = field(default_factory=list)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    metrics: list  # (name, unit) of the run's metrics


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"portbench_{path.parent.name}_{path.stem}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def reader(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, or else that of
    the name without its last dotted part, so that a split such as
    ``fps.mstpp`` is read by ``metrics/fps.py``."""
    parts = name.split(".")
    while parts:
        path = HERE / "metrics" / f"{'.'.join(parts)}.py"
        if path.is_file():
            return load_module(path)
        parts.pop()
    raise FileNotFoundError(f"no reader for the metric {name!r} under {HERE / 'metrics'}")


def resolve(workload: str, trace: bool, bench: dict | None = None) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` with its files and the
    metrics a run reports: the end-to-end ones with ``trace`` 0, the
    per-layer ones with 1."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(ROOT / entry["file"])
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    if mix.get("species"):
        missing = set(mix["species"]) - set(config["species"])
        if missing:
            raise ValueError(f"the mix {cell['traffic']!r} names species that {config['name']!r} lacks: {missing}")
        config = dict(config, species=list(mix["species"]))

    def applies(m, reported):
        if "workloads" in m:
            return workload in m["workloads"]
        return m.get("moves") is None or m["moves"] in reported

    e2e = [m for m in bench["end_to_end"] if applies(m, ())]
    names = {m["name"] for m in e2e}
    chosen = [m for m in bench["per_layer"] if applies(m, names)] if trace else e2e
    return Cell(workload, int(cell["chips"]), config, mix, [(m["name"], m["unit"]) for m in chosen])


# ------------------------------------------------------------ the system


def load_state(provider: dict) -> dict:
    """The provider's weights, checked against the configuration's hash:
    the same state dict goes to the program and to the reference."""
    path = ROOT / provider["weights"]
    data = path.read_bytes()
    if hashlib.sha256(data).hexdigest() != provider["sha256"]:
        raise RuntimeError(f"{provider['weights']} is not the file the configuration names (sha256 differs)")
    return torch.load(path, map_location="cpu", weights_only=True)


def build_program(config: dict, state: dict | None, device) -> dict:
    """``{species: animal}`` of the port on ``device``. A ``provider`` is
    built by the port's factories from the configuration's fields alone:
    the zoo's ``method`` with the named weights (``zoo.model_generator``;
    ``load_state`` has checked the file's hash), its parameters counted
    against ``params``, served through ``make_mst_hsi_provider`` with the
    named ``input_encoding``. A field that they do not take is an error."""
    from animal_vision_tpu_torch.species import get_animal

    provider = None
    p = config.get("provider")
    if p:
        from animal_vision_tpu_torch.models.providers import MST_LAMBDAS, make_mst_hsi_provider
        from animal_vision_tpu_torch.models.zoo import model_generator

        unknown = set(p) - PROVIDER_KEYS
        if unknown:
            raise ValueError(f"provider fields that the port's factories do not take: {sorted(unknown)}")
        module = model_generator(p["method"], ROOT / p["weights"], device)
        n = sum(t.numel() for t in module.parameters())
        if n != p["params"]:
            raise ValueError(f"{p['method']} has {n} parameters, the configuration states {p['params']}")
        provider = make_mst_hsi_provider(module, input_encoding=p["input_encoding"], device=device)
    animals = {}
    for name in config["species"]:
        a = get_animal(name, device)
        if provider is not None:
            if hasattr(a, "use_hsi_provider"):  # the UV species of the shared skeleton
                a.use_hsi_provider(provider, lambdas=MST_LAMBDAS)
            else:  # honeybee takes its provider as an attribute, on the same 31 bands
                a.hsi_provider = provider
        animals[name] = a
    return animals


def reference(config: dict, h: int, w: int, device, state: dict | None) -> dict:
    """``{species: program}`` of the configuration's plain reference."""
    return load_module(HERE / "reference" / f"{config['reference']}.py").make(config, h, w, device, state)


# ------------------------------------------------------------ drivers


def _range(on: bool, name: str):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class DeviceDriver:
    """Closed loop on frames already on the card: one
    ``visualize_batch_device`` call per species in seeded-shuffled full
    rounds, each ended by a synchronize; the window ends with its round."""

    def __init__(self, cell: Cell, animals: dict, seed: int, device, shape=None):
        t = cell.traffic
        self.n = t["batch"]
        self.h, self.w = shape or (t["height"], t["width"])
        self.nb = t["pool_batches"]
        self.species = cell.config["species"]
        self.animals, self.seed, self.device = animals, seed, device
        self.pool = gen.make_frames(seed, self.nb * self.n, self.h, self.w, device).reshape(
            self.nb, self.n, self.h, self.w, 3)
        k = cell.config["check"]["calls_per_species"]
        self.keep = {(r, sp) for i, sp in enumerate(self.species)
                     for r in gen.sample(seed, 100 + i, t["check_rounds"], k)}

    def warm(self) -> None:
        for sp in self.species:
            self.animals[sp].visualize_batch_device(self.pool[0])
        _sync(self.device)

    def window(self, seconds: float, r: Reading, traced: bool) -> None:
        calls, marks = [], []
        events = [] if traced and torch.device(self.device).type == "cuda" else None
        j, rnd = 0, 0
        t0 = time.perf_counter()
        while True:
            for sp in gen.round_order(self.seed, self.species, rnd):
                b = j % self.nb
                j += 1
                if events is not None:
                    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    e0.record()
                with _range(traced, f"portbench.call {sp}"):
                    base, out = self.animals[sp].visualize_batch_device(self.pool[b])
                if events is not None:
                    e1.record()
                    events.append((e0, e1))
                if (rnd, sp) in self.keep:
                    r.kept.append((sp, ("pool", b), base.clone(), out.clone()))
                with _range(traced, "portbench.sync"):
                    _sync(self.device)
                calls.append(sp)
            rnd += 1
            marks.append((time.perf_counter() - t0, len(calls) * self.n))
            if marks[-1][0] >= seconds:
                break
        r.window_s = time.perf_counter() - t0
        r.frames = r.attempted = len(calls) * self.n
        r.marks = marks
        if events is not None:
            r.call_ms = [a.elapsed_time(b) for a, b in events]
        self.calls = [(sp, self.n) for sp in calls]

    def inputs(self, key) -> torch.Tensor:
        return self.pool[key[1]]


class StreamDriver:
    """Host frames through one ``StreamingExecutor.run`` of the mix's one
    species for the whole window, as ``cli webcam`` runs a capture: frame k
    is due at t0 + k / rate, whatever came before (open loop)."""

    def __init__(self, cell: Cell, animals: dict, seed: int, device, shape=None):
        from animal_vision_tpu_torch.pipeline import StreamingExecutor

        t = cell.traffic
        if len(cell.config["species"]) != 1:
            raise ValueError(f"a stream runs one species, the mix gives {cell.config['species']}")
        self.t = t
        self.h, self.w = shape or (t["height"], t["width"])
        self.species = cell.config["species"][0]
        self.seed, self.device = seed, device
        self.pool = gen.make_frames(seed, t["pool_frames"], self.h, self.w, device).cpu().numpy()
        self.ex = StreamingExecutor(animals[self.species], batch=t["batch"], split=t["split"])

    def warm(self) -> None:
        self.ex.run([self.pool[i % len(self.pool)] for i in range(self.t["batch"])], lambda f: None)
        _sync(self.device)

    def window(self, seconds: float, r: Reading, traced: bool) -> None:
        t, sp = self.t, self.species
        n = math.ceil(seconds * t["rate_hz"])
        idx = gen.frame_indices(self.seed, len(self.pool), n)
        keep = set(gen.sample(self.seed, 200, n, t["check_frames"]))
        got: list[float] = []
        lateness: list[float] = []
        t0 = time.perf_counter() + 0.01
        due = gen.due_times(t0, t["rate_hz"], 0, n)

        def frames():
            for i in range(n):
                wait = due[i] - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                lateness.append(1e3 * (time.perf_counter() - due[i]))
                yield self.pool[idx[i]]

        def sink(frame):
            k = len(got)
            got.append(time.perf_counter())
            if k in keep:
                r.kept.append((sp, ("frame", int(idx[k])), None, frame))

        with _range(traced, f"portbench.run {sp}"):
            try:
                self.ex.run(frames(), sink)
            except Exception as e:  # noqa: BLE001  (a failed run counts its frames as failed)
                print(f"run ({sp}) failed: {type(e).__name__}: {e}", file=sys.stderr)
        r.window_s = time.perf_counter() - t0
        r.attempted, r.frames, r.failed = n, len(got), n - len(got)
        r.latencies_ms = [1e3 * (got[i] - due[i]) if i < len(got) else math.inf for i in range(n)]
        r.period_ms = 1e3 / t["rate_hz"]
        r.lateness_ms = lateness
        r.spans = dict(self.ex.timer.totals)
        self.calls = [(sp, n)]

    def inputs(self, key) -> torch.Tensor:
        return torch.from_numpy(self.pool[key[1]][None])


DRIVERS = {"visualize_batch_device": DeviceDriver, "StreamingExecutor": StreamDriver}


# ------------------------------------------------------------ the run


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def work_totals(cell: Cell, calls: list, h: int, w: int) -> dict:
    path = HERE / "work" / f"{cell.config['name']}.py"
    if not path.exists():
        return {}
    mod = load_module(path)
    cache, totals = {}, {}
    for sp, n in calls:
        if (sp, n) not in cache:
            cache[(sp, n)] = mod.per_call(sp, n, h, w, cell.config)
        for k, v in cache[(sp, n)].items():
            totals[k] = totals.get(k, 0.0) + v
    return totals


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda", t_start: float | None = None,
             build=None, shape=None, bench: dict | None = None) -> tuple[dict, list[str]]:
    """One run; returns the result line's object and the check's lines.
    ``build(config, state, device)`` replaces the system under test (the
    control and the fault tests); ``shape`` the mix's frame size (tests)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = resolve(workload, trace, bench)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = load_state(cell.config["provider"]) if cell.config.get("provider") else None
    animals = (build or build_program)(cell.config, state, device)
    driver = DRIVERS[cell.traffic["entry"]](cell, animals, seed, device, shape)
    driver.warm()
    r = Reading()
    r.setup_s = time.perf_counter() - t_start

    prof = None
    if trace:
        OUT.mkdir(parents=True, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    try:
        with _range(trace, tracing.WINDOW):
            driver.window(seconds, r, trace)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if prof is not None:
        path = OUT / f"trace_{workload}.json"
        prof.export_chrome_trace(str(path))
        r.trace = tracing.reduce(tracing.load(path))
        path.unlink()
    r.work = work_totals(cell, driver.calls, driver.h, driver.w)
    if on_card:
        from animal_vision_tpu_torch.species.base import rungs_taken

        r.failed += rungs_taken()

    # free the program's state, then the reference on what the window kept
    del animals
    driver.animals = driver.ex = None
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check(cell, r, driver, state, device)
    check_s = time.perf_counter() - t_check

    metrics = {}
    for name, unit in cell.metrics:
        value = reader(name).read(r)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": unit}
    correct = (r.failed == 0 and bool(r.kept) and all(v["ok"] for v in numbers.values()))
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": r.attempted, "failed": r.failed, "metrics": metrics, "device": dev}
    if r.trace is not None:
        dev["busy_s"], dev["window_s"] = r.trace["busy_s"], r.trace["window_s"]
        result["breakdown"] = {"device_ops": r.trace["device_ops"], "idle_gaps": r.trace["idle_gaps"]}
    result["check"] = {k: {"value": v["value"], "limit": v["limit"]} for k, v in numbers.items()}
    lines = [f"run: setup_s {r.setup_s!r} window_s {r.window_s!r} frames {r.frames} compared "
             f"{sum(int(np.prod(k[3].shape[:-3])) if k[3].ndim > 3 else 1 for k in r.kept)} check_s {check_s!r}"]
    if r.spans and r.frames:
        lines.append("stages ms/frame: " + ", ".join(f"{k} {1e3 * v / r.frames:.4f}" for k, v in r.spans.items()))
    if r.marks:
        q = [next(m for m in r.marks if m[0] >= k * r.marks[-1][0] / 4) for k in (1, 2, 3, 4)]
        q = [(0.0, 0)] + q
        lines.append("frames/s by quarter of the window: " + " ".join(
            f"{(b[1] - a[1]) / (b[0] - a[0]):.1f}" for a, b in zip(q, q[1:]) if b[0] > a[0]))
    lines += [f"check {k} {v['value']!r} limit {v['limit']!r} {'ok' if v['ok'] else 'FAILED'}"
             for k, v in numbers.items()]
    lines.append(f"check frames_failed {r.failed} limit 0 {'ok' if r.failed == 0 else 'FAILED'}")
    if r.lateness_ms:
        lines.insert(0, f"generator lateness ms: max {float(max(r.lateness_ms))!r}, "
                        f"p95 {float(compare.nearest_rank(r.lateness_ms, 95))!r}")
    return result, lines


def check(cell: Cell, r: Reading, driver, state, device) -> dict:
    """The comparison numbers of the kept sample against the reference,
    each with its limit (``configs/<config>.json`` ``check.numbers``)."""
    progs = reference(cell.config, driver.h, driver.w, device, state)
    acc = compare.Accumulator()
    with torch.no_grad(), refc.precision(False):
        for sp, key, base, out in r.kept:
            x = driver.inputs(key).to(device)
            rb, ro = progs[sp](x)
            acc.add(sp, None if base is None else torch.as_tensor(base).to(device), rb,
                    torch.as_tensor(out).to(device).reshape(ro.shape), ro)
    return acc.judge(cell.config["check"]["numbers"])
