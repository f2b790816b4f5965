"""The port's entry points of the model side on the CPU: the summary CLI
(``models/summary.py:main``) and the two MST++ training tools
(``animal_vision_tpu_torch/tools/train_synth.py``, ``finetune_mixed.py``),
against the JAX package's and the repository's ``tools/``.

On the CPU the MST++ forward is the plain composition, tap by tap: about
7 s per 288x320 frame and 0.25 s per train step at 2 x 16x16. So the
runs here shrink the eval protocol's scenes (``train_synth.PROTOCOL``) and
``finetune_mixed``'s chunk through the tools' module constants; the data
stream is checked at the tools' own sizes and chunks, with a recording
step in place of the train step. The 100-step ``train_synth`` run is in
``tests/test_torch_tools_train.py``, so that each file takes under a
minute. The card runs the tools whole (``chip_smoke.py:tools_phase``)."""

import argparse
import ast
import functools
import hashlib
import shutil
import sys
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animal_vision_tpu.models import train as jtrain
from animal_vision_tpu.models import zoo as j_zoo
from animal_vision_tpu_torch.models import eval as meval
from animal_vision_tpu_torch.models import quality, summary
from animal_vision_tpu_torch.models import train as T
from animal_vision_tpu_torch.models.mst_plus_plus import SHIPPED
from animal_vision_tpu_torch.tools import finetune_mixed, train_synth

REPO = Path(__file__).resolve().parents[1]
TINY = ["--patch", "16", "--batch", "2", "--scenes", "4", "--scene-hw", "32", "--device", "cpu"]
TINY_PROTOCOL = (1, (40, 48))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the steps are tiny, and the test workers share
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sha256(path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


# ---------------------------------------------------------------------------
# The data stream: the tools' first chunk against the JAX tools' loops
# ---------------------------------------------------------------------------


class _Stop(Exception):
    pass


@functools.lru_cache(maxsize=None)
def jax_scenes(kind: str, n: int, h: int, w: int, seed: int = 0, device=None) -> list:
    """The JAX ``synthetic_scenes`` or ``xgen_scenes``, made once per
    arguments (read only)."""
    return {"synth": jtrain.synthetic_scenes, "xgen": jtrain.xgen_scenes}[kind](n, h, w, seed)


def jax_split(curriculum, n_scenes, hw):
    """The JAX tools' scenes and split (``tools/train_synth.py:54-63``,
    ``tools/finetune_mixed.py:55-59``): (training scenes, held out)."""
    if curriculum == "mixed":
        half = max(2, n_scenes // 2)
        synth = jax_scenes("synth", half, hw, hw, seed=0)
        xgen = jax_scenes("xgen", half, hw, hw, seed=100)
        return synth[:-1] + xgen[:-1], [synth[-1], xgen[-1]]
    scenes = jax_scenes("synth", n_scenes, hw, hw, seed=0)
    return scenes[:-2], scenes[-2:]


def jax_first_chunk(curriculum, n_scenes, hw, seed, chunk, patch, batch):
    """The JAX tools' first chunk of draws, rebuilt from their lines
    (``tools/train_synth.py:86-95``, ``tools/finetune_mixed.py:92-101``)."""
    train_scenes, _ = jax_split(curriculum, n_scenes, hw)
    rng = np.random.default_rng(seed)
    brs, bhs = [], []
    for _ in range(chunk):
        rgb, hsi = train_scenes[int(rng.integers(0, len(train_scenes)))]
        br, bh = jtrain.sample_patches(rng, rgb, hsi, patch, batch)
        brs.append(br)
        bhs.append(bh)
    return np.stack(brs), np.stack(bhs)


@pytest.fixture
def recorded_chunk(monkeypatch):
    """The JAX scene makers in the port's place, a scorer that runs no
    model, and a train step that records its batches and stops the tool
    after ``n`` of them."""
    monkeypatch.setattr(T, "synthetic_scenes", functools.partial(jax_scenes, "synth"))
    monkeypatch.setattr(T, "xgen_scenes", functools.partial(jax_scenes, "xgen"))
    monkeypatch.setattr(meval, "validate", lambda *a, **k: {"mrae": 0.0, "rmse": 0.0, "psnr": 0.0})
    monkeypatch.setattr(train_synth, "PROTOCOL", TINY_PROTOCOL)
    seen = []

    def run(main, argv, n):
        def make_train_step(loss):
            assert loss == "l1"

            def step(state, rgb, hsi):
                seen.append((rgb.numpy().copy(), hsi.numpy().copy()))
                if len(seen) == n:
                    raise _Stop
                return state, {"loss": torch.tensor(0.0)}

            return step

        monkeypatch.setattr(T, "make_train_step", make_train_step)
        with pytest.raises(_Stop):
            main(argv)
        return np.stack([r for r, _ in seen]), np.stack([h for _, h in seen])

    return run


@pytest.mark.parametrize("curriculum", ["mixed", "synth"])
def test_train_synth_first_chunk_is_the_jax_tools(recorded_chunk, tmp_path, curriculum):
    rgb, hsi = recorded_chunk(train_synth.main, ["--curriculum", curriculum, "--device", "cpu",
                                                 "--out", str(tmp_path / "never.pt")], train_synth.CHUNK)
    want_rgb, want_hsi = jax_first_chunk(curriculum, 24, 160, 1, 100, 64, 8)
    assert train_synth.CHUNK == 100 and rgb.shape == (100, 8, 64, 64, 3) and hsi.shape == (100, 8, 64, 64, 31)
    assert np.array_equal(rgb, want_rgb) and np.array_equal(hsi, want_hsi)
    assert not (tmp_path / "never.pt").exists()


def test_finetune_mixed_first_chunk_is_the_jax_tools(recorded_chunk, tmp_path):
    src = tmp_path / "synth_v1.pt"
    shutil.copyfile(SHIPPED, src)
    rgb, hsi = recorded_chunk(finetune_mixed.main, ["--src", str(src), "--device", "cpu"], finetune_mixed.CHUNK)
    want_rgb, want_hsi = jax_first_chunk("mixed", 24, 160, 7, 50, 64, 8)
    assert finetune_mixed.CHUNK == 50 and rgb.shape == (50, 8, 64, 64, 3)
    assert np.array_equal(rgb, want_rgb) and np.array_equal(hsi, want_hsi)
    assert sha256(src) == sha256(SHIPPED) and not (tmp_path / finetune_mixed.CANDIDATE).exists()


def test_held_out_split_is_the_jax_tools():
    for curriculum, families in (("mixed", ["synth", "xgen"]), ("synth", ["synth", "synth_2"])):
        scenes, held = train_synth.split_scenes(curriculum, 5, 24, "cpu", functools.partial(jax_scenes, "synth"),
                                                functools.partial(jax_scenes, "xgen"))
        _, want = jax_split(curriculum, 5, 24)
        assert [f for f, _ in held] == families and len(scenes) == {"mixed": 2, "synth": 3}[curriculum]
        for (_, (r, h)), (jr, jh) in zip(held, want):
            assert np.array_equal(r, jr) and np.array_equal(h, jh)


# ---------------------------------------------------------------------------
# The tools run on the CPU
# ---------------------------------------------------------------------------


def _finetune(tmp_path, *extra):
    src = tmp_path / "synth_v1.pt"
    shutil.copyfile(SHIPPED, src)
    before = sha256(src)
    r = finetune_mixed.main(["--steps", "11", *TINY, "--src", str(src), *extra])
    cand = tmp_path / finetune_mixed.CANDIDATE
    assert r["src"] == str(src) and r["candidate"] == str(cand)
    return r, src, cand, before


def test_finetune_mixed_swaps_when_both_gates_pass(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(train_synth, "PROTOCOL", TINY_PROTOCOL)
    monkeypatch.setattr(finetune_mixed, "CHUNK", 5)
    shipped = sha256(SHIPPED)
    r, src, cand, before = _finetune(tmp_path, "--min-xgen", "0", "--min-synth", "0")
    assert r["protocol"] == "files" and r["swapped"] and r["steps"] == 15 and np.isfinite(r["losses"]).all()
    assert not cand.exists() and sha256(src) != before
    assert "SWAPPED" in capsys.readouterr().out
    # the swapped file is the fine-tuned model, loaded as the shipped one is
    model = quality.load_pretrained("cpu", path=src)
    _, held = train_synth.split_scenes("mixed", 4, 32, "cpu")
    start = quality.load_pretrained("cpu")
    x = torch.from_numpy(held[0][1][0])[None]
    with torch.no_grad():
        assert not torch.equal(model(x), start(x))
    assert sha256(SHIPPED) == shipped


def test_finetune_mixed_keeps_below_a_gate(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(train_synth, "PROTOCOL", TINY_PROTOCOL)
    r, src, cand, before = _finetune(tmp_path, "--min-xgen", "99", "--budget-s", "0")
    assert r["protocol"] == "files" and not r["gates_passed"] and not r["swapped"] and r["steps"] == 0
    assert sha256(src) == before and cand.exists() and sha256(cand) != before
    assert "KEPT" in capsys.readouterr().out


def test_finetune_mixed_in_memory_never_swaps(tmp_path, monkeypatch, capsys):
    """Without cv2 the protocol is scored in memory, says so, and does not
    swap even with both gates at 0."""
    monkeypatch.setattr(train_synth, "PROTOCOL", TINY_PROTOCOL)
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises ImportError
    assert quality.protocol_route() == "in_memory"
    r, src, cand, before = _finetune(tmp_path, "--min-xgen", "0", "--min-synth", "0", "--budget-s", "0")
    out = capsys.readouterr().out
    assert r["protocol"] == "in_memory" and r["gates_passed"] and not r["swapped"]
    assert sha256(src) == before and cand.exists()
    assert "scored in memory" in out and "KEPT" in out and "SWAPPED" not in out
    for family in ("synth", "xgen"):
        assert np.isfinite(list(r["final"][family].values())).all()


def test_in_memory_protocol_rounds_to_uint8():
    """The in-memory scenes are the files' RGB without the JPEG: rounded to
    uint8 and min-max normalized, the cube exact."""
    seen = []

    def apply_fn(rgb):
        seen.append(rgb)
        return np.zeros(rgb.shape[:2] + (31,), np.float32)

    quality.eval_protocol_in_memory(apply_fn, n_scenes=1, hw=(24, 32), seed=3, scene_fn=T.synthetic_scenes,
                                    device="cpu")
    (rgb, _), = T.synthetic_scenes(1, 24, 32, 3, device="cpu")
    u8 = (rgb * 255.0).round().astype(np.uint8).astype(np.float32)
    assert np.array_equal(seen[0], (u8 - u8.min()) / (u8.max() - u8.min()))


# ---------------------------------------------------------------------------
# The summary CLI
# ---------------------------------------------------------------------------


def test_summary_main_prints_the_jax_params(capsys):
    module = j_zoo._REGISTRY["edsr"][0]()
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    n = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert summary.main(["--method", "edsr", "--size", "32", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert "FlopCounterMode" in lines[0] and "cost_analysis" in lines[0]
    assert lines[1].startswith("edsr ") and f"params {n / 1e6:8.2f} M" in lines[1] and "@ 32x32" in lines[1]
    assert summary.summarize("edsr", 32, 32, device="cpu")["params"] == n


def test_summary_main_fails_loudly(capsys, monkeypatch):
    real = summary.summarize

    def flaky(method, *a, **k):
        if method == "hinet":
            raise MemoryError("too big")
        return real(method, *a, **k)

    monkeypatch.setattr(summary, "summarize", flaky)
    monkeypatch.setattr(summary.zoo, "available_models", lambda: ["edsr", "hinet"])
    assert summary.main(["--size", "16", "--device", "cpu"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("edsr ") and "params" in out[1]
    assert out[2].startswith("hinet ") and "FAILED: MemoryError: too big" in out[2]


def test_count_flops_runs_the_plain_composition():
    """A model that takes ``plain`` is counted on ``plain=True`` (on the card
    its kernel forward would hide its products); others as called."""

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(4, 3, bias=False)
            self.calls = []

        def forward(self, x, plain=False):
            self.calls.append((plain, torch.is_grad_enabled()))
            return self.lin(x) if plain else x

    net = Net()
    assert summary.count_flops(net, torch.zeros(5, 4)) == 2 * 5 * 4 * 3
    assert net.calls == [(True, False)]
    assert summary.count_flops(net.lin, torch.zeros(5, 4)) == 2 * 5 * 4 * 3


def test_entry_points_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((summary.main, ["--method", "edsr"]),
                       (train_synth.main, ["--out", str(tmp_path / "x.pt")]),
                       (finetune_mixed.main, ["--src", str(tmp_path / "x.pt")])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
    assert not any(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# Entry-point parity: every JAX option, with its default
# ---------------------------------------------------------------------------

PAIRS = [
    ("animal_vision_tpu/cli.py", "animal_vision_tpu_torch.cli"),
    ("animal_vision_tpu/models/ensemble.py", "animal_vision_tpu_torch.models.ensemble"),
    ("animal_vision_tpu/models/export.py", "animal_vision_tpu_torch.models.export"),
    ("animal_vision_tpu/models/summary.py", "animal_vision_tpu_torch.models.summary"),
    ("animal_vision_tpu/models/eval.py", "animal_vision_tpu_torch.models.eval"),
    ("tools/train_synth.py", "animal_vision_tpu_torch.tools.train_synth"),
    ("tools/finetune_mixed.py", "animal_vision_tpu_torch.tools.finetune_mixed"),
]


def jax_options(path: str) -> Counter:
    """(option strings, default, choices) of every ``add_argument`` call
    in a JAX file, read with ``ast`` (the file is not imported); an
    absent default is argparse's."""
    out = Counter()
    for node in ast.walk(ast.parse((REPO / path).read_text())):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            continue
        opts = tuple(a.value for a in node.args)
        kw = {k.arg: k.value for k in node.keywords}
        action = ast.literal_eval(kw["action"]) if "action" in kw else None
        default = ast.literal_eval(kw["default"]) if "default" in kw else {"store_true": False}.get(action)
        if isinstance(default, str) and default.startswith("animal_vision_tpu/"):
            # a path in the JAX package: the port's own file
            default = str(REPO / (default.replace("animal_vision_tpu/", "animal_vision_tpu_torch/", 1) + ".pt"))
        choices = tuple(ast.literal_eval(kw["choices"])) if "choices" in kw else None
        out[(opts, default, choices)] += 1
    return out


class _Parsed(Exception):
    pass


def port_options(module: str, monkeypatch) -> Counter:
    """The same triples from the port's parser, caught as its ``main``
    parses (subcommands included)."""
    import importlib

    caught = []

    def parse_args(self, *a, **k):
        caught.append(self)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    with pytest.raises(_Parsed):
        importlib.import_module(module).main([])
    out = Counter()

    def walk(parser):
        for act in parser._actions:
            if isinstance(act, argparse._SubParsersAction):
                for sub in act.choices.values():
                    walk(sub)
            elif act.option_strings and not isinstance(act, argparse._HelpAction):
                choices = tuple(act.choices) if act.choices is not None else None
                out[(tuple(act.option_strings), act.default, choices)] += 1

    walk(caught[0])
    return out


@pytest.mark.parametrize("jax_file,port_module", PAIRS, ids=[p for p, _ in PAIRS])
def test_entry_point_options_match_jax(jax_file, port_module, monkeypatch):
    want, got = jax_options(jax_file), port_options(port_module, monkeypatch)
    assert want, jax_file
    assert not want - got, f"options the port lacks or defaults differently: {want - got}"
    assert all(opts == ("--device",) for opts, _, _ in got - want), got - want


def test_app_main_has_no_options():
    """``server/app.py``'s ``__main__`` calls ``run()``: no options to match."""
    src = (REPO / "animal_vision_tpu/server/app.py").read_text()
    assert "add_argument" not in src and "run()" in src.split('if __name__ == "__main__":')[1]
